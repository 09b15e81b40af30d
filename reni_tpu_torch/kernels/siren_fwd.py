"""Fused decoder forward: the port of the forward half of
``reni_tpu/kernels/siren_pallas.py``.

``fused_apply`` (Cond-by-Concat) and ``fused_film_apply`` (FiLM) pack the
model parameters into the kernel layout (per-image first-layer weight A,
stacked hidden weights, channel-padded final layer), run the trunk, then
slice the real output channels and apply the output activation.

The trunk runs where its tensors are: on a CUDA tensor it is the
hand-written kernel of ``csrc/siren_fwd.cu`` (``siren_trunk_cuda``,
``film_trunk_cuda``); on a CPU tensor it is the plain PyTorch version
(``siren_trunk_reference``, ``film_trunk_reference``). A CUDA tensor never
takes the plain version: a build or launch failure raises.
``fused_apply_reference`` / ``fused_film_apply_reference`` always take the
plain version, on any device — the tests and ``chip_smoke.py`` hold the
kernels against them.

Each wrapper counts the kernel launches it makes in ``.launches``.

The trunks are differentiable (``SirenTrunk``, ``FilmTrunk``: the
``custom_vjp`` of the JAX package). Their backward is the port of
``_bwd_kernel`` / ``_film_bwd_kernel`` in ``kernels/siren_bwd.py``: on the
card the kernel of ``csrc/siren_bwd.cu``, elsewhere its plain version.
Gradients reach the float32 parameters and the latents through the packing
below by ordinary autograd.

Operand layout (float32; K_PAD = C_PAD = 8):

    d_pad (B_d, P, 8) with B_d in (1, B), A (B, 8, H), b0 (B, 1, H),
    Ws (L, H, H), bs (L, H), Wf (H, 8), bf (1, 8)          -> (B, P, 8)
    FiLM: A0 (B, 8, H), Ws (T-1, H, H), bs (T, H),
          freqs / phases (B, 1, T*H), scaled freq*15+30     -> (B, P, 8)
"""

from __future__ import annotations

import ctypes

import torch

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns
from reni_tpu_torch.models import film as film_lib
from reni_tpu_torch.models import siren as siren_lib

C_PAD = 8  # output channels padded
K_PAD = 8  # direction-feature width padded (actual <= 4)
TRUNKS = ("bfloat16", "float32")
# launch geometry of csrc/siren_fwd.cu
TM, ROW_PAD, WARPS = 64, 8, 8
SMEM_LIMIT = 227 * 1024  # H100 dynamic shared memory per block
MAX_GRID_Y = 65535  # the image index is the grid's y


def unsupported_reason(
    npix: int, hidden_features: int, batch: int | None = None,
    trunk: str = "bfloat16",
) -> str | None:
    """Why the CUDA kernels cannot take this shape (None = they can): the
    wmma tiles need a hidden width that is a multiple of 16, a CTA's two
    activation buffers must fit in shared memory, and the batch is the
    grid's y. Any pixel count works: a ragged tail tile is masked."""
    if npix < 1:
        return f"no pixels to decode (npix={npix})"
    if hidden_features < 16 or hidden_features % 16:
        return f"hidden_features={hidden_features} is not a multiple of 16"
    act = 2 if trunk == "bfloat16" else 4
    smem = 2 * TM * (hidden_features + ROW_PAD) * act + WARPS * 256 * 4
    if smem > SMEM_LIMIT:
        return (
            f"hidden_features={hidden_features} needs {smem} B of shared "
            f"memory per CTA with the {trunk} trunk (limit {SMEM_LIMIT})"
        )
    if batch is not None and batch > MAX_GRID_Y:
        return f"batch {batch} exceeds the kernel grid limit {MAX_GRID_Y}"
    return None


# ---------------------------------------------------------------------------
# packing: model parameters -> kernel operands
# ---------------------------------------------------------------------------


def _shared_grid(D: torch.Tensor) -> torch.Tensor:
    """A (B, P, 3) view whose batch stride is 0 is one shared grid."""
    if D.shape[0] > 1 and D.stride(0) == 0:
        return D[:1]
    return D


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _d_features(equivariance, Z, D, hidden_features, trunk, kind):
    D = _shared_grid(D)
    if D.shape[0] not in (1, Z.shape[0]):
        raise ValueError(
            f"direction grid batch {D.shape[0]} is neither 1 nor the latent "
            f"batch {Z.shape[0]}"
        )
    d_feats = encodings.d_features(equivariance, D)
    reason = unsupported_reason(
        d_feats.shape[1], hidden_features, batch=Z.shape[0], trunk=trunk
    )
    if reason:
        raise ValueError(f"unsupported shapes for the fused {kind} path: {reason}")
    return d_feats


def _final_operands(params):
    wf = _pad_last(params["final"]["w"], C_PAD)
    bf = _pad_last(params["final"]["b"], C_PAD)[None]
    return wf, bf


def pack_inputs(params, equivariance: str, ndims: int, Z, d_feats):
    """Cond-by-Concat operands: per-image A/bias0 from the first-layer
    weight split, stacked hidden layers, channel-padded final layer."""
    layer0 = params["layers"][0]
    w_ip, w_bias, w_direct = siren_lib.split_first_layer(
        layer0["w"], equivariance, ndims
    )
    parts = encodings.z_parts(equivariance, Z)
    a = torch.einsum("bcn,nh->bch", parts["proj"], w_ip)  # (B, c, H)
    if w_direct is not None:
        a = torch.cat((a, w_direct[None].expand(a.shape[0], *w_direct.shape)), 1)
    a_pad = torch.nn.functional.pad(a, (0, 0, 0, K_PAD - a.shape[1]))
    b0 = (parts["bias_feats"] @ w_bias + layer0["b"])[:, None, :]  # (B, 1, H)
    d_pad = _pad_last(d_feats, K_PAD)
    ws = torch.stack([l["w"] for l in params["layers"][1:]])  # (L, H, H)
    bs = torch.stack([l["b"] for l in params["layers"][1:]])  # (L, H)
    wf, bf = _final_operands(params)
    return d_pad, a_pad, b0, ws, bs, wf, bf


def pack_film_inputs(params, equivariance: str, Z, d_feats, hidden_features: int):
    """FiLM operands: the mapping network's scaled frequencies and phases,
    the per-image first-layer weight A0 with SO2 columns reordered to the
    ``d_features`` order, stacked trunk layers and padded final layer."""
    parts = encodings.z_parts(equivariance, Z)
    fr, ph = film_lib.apply_mapping_network(params["mapping"], parts["bias_feats"])
    fr = (fr * 15.0 + 30.0)[:, None, :]  # (B, 1, T*H)
    ph = ph[:, None, :]
    w0 = params["layers"][0]["w"]
    if equivariance == "SO2":
        # FiLM siren input is [|D_xz|, D_y, innerprod]; d_features is
        # [D_x, D_z, |D_xz|, D_y]
        a0 = torch.einsum("bcn,nh->bch", parts["proj"], w0[2:])
        a0 = torch.cat((a0, w0[:2][None].expand(a0.shape[0], 2, w0.shape[1])), 1)
    else:
        a0 = torch.einsum("bcn,nh->bch", parts["proj"], w0)
    a0_pad = torch.nn.functional.pad(a0, (0, 0, 0, K_PAD - a0.shape[1]))
    d_pad = _pad_last(d_feats, K_PAD)
    layers = params["layers"]
    ws = (
        torch.stack([l["w"] for l in layers[1:]])
        if len(layers) > 1
        else w0.new_zeros((0, hidden_features, hidden_features))
    )
    bs = torch.stack([l["b"] for l in layers])
    wf, bf = _final_operands(params)
    return d_pad, a0_pad, ws, bs, wf, bf, fr, ph


# ---------------------------------------------------------------------------
# plain PyTorch trunks
# ---------------------------------------------------------------------------


def _matmul(a: torch.Tensor, b: torch.Tensor, trunk: str) -> torch.Tensor:
    """Product with JAX's trunk semantics: for bf16, both operands rounded
    to bf16 and the product kept in float32 (a bf16 x bf16 product is exact
    in float32, so float32 matmul of the rounded values matches
    ``preferred_element_type=f32``; a bf16 torch.matmul would round the
    output instead)."""
    if trunk == "bfloat16":
        a = a.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    return torch.matmul(a, b)


def siren_trunk_reference(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False,
):
    """Plain version of the Cond-by-Concat trunk kernel -> (B, P, 8)."""
    sine, _ = sine_fns(fast_sine)
    h = sine(omega0 * (_matmul(d_pad, a, trunk) + b0))
    for i in range(ws.shape[0]):
        h = sine(omega_h * (_matmul(h, ws[i], trunk) + bs[i]))
    return _matmul(h, wf, trunk) + bf


def film_trunk_reference(
    d_pad, a0, ws, bs, wf, bf, fr, ph, *, trunk="bfloat16", fast_sine=False,
):
    """Plain version of the FiLM trunk kernel -> (B, P, 8)."""
    sine, _ = sine_fns(fast_sine)
    hidden = a0.shape[-1]
    h = None
    for i in range(bs.shape[0]):
        lo = i * hidden
        pre = (
            _matmul(d_pad, a0, trunk) if i == 0 else _matmul(h, ws[i - 1], trunk)
        ) + bs[i]
        h = sine(fr[..., lo : lo + hidden] * pre + ph[..., lo : lo + hidden])
    return _matmul(h, wf, trunk) + bf


# ---------------------------------------------------------------------------
# CUDA trunks
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_SIGNATURES = {
    "reni_siren_fwd": [
        _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P,
    ],
    "reni_film_fwd": [
        _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P,
    ],
}


def _kernel(symbol: str):
    from reni_tpu_torch.kernels import _build

    lib = _build.load("siren_fwd")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        lib.reni_error_string.argtypes = [ctypes.c_int]
        lib.reni_error_string.restype = ctypes.c_char_p
    return fn, lib


def _cuda_operands(kind, trunk, d_pad, batch, tensors):
    """Validate kernel operands; returns (float32 contiguous tensors,
    d batch stride). Weights in ``tensors`` keep their float32 type here;
    the caller casts the matmul weights for the trunk."""
    if trunk not in TRUNKS:
        raise ValueError(f"trunk must be one of {TRUNKS}, got {trunk!r}")
    for t in (d_pad, *tensors):
        if not t.is_cuda:
            raise ValueError(f"{kind} kernel operands must all be CUDA tensors")
    if d_pad.shape[0] not in (1, batch):
        raise ValueError(f"d batch {d_pad.shape[0]} is neither 1 nor {batch}")
    reason = unsupported_reason(d_pad.shape[1], tensors[0].shape[-1], batch, trunk)
    if reason:
        raise ValueError(f"the {kind} CUDA kernel cannot take these operands: {reason}")
    d = d_pad.float().contiguous()
    d_bstride = d.shape[1] * K_PAD if d.shape[0] > 1 else 0
    return d, d_bstride


def _weights(w: torch.Tensor, trunk: str) -> torch.Tensor:
    dtype = torch.bfloat16 if trunk == "bfloat16" else torch.float32
    return w.to(dtype).contiguous()


def _check(err: int, lib, kind: str) -> None:
    if err != 0:
        msg = lib.reni_error_string(err).decode()
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err} ({msg})")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def siren_trunk_cuda(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False,
):
    """Cond-by-Concat trunk on the card (``csrc/siren_fwd.cu``) -> (B, P, 8)."""
    batch, hidden = a.shape[0], a.shape[-1]
    d, d_bstride = _cuda_operands("siren_fwd", trunk, d_pad, batch, (a, b0, ws, bs, wf, bf))
    a, b0, bs, bf = _f32(a), _f32(b0), _f32(bs), _f32(bf)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    npix = d.shape[1]
    out = torch.empty((batch, npix, C_PAD), dtype=torch.float32, device=d.device)
    fn, lib = _kernel("reni_siren_fwd")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), wf.data_ptr(), bf.data_ptr(), out.data_ptr(),
            batch, npix, hidden, ws.shape[0], float(omega0), float(omega_h),
            int(trunk == "bfloat16"), int(bool(fast_sine)), stream,
        )
    _check(err, lib, "siren_fwd")
    fused_apply.launches += 1
    return out


def film_trunk_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, *, trunk="bfloat16", fast_sine=False,
):
    """FiLM trunk on the card (``csrc/siren_fwd.cu``) -> (B, P, 8)."""
    batch, hidden = a0.shape[0], a0.shape[-1]
    d, d_bstride = _cuda_operands(
        "film_fwd", trunk, d_pad, batch, (a0, ws, bs, wf, bf, fr, ph)
    )
    a0, bs, bf, fr, ph = _f32(a0), _f32(bs), _f32(bf), _f32(fr), _f32(ph)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    npix = d.shape[1]
    out = torch.empty((batch, npix, C_PAD), dtype=torch.float32, device=d.device)
    fn, lib = _kernel("reni_film_fwd")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(
            d.data_ptr(), d_bstride, a0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), fr.data_ptr(), ph.data_ptr(),
            out.data_ptr(), batch, npix, hidden, bs.shape[0],
            int(trunk == "bfloat16"), int(bool(fast_sine)), stream,
        )
    _check(err, lib, "film_fwd")
    fused_film_apply.launches += 1
    return out


# ---------------------------------------------------------------------------
# differentiable trunks
# ---------------------------------------------------------------------------


class SirenTrunk(torch.autograd.Function):
    """The Cond-by-Concat trunk with its backward (the ``custom_vjp`` of
    ``make_fused_siren``): the forward saves its inputs, not activations; the
    backward recomputes them. ``kernel=True`` runs the CUDA kernels of
    ``csrc/siren_fwd.cu`` / ``csrc/siren_bwd.cu``, ``kernel=False`` their
    plain versions. The weight gradients are computed only when a weight
    needs one; ``d_pad`` gets none."""

    @staticmethod
    def forward(ctx, d_pad, a, b0, ws, bs, wf, bf, kernel, kw):
        ctx.save_for_backward(d_pad, a, b0, ws, bs, wf, bf)
        ctx.kernel, ctx.kw = kernel, kw
        return SirenTrunk.trunks[kernel](d_pad, a, b0, ws, bs, wf, bf, **kw)

    @staticmethod
    def backward(ctx, g):
        from reni_tpu_torch.kernels import siren_bwd

        bwd = siren_bwd.siren_trunk_bwd_cuda if ctx.kernel else siren_bwd.siren_trunk_bwd_reference
        grads = bwd(
            *ctx.saved_tensors, g, weight_grads=any(ctx.needs_input_grad[3:7]), **ctx.kw
        )
        return (None, *grads, None, None)


class FilmTrunk(torch.autograd.Function):
    """The FiLM trunk with its backward (the ``custom_vjp`` of
    ``make_fused_film``); see ``SirenTrunk``."""

    @staticmethod
    def forward(ctx, d_pad, a0, ws, bs, wf, bf, fr, ph, kernel, kw):
        ctx.save_for_backward(d_pad, a0, ws, bs, wf, bf, fr, ph)
        ctx.kernel, ctx.kw = kernel, kw
        return FilmTrunk.trunks[kernel](d_pad, a0, ws, bs, wf, bf, fr, ph, **kw)

    @staticmethod
    def backward(ctx, g):
        from reni_tpu_torch.kernels import siren_bwd

        bwd = siren_bwd.film_trunk_bwd_cuda if ctx.kernel else siren_bwd.film_trunk_bwd_reference
        da0, dws, dbs, dwf, dbf, dfr, dph = bwd(
            *ctx.saved_tensors, g, weight_grads=any(ctx.needs_input_grad[2:6]), **ctx.kw
        )
        return None, da0, dws, dbs, dwf, dbf, dfr, dph, None, None


SirenTrunk.trunks = (siren_trunk_reference, siren_trunk_cuda)
FilmTrunk.trunks = (film_trunk_reference, film_trunk_cuda)


def _trunk(fn, ops, kernel: bool, kw: dict):
    """Run a trunk: through its autograd Function when a gradient is needed,
    else directly (serving under inference_mode records nothing)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return fn.apply(*ops, kernel, kw)
    return fn.trunks[kernel](*ops, **kw)


# ---------------------------------------------------------------------------
# model-facing entries
# ---------------------------------------------------------------------------


def _siren(params, equivariance, ndims, Z, D, *, hidden_layers, hidden_features,
           out_features, first_omega_0, hidden_omega_0, output_activation,
           trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "siren")
    ops = pack_inputs(params, equivariance, ndims, Z, d_feats)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} hidden layers, config says {hidden_layers}"
        )
    kw = dict(omega0=first_omega_0, omega_h=hidden_omega_0, trunk=trunk, fast_sine=fast_sine)
    out = _trunk(SirenTrunk, ops, kernel, kw)
    return siren_lib._output_activation(out[..., :out_features], output_activation)


def fused_apply(
    params, equivariance: str, ndims: int, Z, D, *, hidden_layers: int,
    hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """Drop-in for ``siren.apply_siren_decomposed`` through the fused trunk.

    D: (1, P, 3) shared grid, (B, P, 3) per-image grids, or a (B, P, 3)
    view with batch stride 0 (read as one shared grid). CUDA tensors launch
    the kernel; CPU tensors take ``siren_trunk_reference``."""
    return _siren(
        params, equivariance, ndims, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        first_omega_0=first_omega_0, hidden_omega_0=hidden_omega_0,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=Z.is_cuda,
    )


fused_apply.launches = 0


def fused_apply_reference(
    params, equivariance: str, ndims: int, Z, D, *, hidden_layers: int,
    hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """``fused_apply`` through the plain PyTorch trunk (forward and
    backward), on any device."""
    return _siren(
        params, equivariance, ndims, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        first_omega_0=first_omega_0, hidden_omega_0=hidden_omega_0,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=False,
    )


def _film(params, equivariance, Z, D, *, hidden_layers, hidden_features,
          out_features, output_activation, trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "film")
    ops = pack_film_inputs(params, equivariance, Z, d_feats, hidden_features)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} trunk layers, config says {hidden_layers}"
        )
    out = _trunk(FilmTrunk, ops, kernel, dict(trunk=trunk, fast_sine=fast_sine))
    return siren_lib._output_activation(out[..., :out_features], output_activation)


def fused_film_apply(
    params, equivariance: str, Z, D, *, hidden_layers: int, hidden_features: int,
    out_features: int, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """Drop-in for ``film.apply_film_decomposed`` through the fused trunk.
    The mapping network (per image) runs in PyTorch; the kernel fuses the
    per-pixel FiLM trunk. CUDA tensors launch the kernel; CPU tensors take
    ``film_trunk_reference``."""
    return _film(
        params, equivariance, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=Z.is_cuda,
    )


fused_film_apply.launches = 0


def fused_film_apply_reference(
    params, equivariance: str, Z, D, *, hidden_layers: int, hidden_features: int,
    out_features: int, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """``fused_film_apply`` through the plain PyTorch trunk (forward and
    backward), on any device."""
    return _film(
        params, equivariance, Z, D, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=False,
    )
