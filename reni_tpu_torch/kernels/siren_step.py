"""Fused train steps: the ports of ``_step_kernel`` (Cond-by-Concat) and
``_film_step_kernel`` (FiLM) of ``reni_tpu/kernels/siren_pallas.py``, the
FIT_DECODER objective. Both live in this module: they share the loss, the
autograd Function, the work space and the launch geometry.

One call computes the weighted MSE of the decoder against its targets and
the gradient of every trunk operand, from the operands of
``kernels/siren_fwd.py`` plus (float32; C_PAD = 8)

    tgt (B, P, 8) targets, sw (1, P, 8) pixel weights, bm (B, 1, 8) batch mask
    Cond-by-Concat -> mse_row (1, 8), dA (B, 8, H), db0 (B, 1, H),
                      dWs (L, H, H), dbs (L, H), dWf (H, 8), dbf (1, 8)
    FiLM           -> mse_row (1, 8), dA0 (B, 8, H), dWs (T-1, H, H),
                      dbs (T, H), dWf (H, 8), dbf (1, 8),
                      dfreqs (B, 1, T*H), dphases (B, 1, T*H)

``mse_row`` holds per-lane sums of (act(o) - tgt)^2 * sw * bm;
``sum(mse_row) * gscale`` with ``gscale = 1 / (P * out_features)`` is
``losses.weighted_mse``, and the gradients are those of that scaled loss.
Padded lanes and masked rows carry zero weight.

``siren_step_cuda`` / ``film_step_cuda`` launch the hand-written kernels of
``csrc/siren_step.cu`` / ``csrc/film_step.cu`` (one template,
``csrc/siren_step.cuh``; CUDA tensors only; a failed build or launch raises)
and count their calls in ``.launches``; two calls on the same inputs give the
same bits. ``siren_step_reference`` / ``film_step_reference`` are their plain
PyTorch versions, step by step like the TPU kernels with their bf16 rounding.
``StepMSE`` makes the loss differentiable: the value is a scalar, so the
forward pass computes every gradient and the backward pass scales them by
the incoming cotangent (``_wrap_step_vjp`` / ``_wrap_film_step_vjp``).
``fused_step_mse`` and ``fused_film_step_mse`` are the model-facing entries:
gradients reach the float32 parameters and the latents through
``pack_inputs`` / ``pack_film_inputs`` (for FiLM: the mapping network, the
``freqs * 15 + 30`` scaling and the ``A0`` build) by ordinary autograd.
"""

from __future__ import annotations

import ctypes

import torch

from reni_tpu_torch.kernels import siren_bwd
from reni_tpu_torch.kernels.siren_bwd import WARPS, WeightGradWork, _align128, tile_rows
from reni_tpu_torch.kernels.siren_fwd import (
    C_PAD,
    K_PAD,
    ROW_PAD,
    SMEM_LIMIT,
    _cuda_operands,
    _d_features,
    _f32,
    _matmul,
    _pad_last,
    _weights,
    pack_film_inputs,
    pack_inputs,
)

ACTIVATIONS = {None: 0, "tanh": 1, "exp": 2}  # csrc/siren_step.cuh ACT_*


def weight_values(hidden: int, n_mm: int, film: bool = False) -> int:
    """Small sums of one CTA: mse (8) | dbs (n_bs H) | dWf (8 H) | dbf (8).
    FiLM's first-layer bias is a shared weight: n_bs = n_mm + 1, else n_mm."""
    n_bs = n_mm + 1 if film else n_mm
    return C_PAD + n_bs * hidden + hidden * C_PAD + C_PAD


def step_smem_bytes(trunk: str, hidden: int, n_mm: int, film: bool = False) -> int:
    """Shared memory of one CTA of the step kernel (the ``layout`` of
    ``csrc/siren_step.cuh``): what the backward kernel keeps, plus a target,
    a pixel-weight and a loss tile and the loss partials. ``n_mm`` is the
    number of H x H products (Cond-by-Concat L, FiLM T - 1)."""
    bf16 = trunk == "bfloat16"
    tm, act, lda = tile_rows(trunk), (2 if bf16 else 4), hidden + ROW_PAD
    n_act = n_mm + 1
    parts = (
        n_act * tm * lda * act,  # activations
        n_act * tm * hidden * 4,  # cos factors / FiLM pre-modulation
        tm * hidden * 4,  # dh
        tm * lda * act,  # dz
        *(tm * C_PAD * 4,) * 5,  # directions, cotangent, targets, weights, loss terms
        siren_bwd.image_values(film, hidden, n_mm) * 4,
        weight_values(hidden, n_mm, film) * 4,
    )
    staging = WARPS * 256 * 4 if bf16 else 0
    return sum(_align128(p) for p in parts) + staging


def film_step_smem_bytes(trunk: str, hidden: int, n_mm: int) -> int:
    """``step_smem_bytes`` of the FiLM step kernel (``n_mm`` = T - 1)."""
    return step_smem_bytes(trunk, hidden, n_mm, film=True)


def step_unsupported_reason(
    hidden_features: int, hidden_layers: int, trunk: str = "bfloat16", film: bool = False
) -> str | None:
    """Why the step kernel cannot take this trunk (None = it can). The
    Cond-by-Concat kernel needs one hidden layer at least, the FiLM kernel
    one trunk layer (which then has no H x H product); one tile's activations
    and cos factors (FiLM: pre-modulation values) of every layer must fit in
    a CTA's shared memory."""
    if hidden_layers < 1:
        what = "trunk layer" if film else "hidden layer"
        return f"hidden_layers={hidden_layers}: the train-step kernel needs a {what}"
    smem = step_smem_bytes(trunk, hidden_features, hidden_layers - 1 if film else hidden_layers,
                           film)
    if smem > SMEM_LIMIT:
        return (
            f"the {'FiLM ' if film else ''}train step of a {hidden_layers} x {hidden_features} "
            f"trunk needs {smem} B of shared memory per CTA with the {trunk} trunk "
            f"(limit {SMEM_LIMIT})"
        )
    return None


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _loss_cotangent(o, tgt, sw, bm, out_act, gscale):
    """(mse_row (1, 8), g (B, P, 8)): the loss partials of the output ``o``
    and the cotangent of ``o`` under the scaled loss."""
    if out_act == "tanh":
        out = torch.tanh(o)
        dact = 1.0 - out * out
    elif out_act == "exp":
        out = torch.exp(o)
        dact = out
    else:
        out, dact = o, None
    r = out - tgt
    rs = r * (sw * bm)
    mse_row = (rs * r).sum((0, 1))[None]
    g = (2.0 * gscale) * rs
    if dact is not None:
        g = g * dact
    return mse_row, g


def siren_step_reference(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """Plain version of the step kernel -> (mse_row, dA, db0, dWs, dbs, dWf, dbf)."""
    kw = dict(omega0=omega0, omega_h=omega_h, trunk=trunk)
    hs, cs = siren_bwd.siren_forward_keep(d_pad, a, b0, ws, bs, fast_sine=fast_sine, **kw)
    mse_row, g = _loss_cotangent(_matmul(hs[-1], wf, trunk) + bf, tgt, sw, bm, out_act, gscale)
    grads = siren_bwd.siren_chain_bwd(d_pad, ws, bs, wf, hs, cs, g, weight_grads=True, **kw)
    return (mse_row, *grads)


def film_step_reference(
    d_pad, a0, ws, bs, wf, bf, fr, ph, tgt, sw, bm, *, out_act, gscale, trunk="bfloat16",
    fast_sine=False,
):
    """Plain version of the FiLM step kernel -> (mse_row, dA0, dWs, dbs, dWf,
    dbf, dfreqs, dphases)."""
    pres, hs, coss = siren_bwd.film_forward_keep(
        d_pad, a0, ws, bs, fr, ph, trunk=trunk, fast_sine=fast_sine
    )
    mse_row, g = _loss_cotangent(_matmul(hs[-1], wf, trunk) + bf, tgt, sw, bm, out_act, gscale)
    grads = siren_bwd.film_chain_bwd(
        d_pad, ws, bs, wf, fr, pres, hs, coss, g, trunk=trunk, weight_grads=True
    )
    return (mse_row, *grads)


# ---------------------------------------------------------------------------
# CUDA versions
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "reni_siren_step": [_P, ctypes.c_longlong, *[_P] * 17, *[_I] * 8, _F, _F, _F, _I, _I, _I, _P],
    "reni_film_step": [_P, ctypes.c_longlong, *[_P] * 18, *[_I] * 8, _F, _I, _I, _I, _P],
}


# (source, step, shared-memory bytes, error string) of each library
_SYMBOLS = {
    False: ("siren_step", "reni_siren_step", "reni_step_smem_bytes", "reni_step_error_string"),
    True: ("film_step", "reni_film_step", "reni_film_step_smem_bytes",
           "reni_film_step_error_string"),
}


def library(film: bool = False):
    """The built ``csrc/siren_step.cu`` or ``csrc/film_step.cu`` (compiled at
    first call), with ``step``, ``smem_bytes`` and ``error_string`` bound."""
    from reni_tpu_torch.kernels import _build

    source, step, smem, error_string = _SYMBOLS[film]
    lib = _build.load(source)
    if not hasattr(lib, "step"):
        lib.step, lib.smem_bytes = getattr(lib, step), getattr(lib, smem)
        lib.error_string = getattr(lib, error_string)
        lib.step.argtypes, lib.step.restype = _SIGNATURES[step], ctypes.c_int
        lib.smem_bytes.argtypes, lib.smem_bytes.restype = [_I, _I, _I], ctypes.c_int
        lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _prepare(kind, film, trunk, d_pad, batch, hidden, n_layers, out_act, operands, tgt, sw, bm):
    """Validate a step's operands and allocate its outputs and work space:
    (d, d batch stride, tiles per CTA, CTAs per image, per-image slots,
    per-image output (B, n_img), weight-gradient work space)."""
    d, d_bstride = _cuda_operands(kind, trunk, d_pad, batch, (*operands, tgt, sw, bm))
    npix = d.shape[1]
    for name, t, shape in (("tgt", tgt, (batch, npix, C_PAD)), ("sw", sw, (1, npix, C_PAD)),
                           ("bm", bm, (batch, 1, C_PAD))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if out_act not in ACTIVATIONS:
        raise ValueError(f"output activation {out_act!r} is not one of {list(ACTIVATIONS)}")
    reason = step_unsupported_reason(hidden, n_layers, trunk, film)
    if reason:
        raise ValueError(f"the {kind} CUDA kernel cannot take these operands: {reason}")
    n_mm = n_layers - 1 if film else n_layers
    dev = d.device
    tiles, chunks = siren_bwd.launch_grid(npix, batch, trunk, dev)
    n_img = siren_bwd.image_values(film, hidden, n_mm)
    part_img = torch.empty((batch, chunks, n_img), dtype=torch.float32, device=dev)
    out_img = torch.empty((batch, n_img), dtype=torch.float32, device=dev)
    work = WeightGradWork.allocate(
        trunk, n_mm, batch * npix, hidden, batch * chunks, weight_values(hidden, n_mm, film), dev
    )
    return d, d_bstride, tiles, chunks, part_img, out_img, work


def siren_step_cuda(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """The train step on the card (``csrc/siren_step.cu``); returns what
    ``siren_step_reference`` returns."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride, tiles, chunks, part_img, out_img, work = _prepare(
        "siren_step", False, trunk, d_pad, batch, hidden, n_mm, out_act,
        (a, b0, ws, bs, wf, bf), tgt, sw, bm,
    )
    part_w, out_w, *rest = work.pointers()
    a, b0, bs, bf, tgt, sw, bm = map(_f32, (a, b0, bs, bf, tgt, sw, bm))
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.step(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), wf.data_ptr(), bf.data_ptr(), tgt.data_ptr(), sw.data_ptr(),
            bm.data_ptr(), part_img.data_ptr(), out_img.data_ptr(), part_w, out_w, *rest,
            batch, d.shape[1], hidden, n_mm, tiles, chunks, work.rows_per_chunk,
            work.n_wchunks, float(omega0), float(omega_h), float(gscale),
            int(trunk == "bfloat16"), int(bool(fast_sine)), ACTIVATIONS[out_act], stream,
        )
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"siren_step kernel launch failed: CUDA error {err} ({msg})")
    siren_step_cuda.launches += 1
    da = out_img[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    db0 = out_img[:, K_PAD * hidden :].view(batch, 1, hidden)
    mse_row = work.out_w[:C_PAD].view(1, C_PAD)
    return (mse_row, da, db0, work.dws, *work.small_sums(n_mm, hidden, skip=C_PAD))


siren_step_cuda.launches = 0


def film_step_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, tgt, sw, bm, *, out_act, gscale, trunk="bfloat16",
    fast_sine=False,
):
    """The FiLM train step on the card (``csrc/film_step.cu``); returns what
    ``film_step_reference`` returns."""
    batch, hidden, n_trunk = a0.shape[0], a0.shape[-1], bs.shape[0]
    d, d_bstride, tiles, chunks, part_img, out_img, work = _prepare(
        "film_step", True, trunk, d_pad, batch, hidden, n_trunk, out_act,
        (a0, ws, bs, wf, bf, fr, ph), tgt, sw, bm,
    )
    th = n_trunk * hidden
    for name, t in (("freqs", fr), ("phases", ph)):
        if tuple(t.shape) != (batch, 1, th):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(batch, 1, th)}")
    if ws.shape[0] != n_trunk - 1:
        raise ValueError(f"{ws.shape[0]} hidden weights for {n_trunk} trunk layers")
    part_w, out_w, *rest = work.pointers()
    a0, bs, bf, fr, ph, tgt, sw, bm = map(_f32, (a0, bs, bf, fr, ph, tgt, sw, bm))
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library(film=True)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.step(
            d.data_ptr(), d_bstride, a0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wf.data_ptr(), bf.data_ptr(), fr.data_ptr(), ph.data_ptr(), tgt.data_ptr(),
            sw.data_ptr(), bm.data_ptr(), part_img.data_ptr(), out_img.data_ptr(), part_w,
            out_w, *rest, batch, d.shape[1], hidden, n_trunk, tiles, chunks,
            work.rows_per_chunk, work.n_wchunks, float(gscale), int(trunk == "bfloat16"),
            int(bool(fast_sine)), ACTIVATIONS[out_act], stream,
        )
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"film_step kernel launch failed: CUDA error {err} ({msg})")
    film_step_cuda.launches += 1
    da0 = out_img[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    dfr = out_img[:, K_PAD * hidden : K_PAD * hidden + th].view(batch, 1, th)
    dph = out_img[:, K_PAD * hidden + th :].view(batch, 1, th)
    mse_row = work.out_w[:C_PAD].view(1, C_PAD)
    dbs, dwf, dbf = work.small_sums(n_trunk, hidden, skip=C_PAD)
    return mse_row, da0, work.dws, dbs, dwf, dbf, dfr, dph


film_step_cuda.launches = 0


# ---------------------------------------------------------------------------
# differentiable loss and the model-facing entries
# ---------------------------------------------------------------------------


class StepMSE(torch.autograd.Function):
    """``sum(mse_row) * gscale`` with its gradients computed in the forward
    pass (``_wrap_step_vjp``, ``_wrap_film_step_vjp``): the backward pass
    multiplies them by the incoming cotangent. ``steps[film][kernel]`` is the
    step that runs: the plain version, or (``kernel=True``) the CUDA kernel.
    ``ops`` are the step's operands in order: ``d_pad``, the trunk operands,
    then the targets, the pixel weights and the mask; only the trunk operands
    get a gradient."""

    steps = {
        False: (siren_step_reference, siren_step_cuda),
        True: (film_step_reference, film_step_cuda),
    }

    @staticmethod
    def forward(ctx, film, kernel, kw, *ops):
        mse_row, *grads = StepMSE.steps[film][kernel](*ops, **kw)
        ctx.save_for_backward(*grads)
        return mse_row.sum() * kw["gscale"]

    @staticmethod
    def backward(ctx, ct):
        return (None, None, None, None, *(ct * g for g in ctx.saved_tensors), None, None, None)


def _loss_operands(targets, sineweight, bmask):
    """The targets and pixel weights padded to 8 lanes and the (B, 1, 8)
    batch mask."""
    bm = bmask[:, None, None].float().expand(bmask.shape[0], 1, C_PAD)
    return _pad_last(targets, C_PAD), _pad_last(sineweight, C_PAD), bm


def _step_mse(params, equivariance, ndims, Z, D, targets, sineweight, bmask, *,
              hidden_layers, hidden_features, out_features, first_omega_0, hidden_omega_0,
              output_activation, trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "siren step")
    reason = step_unsupported_reason(hidden_features, hidden_layers, trunk)
    if reason:
        raise ValueError(f"unsupported shapes for the fused siren step path: {reason}")
    ops = pack_inputs(params, equivariance, ndims, Z, d_feats)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} hidden layers, config says {hidden_layers}"
        )
    # weighted_mse = sum(se * sw) / (pixels * channels per sample), with the
    # real channel count (padded lanes carry zero weight)
    kw = dict(omega0=first_omega_0, omega_h=hidden_omega_0, out_act=output_activation,
              gscale=1.0 / float(d_feats.shape[1] * out_features), trunk=trunk,
              fast_sine=fast_sine)
    return StepMSE.apply(False, kernel, kw, *ops, *_loss_operands(targets, sineweight, bmask))


def fused_step_mse(
    params, equivariance: str, ndims: int, Z, D, targets, sineweight, bmask, *,
    hidden_layers: int, hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """The FIT_DECODER objective's weighted MSE through the train-step
    kernel: ``losses.weighted_mse(act(decode(Z, D)), targets, sineweight *
    bmask)``, differentiable w.r.t. Z and every decoder parameter.

    targets (B, P, C), sineweight (1, P, C), bmask (B,); D as for
    ``fused_apply``. CUDA tensors launch the kernel; CPU tensors take
    ``siren_step_reference``."""
    return _step_mse(
        params, equivariance, ndims, Z, D, targets, sineweight, bmask,
        hidden_layers=hidden_layers, hidden_features=hidden_features,
        out_features=out_features, first_omega_0=first_omega_0,
        hidden_omega_0=hidden_omega_0, output_activation=output_activation, trunk=trunk,
        fast_sine=fast_sine, kernel=Z.is_cuda,
    )


def fused_step_mse_reference(
    params, equivariance: str, ndims: int, Z, D, targets, sineweight, bmask, *,
    hidden_layers: int, hidden_features: int, out_features: int, first_omega_0: float,
    hidden_omega_0: float, output_activation: str | None, trunk: str = "bfloat16",
    fast_sine: bool = False,
):
    """``fused_step_mse`` through the plain PyTorch step, on any device."""
    return _step_mse(
        params, equivariance, ndims, Z, D, targets, sineweight, bmask,
        hidden_layers=hidden_layers, hidden_features=hidden_features,
        out_features=out_features, first_omega_0=first_omega_0,
        hidden_omega_0=hidden_omega_0, output_activation=output_activation, trunk=trunk,
        fast_sine=fast_sine, kernel=False,
    )


def _film_step_mse(params, equivariance, Z, D, targets, sineweight, bmask, *, hidden_layers,
                   hidden_features, out_features, output_activation, trunk, fast_sine, kernel):
    d_feats = _d_features(equivariance, Z, D, hidden_features, trunk, "film step")
    reason = step_unsupported_reason(hidden_features, hidden_layers, trunk, film=True)
    if reason:
        raise ValueError(f"unsupported shapes for the fused film step path: {reason}")
    ops = pack_film_inputs(params, equivariance, Z, d_feats, hidden_features)
    if ops[3].shape[0] != hidden_layers:
        raise ValueError(
            f"params have {ops[3].shape[0]} trunk layers, config says {hidden_layers}"
        )
    kw = dict(out_act=output_activation, gscale=1.0 / float(d_feats.shape[1] * out_features),
              trunk=trunk, fast_sine=fast_sine)
    return StepMSE.apply(True, kernel, kw, *ops, *_loss_operands(targets, sineweight, bmask))


def fused_film_step_mse(
    params, equivariance: str, Z, D, targets, sineweight, bmask, *, hidden_layers: int,
    hidden_features: int, out_features: int, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """The FiLM counterpart of ``fused_step_mse``: the FIT_DECODER weighted
    MSE through the FiLM train-step kernel, differentiable w.r.t. Z and every
    decoder parameter (the mapping network included, through the frequencies
    and phases). CUDA tensors launch the kernel; CPU tensors take
    ``film_step_reference``."""
    return _film_step_mse(
        params, equivariance, Z, D, targets, sineweight, bmask, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine,
        kernel=Z.is_cuda,
    )


def fused_film_step_mse_reference(
    params, equivariance: str, Z, D, targets, sineweight, bmask, *, hidden_layers: int,
    hidden_features: int, out_features: int, output_activation: str | None,
    trunk: str = "bfloat16", fast_sine: bool = False,
):
    """``fused_film_step_mse`` through the plain PyTorch step, on any device."""
    return _film_step_mse(
        params, equivariance, Z, D, targets, sineweight, bmask, hidden_layers=hidden_layers,
        hidden_features=hidden_features, out_features=out_features,
        output_activation=output_activation, trunk=trunk, fast_sine=fast_sine, kernel=False,
    )
