"""Fused train step: the port of ``_step_kernel`` of
``reni_tpu/kernels/siren_pallas.py``, the FIT_DECODER objective.

One call computes the weighted MSE of the Cond-by-Concat decoder against
its targets and the gradient of every trunk operand, from the operands of
``kernels/siren_fwd.py`` plus (float32; C_PAD = 8)

    tgt (B, P, 8) targets, sw (1, P, 8) pixel weights, bm (B, 1, 8) batch mask
    -> mse_row (1, 8), dA (B, 8, H), db0 (B, 1, H), dWs (L, H, H),
       dbs (L, H), dWf (H, 8), dbf (1, 8)

``mse_row`` holds per-lane sums of (act(o) - tgt)^2 * sw * bm;
``sum(mse_row) * gscale`` with ``gscale = 1 / (P * out_features)`` is
``losses.weighted_mse``, and the gradients are those of that scaled loss.
Padded lanes and masked rows carry zero weight.

``siren_step_cuda`` launches the hand-written kernel of ``csrc/siren_step.cu``
(CUDA tensors only; a failed build or launch raises) and counts its calls in
``.launches``; two calls on the same inputs give the same bits.
``siren_step_reference`` is its plain PyTorch version, step by step like the
TPU kernel with its bf16 rounding. ``StepMSE`` makes the loss differentiable:
the value is a scalar, so the forward pass computes every gradient and the
backward pass scales them by the incoming cotangent (``_wrap_step_vjp``).
``fused_step_mse`` is the model-facing entry: gradients reach the float32
parameters and the latents through ``pack_inputs`` by ordinary autograd.
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
    pack_inputs,
)

ACTIVATIONS = {None: 0, "tanh": 1, "exp": 2}  # csrc/siren_step.cu ACT_*


def weight_values(hidden: int, n_mm: int) -> int:
    """Small sums of one CTA: mse (8) | dbs (L H) | dWf (8 H) | dbf (8)."""
    return C_PAD + n_mm * hidden + hidden * C_PAD + C_PAD


def step_smem_bytes(trunk: str, hidden: int, n_mm: int) -> int:
    """Shared memory of one CTA of the step kernel (the ``layout`` of
    ``csrc/siren_step.cu``): what the backward kernel keeps, plus a target,
    a pixel-weight and a loss tile and the loss partials."""
    bf16 = trunk == "bfloat16"
    tm, act, lda = tile_rows(trunk), (2 if bf16 else 4), hidden + ROW_PAD
    n_act = n_mm + 1
    parts = (
        n_act * tm * lda * act,  # activations
        n_act * tm * hidden * 4,  # cos factors
        tm * hidden * 4,  # dh
        tm * lda * act,  # dz
        *(tm * C_PAD * 4,) * 5,  # directions, cotangent, targets, weights, loss terms
        siren_bwd.image_values(False, hidden, n_mm) * 4,
        weight_values(hidden, n_mm) * 4,
    )
    staging = WARPS * 256 * 4 if bf16 else 0
    return sum(_align128(p) for p in parts) + staging


def step_unsupported_reason(
    hidden_features: int, hidden_layers: int, trunk: str = "bfloat16"
) -> str | None:
    """Why the step kernel cannot take this trunk (None = it can): it needs
    one hidden layer at least, and one tile's activations and cos factors of
    every layer must fit in a CTA's shared memory."""
    if hidden_layers < 1:
        return f"hidden_layers={hidden_layers}: the train-step kernel needs a hidden layer"
    smem = step_smem_bytes(trunk, hidden_features, hidden_layers)
    if smem > SMEM_LIMIT:
        return (
            f"the train step of a {hidden_layers} x {hidden_features} trunk needs "
            f"{smem} B of shared memory per CTA with the {trunk} trunk (limit {SMEM_LIMIT})"
        )
    return None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def siren_step_reference(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """Plain version of the step kernel -> (mse_row, dA, db0, dWs, dbs, dWf, dbf)."""
    kw = dict(omega0=omega0, omega_h=omega_h, trunk=trunk)
    hs, cs = siren_bwd.siren_forward_keep(d_pad, a, b0, ws, bs, fast_sine=fast_sine, **kw)
    o = _matmul(hs[-1], wf, trunk) + bf
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
    grads = siren_bwd.siren_chain_bwd(d_pad, ws, bs, wf, hs, cs, g, weight_grads=True, **kw)
    return (mse_row, *grads)


# ---------------------------------------------------------------------------
# CUDA version
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P, ctypes.c_longlong, *[_P] * 17, *[_I] * 8, _F, _F, _F, _I, _I, _I, _P]


def library():
    """The built ``csrc/siren_step.cu`` (compiled at first call)."""
    from reni_tpu_torch.kernels import _build

    lib = _build.load("siren_step")
    if lib.reni_step_error_string.restype is not ctypes.c_char_p:
        lib.reni_siren_step.argtypes = _SIGNATURE
        lib.reni_siren_step.restype = ctypes.c_int
        lib.reni_step_smem_bytes.argtypes = [_I, _I, _I]
        lib.reni_step_smem_bytes.restype = ctypes.c_int
        lib.reni_step_error_string.argtypes = [ctypes.c_int]
        lib.reni_step_error_string.restype = ctypes.c_char_p
    return lib


def siren_step_cuda(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """The train step on the card (``csrc/siren_step.cu``); returns what
    ``siren_step_reference`` returns."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride = _cuda_operands(
        "siren_step", trunk, d_pad, batch, (a, b0, ws, bs, wf, bf, tgt, sw, bm)
    )
    npix = d.shape[1]
    for name, t, shape in (("tgt", tgt, (batch, npix, C_PAD)), ("sw", sw, (1, npix, C_PAD)),
                           ("bm", bm, (batch, 1, C_PAD))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if out_act not in ACTIVATIONS:
        raise ValueError(f"output activation {out_act!r} is not one of {list(ACTIVATIONS)}")
    reason = step_unsupported_reason(hidden, n_mm, trunk)
    if reason:
        raise ValueError(f"the siren_step CUDA kernel cannot take these operands: {reason}")
    dev = d.device
    tiles, chunks = siren_bwd.launch_grid(npix, batch, trunk, dev)
    n_img, n_w = siren_bwd.image_values(False, hidden, n_mm), weight_values(hidden, n_mm)
    part_img = torch.empty((batch, chunks, n_img), dtype=torch.float32, device=dev)
    out_img = torch.empty((batch, n_img), dtype=torch.float32, device=dev)
    work = WeightGradWork.allocate(trunk, n_mm, batch * npix, hidden, batch * chunks, n_w, dev)
    part_w, out_w, *rest = work.pointers()
    a, b0, bs, bf, tgt, sw, bm = map(_f32, (a, b0, bs, bf, tgt, sw, bm))
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.reni_siren_step(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), wf.data_ptr(), bf.data_ptr(), tgt.data_ptr(), sw.data_ptr(),
            bm.data_ptr(), part_img.data_ptr(), out_img.data_ptr(), part_w, out_w, *rest,
            batch, npix, hidden, n_mm, tiles, chunks, work.rows_per_chunk, work.n_wchunks,
            float(omega0), float(omega_h), float(gscale), int(trunk == "bfloat16"),
            int(bool(fast_sine)), ACTIVATIONS[out_act], stream,
        )
    if err != 0:
        msg = lib.reni_step_error_string(err).decode()
        raise RuntimeError(f"siren_step kernel launch failed: CUDA error {err} ({msg})")
    siren_step_cuda.launches += 1
    da = out_img[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    db0 = out_img[:, K_PAD * hidden :].view(batch, 1, hidden)
    mse_row = work.out_w[:C_PAD].view(1, C_PAD)
    return (mse_row, da, db0, work.dws, *work.small_sums(n_mm, hidden, skip=C_PAD))


siren_step_cuda.launches = 0


# ---------------------------------------------------------------------------
# differentiable loss and the model-facing entry
# ---------------------------------------------------------------------------


class StepMSE(torch.autograd.Function):
    """``sum(mse_row) * gscale`` with its gradients computed in the forward
    pass (``_wrap_step_vjp``): the backward pass multiplies them by the
    incoming cotangent. ``kernel=True`` runs ``siren_step_cuda``,
    ``kernel=False`` ``siren_step_reference``. ``d_pad``, the targets, the
    pixel weights and the mask get no gradient."""

    steps = (siren_step_reference, siren_step_cuda)

    @staticmethod
    def forward(ctx, d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, kernel, kw):
        mse_row, *grads = StepMSE.steps[kernel](d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, **kw)
        ctx.save_for_backward(*grads)
        return mse_row.sum() * kw["gscale"]

    @staticmethod
    def backward(ctx, ct):
        return (None, *(ct * g for g in ctx.saved_tensors), None, None, None, None, None)


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
    tgt = _pad_last(targets, C_PAD)
    sw = _pad_last(sineweight, C_PAD)
    bm = bmask[:, None, None].float().expand(bmask.shape[0], 1, C_PAD)
    # weighted_mse = sum(se * sw) / (pixels * channels per sample), with the
    # real channel count (padded lanes carry zero weight)
    kw = dict(omega0=first_omega_0, omega_h=hidden_omega_0, out_act=output_activation,
              gscale=1.0 / float(d_feats.shape[1] * out_features), trunk=trunk,
              fast_sine=fast_sine)
    return StepMSE.apply(*ops, tgt, sw, bm, kernel, kw)


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
