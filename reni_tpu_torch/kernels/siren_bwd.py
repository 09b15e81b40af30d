"""Fused decoder backward: the port of ``_bwd_kernel`` and ``_film_bwd_kernel``
of ``reni_tpu/kernels/siren_pallas.py``.

Given the trunk's inputs (the layout of ``kernels/siren_fwd.py``) and the
cotangent ``g`` (B, P, 8) of its output, each backward recomputes the
forward and returns the gradient of every operand except ``d_pad``:

    Cond-by-Concat: (dA (B, 8, H), db0 (B, 1, H), dWs (L, H, H), dbs (L, H),
                     dWf (H, 8), dbf (1, 8))
    FiLM:           (dA0 (B, 8, H), dWs (T-1, H, H), dbs (T, H), dWf (H, 8),
                     dbf (1, 8), dfreqs (B, 1, T*H), dphases (B, 1, T*H))

With ``weight_grads=False`` the weight gradients (dWs, dbs, dWf, dbf) are
None and not computed: FIT_LATENT trains the latents through a frozen
decoder and needs only the per-image gradients.

``siren_trunk_bwd_cuda`` / ``film_trunk_bwd_cuda`` launch the hand-written
kernel of ``csrc/siren_bwd.cu`` (CUDA tensors only) and count their calls in
``.launches``. ``siren_trunk_bwd_reference`` / ``film_trunk_bwd_reference``
are their plain PyTorch versions, written step by step like the TPU kernel:
with the bf16 trunk both operands of every product are rounded to bf16 (the
cotangents ``g`` and ``dz`` too) and summed in float32, which autograd of the
plain forward would not do.
"""

from __future__ import annotations

import ctypes
import math

import torch

from reni_tpu_torch.core.fastmath import sincos_fns
from reni_tpu_torch.kernels.siren_fwd import (
    C_PAD,
    K_PAD,
    ROW_PAD,
    SMEM_LIMIT,
    _cuda_operands,
    _f32,
    _matmul,
    _weights,
)

WARPS = 8  # csrc/siren_bwd.cu THREADS / 32
CTAS_PER_SM = 4  # CTAs the launch aims for per SM (one is resident at a time)


def tile_rows(trunk: str) -> int:
    """Pixel rows of one tile of the backward kernel."""
    return 16 if trunk == "bfloat16" else 8


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def image_values(film: bool, hidden: int, n_mm: int) -> int:
    """Per-image gradient values: dA | db0, or FiLM dA0 | dfreqs | dphases."""
    return (K_PAD + 2 * (n_mm + 1)) * hidden if film else (K_PAD + 1) * hidden


def bwd_smem_bytes(film: bool, trunk: str, hidden: int, n_mm: int) -> int:
    """Shared memory of one CTA of the backward kernel: every layer's
    activation and cos factor for one tile, the working cotangents, and the
    CTA's gradient sums (the ``layout`` of ``csrc/siren_bwd.cu``).
    ``n_mm`` is the number of H x H products (Cond-by-Concat L, FiLM T-1)."""
    bf16 = trunk == "bfloat16"
    tm, act, lda = tile_rows(trunk), (2 if bf16 else 4), hidden + ROW_PAD
    n_act = n_mm + 1
    n_bs = n_act if film else n_mm
    parts = (
        n_act * tm * lda * act,  # activations
        n_act * tm * hidden * 4,  # cos factors / FiLM pre-modulation
        tm * hidden * 4,  # dh
        tm * lda * act,  # dz
        tm * K_PAD * 4,  # direction tile
        tm * C_PAD * 4,  # cotangent tile
        image_values(film, hidden, n_mm) * 4,
        (n_bs * hidden + hidden * C_PAD + C_PAD) * 4,
    )
    staging = WARPS * 256 * 4 if bf16 else 0
    return sum(_align128(p) for p in parts) + staging


def bwd_unsupported_reason(
    hidden_features: int, n_mm: int, film: bool, trunk: str = "bfloat16"
) -> str | None:
    """Why the backward kernel cannot take this trunk (None = it can): one
    tile's activations and cos factors of every layer must fit in a CTA's
    shared memory."""
    smem = bwd_smem_bytes(film, trunk, hidden_features, n_mm)
    if smem > SMEM_LIMIT:
        return (
            f"the backward of a {n_mm + 1}-activation x {hidden_features} "
            f"trunk needs {smem} B of shared memory per CTA with the {trunk} "
            f"trunk (limit {SMEM_LIMIT})"
        )
    return None


# ---------------------------------------------------------------------------
# plain PyTorch backwards
# ---------------------------------------------------------------------------


def _rounded(x: torch.Tensor, trunk: str) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype) if trunk == "bfloat16" else x


def _pixel_dot(x: torch.Tensor, y: torch.Tensor, trunk: str) -> torch.Tensor:
    """sum over images and pixels of x^T y: (B, P, m), (B, P, n) -> (m, n)."""
    return torch.einsum("bpm,bpn->mn", _rounded(x, trunk), _rounded(y, trunk))


def _image_dot(d: torch.Tensor, y: torch.Tensor, trunk: str) -> torch.Tensor:
    """per-image d^T y: (B_d, P, 8), (B, P, H) -> (B, 8, H)."""
    d = d.expand(y.shape[0], *d.shape[1:])
    return torch.einsum("bpk,bph->bkh", _rounded(d, trunk), _rounded(y, trunk))


def siren_trunk_bwd_reference(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, weight_grads=True,
):
    """Plain version of the Cond-by-Concat backward kernel (``_bwd_kernel``)."""
    sincos = sincos_fns(fast_sine)
    h, c = sincos(omega0 * (_matmul(d_pad, a, trunk) + b0))
    hs, cs = [h], [c]
    for i in range(ws.shape[0]):
        h, c = sincos(omega_h * (_matmul(hs[-1], ws[i], trunk) + bs[i]))
        hs.append(h)
        cs.append(c)
    dws = dbs = dwf = dbf = None
    if weight_grads:
        dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
        dwf = _pixel_dot(hs[-1], g, trunk)
        dbf = g.sum((0, 1))[None]
    dh = _matmul(g, wf.transpose(0, 1), trunk)
    for i in reversed(range(ws.shape[0])):
        dz = dh * (omega_h * cs[i + 1])
        if weight_grads:
            dws[i] = _pixel_dot(hs[i], dz, trunk)
            dbs[i] = dz.sum((0, 1))
        dh = _matmul(dz, ws[i].transpose(0, 1), trunk)
    dz0 = dh * (omega0 * cs[0])
    da = _image_dot(d_pad, dz0, trunk)
    db0 = dz0.sum(1, keepdim=True)
    return da, db0, dws, dbs, dwf, dbf


def film_trunk_bwd_reference(
    d_pad, a0, ws, bs, wf, bf, fr, ph, g, *, trunk="bfloat16", fast_sine=False,
    weight_grads=True,
):
    """Plain version of the FiLM backward kernel (``_film_bwd_kernel``)."""
    sincos = sincos_fns(fast_sine)
    hidden, n_trunk = a0.shape[-1], bs.shape[0]
    pres, hs, coss = [], [], []
    for i in range(n_trunk):
        lo = i * hidden
        pre = (
            _matmul(d_pad, a0, trunk) if i == 0 else _matmul(hs[-1], ws[i - 1], trunk)
        ) + bs[i]
        h, c = sincos(fr[..., lo : lo + hidden] * pre + ph[..., lo : lo + hidden])
        pres.append(pre)
        hs.append(h)
        coss.append(c)
    dws = dbs = dwf = dbf = None
    if weight_grads:
        dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
        dwf = _pixel_dot(hs[-1], g, trunk)
        dbf = g.sum((0, 1))[None]
    dfr, dph = torch.zeros_like(fr), torch.zeros_like(ph)
    dh = _matmul(g, wf.transpose(0, 1), trunk)
    da0 = None
    for i in reversed(range(n_trunk)):
        lo = i * hidden
        fi = fr[..., lo : lo + hidden]
        dmod = dh * coss[i]  # d / d(f * pre + p)
        dfr[..., lo : lo + hidden] = (dmod * pres[i]).sum(1, keepdim=True)
        dph[..., lo : lo + hidden] = dmod.sum(1, keepdim=True)
        dz = dmod * fi
        if weight_grads:
            dbs[i] = dz.sum((0, 1))
        if i == 0:
            da0 = _image_dot(d_pad, dz, trunk)
        else:
            if weight_grads:
                dws[i - 1] = _pixel_dot(hs[i - 1], dz, trunk)
            dh = _matmul(dz, ws[i - 1].transpose(0, 1), trunk)
    return da0, dws, dbs, dwf, dbf, dfr, dph


# ---------------------------------------------------------------------------
# CUDA backwards
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "reni_siren_bwd": [
        _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _I, _I, _P,
    ],
    "reni_film_bwd": [
        _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "reni_bwd_smem_bytes": [_I, _I, _I, _I],
}


def library():
    """The built ``csrc/siren_bwd.cu`` (compiled at first call)."""
    from reni_tpu_torch.kernels import _build

    lib = _build.load("siren_bwd")
    if lib.reni_bwd_error_string.restype is not ctypes.c_char_p:
        for symbol, argtypes in _SIGNATURES.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.reni_bwd_error_string.argtypes = [ctypes.c_int]
        lib.reni_bwd_error_string.restype = ctypes.c_char_p
    return lib


def launch_grid(npix: int, batch: int, trunk: str, device) -> tuple[int, int]:
    """(tiles per CTA, CTAs per image): about CTAS_PER_SM CTAs per SM, each
    walking a run of consecutive tiles of one image."""
    n_tiles = math.ceil(npix / tile_rows(trunk))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = min(n_tiles, max(1, n_tiles * batch // (CTAS_PER_SM * sms)))
    return per, math.ceil(n_tiles / per)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _prepare(kind, film, trunk, d_pad, batch, hidden, n_mm, g, weights, weight_grads):
    """Validate the operands and allocate the outputs: (d, d batch stride,
    float32 cotangent, tiles per CTA, CTAs per image, partial-sum buffer,
    per-image output (B, n_img), weight gradients or Nones)."""
    d, d_bstride = _cuda_operands(kind, trunk, d_pad, batch, (*weights, g))
    npix = d.shape[1]
    if tuple(g.shape) != (batch, npix, C_PAD):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(batch, npix, C_PAD)}")
    reason = bwd_unsupported_reason(hidden, n_mm, film, trunk)
    if reason:
        raise ValueError(f"the {kind} CUDA kernel cannot take these operands: {reason}")
    dev = d.device
    tiles, chunks = launch_grid(npix, batch, trunk, dev)
    n_img = image_values(film, hidden, n_mm)
    part = torch.empty((batch, chunks, n_img), dtype=torch.float32, device=dev)
    out = torch.empty((batch, n_img), dtype=torch.float32, device=dev)
    ws, bs, wf, bf = weights[-4:]
    wgrads = (None,) * 4
    if weight_grads:
        wgrads = tuple(
            torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in (ws, bs, wf, bf)
        )
    return d, d_bstride, _f32(g), tiles, chunks, part, out, wgrads


def _check(err: int, lib, kind: str) -> None:
    if err != 0:
        msg = lib.reni_bwd_error_string(err).decode()
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err} ({msg})")


def siren_trunk_bwd_cuda(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, weight_grads=True,
):
    """Cond-by-Concat backward on the card (``csrc/siren_bwd.cu``); returns
    what ``siren_trunk_bwd_reference`` returns."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride, g, tiles, chunks, part, out, wgrads = _prepare(
        "siren_bwd", False, trunk, d_pad, batch, hidden, n_mm, g,
        (a, b0, ws, bs, wf, bf), weight_grads,
    )
    a, b0, bs = _f32(a), _f32(b0), _f32(bs)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.reni_siren_bwd(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), wf.data_ptr(), g.data_ptr(), part.data_ptr(),
            out.data_ptr(), *map(_ptr, wgrads), batch, d.shape[1], hidden, n_mm,
            tiles, chunks, float(omega0), float(omega_h), int(trunk == "bfloat16"),
            int(bool(fast_sine)), int(bool(weight_grads)), stream,
        )
    _check(err, lib, "siren_bwd")
    siren_trunk_bwd_cuda.launches += 1
    da = out[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    db0 = out[:, K_PAD * hidden :].view(batch, 1, hidden)
    return (da, db0, *wgrads)


siren_trunk_bwd_cuda.launches = 0


def film_trunk_bwd_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, g, *, trunk="bfloat16", fast_sine=False,
    weight_grads=True,
):
    """FiLM backward on the card (``csrc/siren_bwd.cu``); returns what
    ``film_trunk_bwd_reference`` returns."""
    batch, hidden, n_trunk = a0.shape[0], a0.shape[-1], bs.shape[0]
    d, d_bstride, g, tiles, chunks, part, out, wgrads = _prepare(
        "film_bwd", True, trunk, d_pad, batch, hidden, n_trunk - 1, g,
        (a0, fr, ph, ws, bs, wf, bf), weight_grads,
    )
    a0, bs, fr, ph = _f32(a0), _f32(bs), _f32(fr), _f32(ph)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.reni_film_bwd(
            d.data_ptr(), d_bstride, a0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wf.data_ptr(), fr.data_ptr(), ph.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), *map(_ptr, wgrads), batch, d.shape[1],
            hidden, n_trunk, tiles, chunks, int(trunk == "bfloat16"),
            int(bool(fast_sine)), int(bool(weight_grads)), stream,
        )
    _check(err, lib, "film_bwd")
    film_trunk_bwd_cuda.launches += 1
    th = n_trunk * hidden
    da0 = out[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    dfr = out[:, K_PAD * hidden : K_PAD * hidden + th].view(batch, 1, th)
    dph = out[:, K_PAD * hidden + th :].view(batch, 1, th)
    dws, dbs, dwf, dbf = wgrads
    return da0, dws, dbs, dwf, dbf, dfr, dph


film_trunk_bwd_cuda.launches = 0
