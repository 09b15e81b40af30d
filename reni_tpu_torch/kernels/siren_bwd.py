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

``siren_trunk_bwd_cuda`` / ``film_trunk_bwd_cuda`` launch hand-written
kernels (CUDA tensors only; a failed build or launch raises, with no
fallback) and count their calls in ``.launches``, one per call. By
``siren_step.pass_design`` (the train steps' rule) a trunk runs, at any
depth, as layer-major passes with a last pass that reads ``g``
(``siren_step._passes_bwd``; built into ``csrc/siren_step.cu`` and
``csrc/film_step.cu``): the ``wgmma`` passes of ``csrc/step_passes.cuh``
(bf16 at widths that are a multiple of 64, up to 256) or the tiled passes
of ``csrc/tiled_passes.cuh`` (float32 at widths that are a multiple of 16,
bf16 at widths that are a multiple of 64 from 320, at any width; a FiLM
trunk of one layer at a bf16 width that is a multiple of 64 or a float32
one that is a multiple of 16). Other bf16 widths run the
chain kernel of
``csrc/siren_bwd.cu`` (template in ``csrc/siren_bwd.cuh``), which keeps one
tile of every layer in shared memory (``bwd_unsupported_reason``). A
differentiable decode on the passes' routes hands the scratch of its
forward passes to the backward (``bwd_from_handoff``), which then runs from
the last pass on. Every sum has a fixed order
(per-CTA slots added in slot order; dWs through a device scratch and a
split-K product, ``csrc/siren_chain.cuh``), so two calls on the same inputs
give the same bits. ``siren_trunk_bwd_reference`` /
``film_trunk_bwd_reference`` are their plain PyTorch versions, written step
by step like the TPU kernel: with the bf16 trunk both operands of every product are rounded to bf16 (the
cotangents ``g`` and ``dz`` too) and summed in float32, which autograd of the
plain forward would not do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from reni_tpu_torch.core.fastmath import sincos_fns
from reni_tpu_torch.kernels.siren_fwd import (
    C_PAD,
    K_PAD,
    ROW_PAD,
    SMEM_LIMIT,
    _check,
    _cuda_operands,
    _f32,
    _matmul,
    _weights,
)
from reni_tpu_torch.utils.graphs import counter

WARPS = 8  # csrc/siren_chain.cuh THREADS / 32
CTAS_PER_SM = 4  # CTAs the launch aims for per SM (one is resident at a time)
# the split-K weight-gradient product (csrc/siren_chain.cuh): float32 CTAs of
# a 128 x 128 output tile, about WGRAD_CTAS_PER_SM of them per SM; bf16 CTAs
# (one an SM) of a block of 128 rows by at most 256 columns over blocks of at
# most WGRAD_WINDOW_ROWS rows, which is all one tensor-core sum takes (each
# block's sum is then added to its chunk's slot in float32), at least one
# wave of the card and at most WGRAD_WAVES
WGRAD_CTAS_PER_SM = 6
WGRAD_F32_TILE = (128, 128)
WGRAD_BF16_ROWS, WGRAD_BF16_COLS = 128, 256
WGRAD_WINDOW_ROWS = 256 * 64
WGRAD_WAVES = 8


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
    """Why the backward kernels cannot take this trunk (None = they can).
    The passes (``siren_step.pass_route``: bf16 widths that are a multiple
    of 64 and float32 widths that are a multiple of 16, at any width) take
    any depth; on the chain kernel one tile's activations and cos factors of
    every layer must fit in a CTA's shared memory."""
    from reni_tpu_torch.kernels.siren_step import pass_route

    if pass_route(trunk, hidden_features, n_mm):
        return None
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


def siren_forward_keep(d_pad, a, b0, ws, bs, *, omega0, omega_h, trunk, fast_sine,
                       sincos=None):
    """The Cond-by-Concat forward with the joint sincos -> (activations
    [h_0..h_L], cos factors [c_0..c_L]), each (B, P, H). ``sincos`` replaces
    the joint sincos (the anatomy probes' linear stand-in)."""
    sincos = sincos or sincos_fns(fast_sine)
    h, c = sincos(omega0 * (_matmul(d_pad, a, trunk) + b0))
    hs, cs = [h], [c]
    for i in range(ws.shape[0]):
        h, c = sincos(omega_h * (_matmul(hs[-1], ws[i], trunk) + bs[i]))
        hs.append(h)
        cs.append(c)
    return hs, cs


def siren_chain_bwd(d_pad, ws, bs, wf, hs, cs, g, *, omega0, omega_h, trunk, weight_grads,
                    dzs=None):
    """The backward chain from the output cotangent ``g`` (B, P, 8) and the
    kept activations -> (dA, db0, dWs, dbs, dWf, dbf). A list ``dzs``
    receives the cotangents [dz0, dz_0..dz_{L-1}] of the pre-activations
    (``kernels/anatomy.py`` forms the kernel's per-CTA sums from them)."""
    dws = dbs = dwf = dbf = None
    if weight_grads:
        dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
        dwf = _pixel_dot(hs[-1], g, trunk)
        dbf = g.sum((0, 1))[None]
    dh = _matmul(g, wf.transpose(0, 1), trunk)
    for i in reversed(range(ws.shape[0])):
        dz = dh * (omega_h * cs[i + 1])
        if dzs is not None:
            dzs.insert(0, dz)
        if weight_grads:
            dws[i] = _pixel_dot(hs[i], dz, trunk)
            dbs[i] = dz.sum((0, 1))
        dh = _matmul(dz, ws[i].transpose(0, 1), trunk)
    dz0 = dh * (omega0 * cs[0])
    if dzs is not None:
        dzs.insert(0, dz0)
    da = _image_dot(d_pad, dz0, trunk)
    db0 = dz0.sum(1, keepdim=True)
    return da, db0, dws, dbs, dwf, dbf


def siren_trunk_bwd_reference(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, weight_grads=True,
):
    """Plain version of the Cond-by-Concat backward kernel (``_bwd_kernel``)."""
    hs, cs = siren_forward_keep(
        d_pad, a, b0, ws, bs, omega0=omega0, omega_h=omega_h, trunk=trunk, fast_sine=fast_sine
    )
    return siren_chain_bwd(
        d_pad, ws, bs, wf, hs, cs, g, omega0=omega0, omega_h=omega_h, trunk=trunk,
        weight_grads=weight_grads,
    )


def film_forward_keep(d_pad, a0, ws, bs, fr, ph, *, trunk, fast_sine):
    """The FiLM forward with the joint sincos -> (pre-modulation values
    [pre_0..pre_{T-1}], activations [h_i], cos factors [c_i]), each (B, P, H)."""
    sincos = sincos_fns(fast_sine)
    hidden = a0.shape[-1]
    pres, hs, coss = [], [], []
    for i in range(bs.shape[0]):
        lo = i * hidden
        pre = (
            _matmul(d_pad, a0, trunk) if i == 0 else _matmul(hs[-1], ws[i - 1], trunk)
        ) + bs[i]
        h, c = sincos(fr[..., lo : lo + hidden] * pre + ph[..., lo : lo + hidden])
        pres.append(pre)
        hs.append(h)
        coss.append(c)
    return pres, hs, coss


def film_chain_bwd(d_pad, ws, bs, wf, fr, pres, hs, coss, g, *, trunk, weight_grads):
    """The FiLM backward chain from the output cotangent ``g`` (B, P, 8) and
    the kept values -> (dA0, dWs, dbs, dWf, dbf, dfreqs, dphases)."""
    hidden = wf.shape[0]
    dws = dbs = dwf = dbf = None
    if weight_grads:
        dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
        dwf = _pixel_dot(hs[-1], g, trunk)
        dbf = g.sum((0, 1))[None]
    dfr, dph = torch.zeros_like(fr), torch.zeros_like(fr)
    dh = _matmul(g, wf.transpose(0, 1), trunk)
    da0 = None
    for i in reversed(range(bs.shape[0])):
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


def film_trunk_bwd_reference(
    d_pad, a0, ws, bs, wf, bf, fr, ph, g, *, trunk="bfloat16", fast_sine=False,
    weight_grads=True,
):
    """Plain version of the FiLM backward kernel (``_film_bwd_kernel``)."""
    pres, hs, coss = film_forward_keep(
        d_pad, a0, ws, bs, fr, ph, trunk=trunk, fast_sine=fast_sine
    )
    return film_chain_bwd(
        d_pad, ws, bs, wf, fr, pres, hs, coss, g, trunk=trunk, weight_grads=weight_grads
    )


# ---------------------------------------------------------------------------
# CUDA backwards
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "reni_siren_bwd": [
        _P, ctypes.c_longlong, *[_P] * 14, *[_I] * 8, ctypes.c_float, ctypes.c_float,
        _I, _I, _I, _P,
    ],
    "reni_film_bwd": [_P, ctypes.c_longlong, *[_P] * 15, *[_I] * 11, _P],
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


def _sms(device, sms: int | None) -> int:
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def tile_grid(npix: int, batch: int, rows: int, sms: int) -> tuple[int, int]:
    """(tiles per CTA, CTAs per image) for tiles of ``rows`` pixels on a card
    of ``sms`` SMs: about CTAS_PER_SM CTAs per SM, each walking a run of
    consecutive tiles of one image."""
    n_tiles = math.ceil(npix / rows)
    per = min(n_tiles, max(1, n_tiles * batch // (CTAS_PER_SM * sms)))
    return per, math.ceil(n_tiles / per)


def launch_grid(npix: int, batch: int, trunk: str, device) -> tuple[int, int]:
    """``tile_grid`` of the chain kernels' tiles on ``device``."""
    return tile_grid(npix, batch, tile_rows(trunk), _sms(device, None))


def wgrad_tile(trunk: str, hidden: int) -> tuple[int, int]:
    """The output block (rows, columns) of one CTA of the split-K
    weight-gradient product: float32 128 x 128; bf16 128 rows by the fewest
    blocks of at most 256 columns, as even as 64-column atoms allow
    (``csrc/siren_chain.cuh::wgrad_nb``)."""
    if trunk != "bfloat16":
        return WGRAD_F32_TILE
    blocks = math.ceil(hidden / WGRAD_BF16_COLS)
    return WGRAD_BF16_ROWS, 64 * math.ceil(math.ceil(hidden / blocks) / 64)


def wgrad_split(rows: int, hidden: int, n_mm: int, trunk: str, sms: int) -> int:
    """The chunks the split-K product cuts ``rows`` rows into (at most; whole
    64-row slabs may leave fewer) on a card of ``sms`` SMs. float32: about
    WGRAD_CTAS_PER_SM CTAs per SM over its (output tiles, chunks, layers)
    grid, whatever the rows. bf16, one CTA an SM: a chunk a block of
    WGRAD_WINDOW_ROWS rows, so that a CTA adds its tensor-core sums to its
    slot once; but at least one wave of CTAs and at most WGRAD_WAVES waves,
    which holds the partials to about WGRAD_WAVES x SMs output blocks of
    device memory (a chunk then takes several blocks). More rows never give
    fewer chunks."""
    tiles = math.prod(math.ceil(hidden / t) for t in wgrad_tile(trunk, hidden)) * max(1, n_mm)
    if trunk != "bfloat16":
        return max(1, WGRAD_CTAS_PER_SM * sms // tiles)
    fill, cap = max(1, sms // tiles), max(1, WGRAD_WAVES * sms // tiles)
    return min(cap, max(fill, math.ceil(rows / WGRAD_WINDOW_ROWS)))


def wgrad_chunks(rows: int, hidden: int, n_mm: int, trunk: str, device,
                 sms: int | None = None) -> tuple[int, int]:
    """(rows per block, chunks) of the split-K weight-gradient product, a
    function of the rows, the width, the depth and the SM count alone: the
    rows go in blocks of whole 64-row slabs (the bf16 kernel's K-slab), block
    b into chunk b % chunks, at most ``wgrad_split`` chunks. float32, and
    bf16 up to WGRAD_WINDOW_ROWS rows a chunk: one block a chunk; past that
    a bf16 chunk takes k blocks of at most WGRAD_WINDOW_ROWS rows (the last
    chunks k - 1)."""
    want = wgrad_split(rows, hidden, n_mm, trunk, _sms(device, sms))
    per = math.ceil(math.ceil(rows / want) / 64) * 64
    if trunk == "bfloat16" and per > WGRAD_WINDOW_ROWS:
        k = math.ceil(per / WGRAD_WINDOW_ROWS)
        per = math.ceil(math.ceil(rows / (k * want)) / 64) * 64
    return per, min(want, math.ceil(rows / per))


@dataclasses.dataclass
class WeightGradWork:
    """Work space and results of the weight gradients of one call: per-CTA
    slots and their sum ``out_w`` (small sums, ``n_w`` values), the (n_mm,
    rows, H) scratches of activations and cotangents in the trunk's dtype,
    the split-K partials and their sum ``dws`` (n_mm, H, H)."""

    part_w: torch.Tensor
    out_w: torch.Tensor
    sc_h: torch.Tensor
    sc_dz: torch.Tensor
    part_dws: torch.Tensor
    dws: torch.Tensor
    rows_per_chunk: int
    n_wchunks: int

    @classmethod
    def allocate(cls, trunk, n_mm, rows, hidden, n_ctas, n_w, device, sms=None):
        f32 = dict(dtype=torch.float32, device=device)
        act = torch.bfloat16 if trunk == "bfloat16" else torch.float32
        per, chunks = wgrad_chunks(rows, hidden, n_mm, trunk, device, sms)
        return cls(
            part_w=torch.empty((n_ctas, n_w), **f32),
            out_w=torch.empty((n_w,), **f32),
            sc_h=torch.empty((n_mm, rows, hidden), dtype=act, device=device),
            sc_dz=torch.empty((n_mm, rows, hidden), dtype=act, device=device),
            part_dws=torch.empty((chunks, n_mm, hidden, hidden), **f32),
            dws=torch.empty((n_mm, hidden, hidden), **f32),
            rows_per_chunk=per,
            n_wchunks=chunks,
        )

    def pointers(self) -> tuple:
        """The six buffers as the C interface takes them."""
        return tuple(
            t.data_ptr()
            for t in (self.part_w, self.out_w, self.sc_h, self.sc_dz, self.part_dws, self.dws)
        )

    def small_sums(self, n_bs: int, hidden: int, skip: int = 0):
        """(dbs (n_bs, H), dWf (H, 8), dbf (1, 8)) views of ``out_w`` past
        its first ``skip`` values."""
        o = self.out_w[skip:]
        dbs = o[: n_bs * hidden].view(n_bs, hidden)
        dwf = o[n_bs * hidden : n_bs * hidden + hidden * C_PAD].view(hidden, C_PAD)
        return dbs, dwf, o[-C_PAD:].view(1, C_PAD)


def _validate(kind, trunk, d_pad, batch, hidden, n_mm, film, g, weights):
    """Validate a backward's operands: (d, d batch stride)."""
    d, d_bstride = _cuda_operands(kind, trunk, d_pad, batch, (*weights, g))
    npix = d.shape[1]
    if tuple(g.shape) != (batch, npix, C_PAD):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(batch, npix, C_PAD)}")
    reason = bwd_unsupported_reason(hidden, n_mm, film, trunk)
    if reason:
        raise ValueError(f"the {kind} CUDA kernel cannot take these operands: {reason}")
    return d, d_bstride


def _prepare(kind, film, trunk, d_pad, batch, hidden, n_mm, g, weights, weight_grads):
    """Validate the operands and allocate the chain kernel's outputs: (d, d
    batch stride, float32 cotangent, tiles per CTA, CTAs per image,
    partial-sum buffer, per-image output (B, n_img), weight-gradient work
    space or None)."""
    d, d_bstride = _validate(kind, trunk, d_pad, batch, hidden, n_mm, film, g, weights)
    npix, dev = d.shape[1], d.device
    tiles, chunks = launch_grid(npix, batch, trunk, dev)
    n_img = image_values(film, hidden, n_mm)
    part = torch.empty((batch, chunks, n_img), dtype=torch.float32, device=dev)
    out = torch.empty((batch, n_img), dtype=torch.float32, device=dev)
    work = None
    if weight_grads:
        n_bs = n_mm + 1 if film else n_mm
        n_w = n_bs * hidden + hidden * C_PAD + C_PAD
        work = WeightGradWork.allocate(
            trunk, n_mm, batch * npix, hidden, batch * chunks, n_w, dev
        )
    return d, d_bstride, _f32(g), tiles, chunks, part, out, work


def _work_args(work: WeightGradWork | None) -> tuple[tuple, tuple]:
    """(the six pointers, (rows per chunk, chunks)) for the C interface."""
    if work is None:
        return (None,) * 6, (0, 0)
    return work.pointers(), (work.rows_per_chunk, work.n_wchunks)


def bwd_from_handoff(handoff, g) -> tuple:
    """The backward on the card from the scratch of a forward through the
    passes (``siren_step.passes_forward``, ``siren_step.Handoff``): the
    cotangent last pass and the bwd passes, without the forward again;
    counted as a call of ``siren_trunk_bwd_cuda`` / ``film_trunk_bwd_cuda``.
    Returns what ``siren_trunk_bwd_reference`` / ``film_trunk_bwd_reference``
    return."""
    from reni_tpu_torch.kernels import siren_step as ts

    out = ts.passes_bwd_handoff(handoff, g)
    (film_trunk_bwd_cuda if handoff.plan.film else siren_trunk_bwd_cuda).launches += 1
    return out


def siren_trunk_bwd_cuda(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, weight_grads=True,
):
    """Cond-by-Concat backward on the card: the passes (wgmma or tiled) or the
    chain kernel of ``csrc/siren_bwd.cu``, by ``siren_step.pass_design``; returns what
    ``siren_trunk_bwd_reference`` returns."""
    from reni_tpu_torch.kernels import siren_step as ts

    if ts.pass_route(trunk, a.shape[-1], ws.shape[0]):
        kw = dict(omega0=omega0, omega_h=omega_h, trunk=trunk, fast_sine=fast_sine)
        out = ts._passes_bwd(False, (d_pad, a, b0, ws, bs, wf, bf), g, kw, weight_grads)
    else:
        out = siren_bwd_chain_cuda(d_pad, a, b0, ws, bs, wf, bf, g, omega0=omega0,
                                   omega_h=omega_h, trunk=trunk, fast_sine=fast_sine,
                                   weight_grads=weight_grads)
    siren_trunk_bwd_cuda.launches += 1
    return out


siren_trunk_bwd_cuda.launches = 0
counter(siren_trunk_bwd_cuda, "launches")


def siren_bwd_chain_cuda(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16",
    fast_sine=False, weight_grads=True,
):
    """The Cond-by-Concat chain kernel of ``csrc/siren_bwd.cu`` (any trunk its
    shared memory takes; the anatomy probes' shipped backward); not
    counted."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride, g, tiles, chunks, part, out, work = _prepare(
        "siren_bwd", False, trunk, d_pad, batch, hidden, n_mm, g,
        (a, b0, ws, bs, wf, bf), weight_grads,
    )
    pointers, wchunks = _work_args(work)
    a, b0, bs = _f32(a), _f32(b0), _f32(bs)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.reni_siren_bwd(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), wf.data_ptr(), g.data_ptr(), part.data_ptr(),
            out.data_ptr(), *pointers, batch, d.shape[1], hidden, n_mm,
            tiles, chunks, *wchunks, float(omega0), float(omega_h), int(trunk == "bfloat16"),
            int(bool(fast_sine)), int(bool(weight_grads)), stream,
        )
    _check(err, lib.reni_bwd_error_string, "siren_bwd")
    da = out[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    db0 = out[:, K_PAD * hidden :].view(batch, 1, hidden)
    if work is None:
        return da, db0, None, None, None, None
    return (da, db0, work.dws, *work.small_sums(n_mm, hidden))


def film_trunk_bwd_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, g, *, trunk="bfloat16", fast_sine=False,
    weight_grads=True,
):
    """FiLM backward on the card: the passes (wgmma or tiled) or the chain
    kernel of ``csrc/siren_bwd.cu``, by ``siren_step.pass_design``; returns what
    ``film_trunk_bwd_reference`` returns."""
    from reni_tpu_torch.kernels import siren_step as ts

    if ts.pass_route(trunk, a0.shape[-1], bs.shape[0] - 1):
        kw = dict(trunk=trunk, fast_sine=fast_sine)
        out = ts._passes_bwd(True, (d_pad, a0, ws, bs, wf, bf, fr, ph), g, kw, weight_grads)
    else:
        out = film_bwd_chain_cuda(d_pad, a0, ws, bs, wf, bf, fr, ph, g, trunk=trunk,
                                  fast_sine=fast_sine, weight_grads=weight_grads)
    film_trunk_bwd_cuda.launches += 1
    return out


film_trunk_bwd_cuda.launches = 0
counter(film_trunk_bwd_cuda, "launches")


def film_bwd_chain_cuda(
    d_pad, a0, ws, bs, wf, bf, fr, ph, g, *, trunk="bfloat16", fast_sine=False,
    weight_grads=True,
):
    """The FiLM chain kernel of ``csrc/siren_bwd.cu``; not counted."""
    batch, hidden, n_trunk = a0.shape[0], a0.shape[-1], bs.shape[0]
    d, d_bstride, g, tiles, chunks, part, out, work = _prepare(
        "film_bwd", True, trunk, d_pad, batch, hidden, n_trunk - 1, g,
        (a0, fr, ph, ws, bs, wf, bf), weight_grads,
    )
    pointers, wchunks = _work_args(work)
    a0, bs, fr, ph = _f32(a0), _f32(bs), _f32(fr), _f32(ph)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.reni_film_bwd(
            d.data_ptr(), d_bstride, a0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wf.data_ptr(), fr.data_ptr(), ph.data_ptr(), g.data_ptr(),
            part.data_ptr(), out.data_ptr(), *pointers, batch, d.shape[1],
            hidden, n_trunk, tiles, chunks, *wchunks, int(trunk == "bfloat16"),
            int(bool(fast_sine)), int(bool(weight_grads)), stream,
        )
    _check(err, lib.reni_bwd_error_string, "film_bwd")
    th = n_trunk * hidden
    da0 = out[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    dfr = out[:, K_PAD * hidden : K_PAD * hidden + th].view(batch, 1, th)
    dph = out[:, K_PAD * hidden + th :].view(batch, 1, th)
    if work is None:
        return da0, None, None, None, None, dfr, dph
    dbs, dwf, dbf = work.small_sums(n_trunk, hidden)
    return da0, work.dws, dbs, dwf, dbf, dfr, dph
