"""Anatomy probes of the Cond-by-Concat forward and backward kernels: the
ports of ``_fwd_kernel_variant`` and ``_bwd_kernel_variant`` of
``benchmarks/bwd_anatomy.py``.

A probe is a shipped kernel with one part taken out or rearranged, timed
beside the shipped kernel to see what that part costs
(``time_kernels.py --anatomy``). Nothing on a serving or training path calls
this module. Every variant but the interleaved forward is numerically wrong
on purpose; each is still a definite function, so each has a plain PyTorch
version here (``fwd_variant_reference``, ``bwd_variant_reference``) that the
kernel (``fwd_variant_cuda``, ``bwd_variant_cuda``; ``csrc/siren_anatomy.cu``,
its own library, so the shipped kernels' machine code is the same with or
without it) is held against on the card. Each wrapper counts its launches in
``.launches``; a combination that a shipped library already holds (the
kernel unchanged, the backward without weight gradients) is launched from
that library, not compiled twice.

Forward variants (operands and result of ``siren_trunk_reference``). Where
the shipped forward is the fused kernel (``siren_fwd.fwd_route`` gives
``"fused"``: the bf16 trunk at the Zoo's widths):

- ``transcendental=False``: every sine becomes ``0.8 * z`` (the fused
  kernel built with the linear stand-in);
- ``interleave=2``: the TPU probe works its tile as independent sub-tiles
  one after the other. Its counterpart here is the fused kernel with its two
  warpgroups in lock step (``siren_fwd.SCHED_LOCKSTEP``), so that no
  epilogue runs under a product; launched from the shipped library. Its
  results are the shipped forward's, bit for bit, which is the check;
- ``interleave=4`` has no counterpart in the fused design: it stays the
  row-tile kernel working each 64-row tile as 4 sub-tiles (a weight fragment
  read from L2 serves one row tile of 16 instead of 4), and gives the
  row-tile kernel's bits (``siren_trunk_cuda(..., route="tile")``).

Where the shipped forward is the row-tile kernel (the float32 trunk, other
widths), every variant is that kernel's: the linear stand-in, and each
64-row tile worked as 2 or 4 sub-tiles, with the shipped forward's bits.

Backward variants (operands of ``siren_trunk_bwd_reference``). Where the
shipped backward is the layer-major passes (``siren_step.pass_route``: the
bf16 trunk at a width that is a multiple of 64, up to 256; ``bwd_route``
gives ``"passes"``), each variant is built from the passes:

- the shipped backward (``bwd``) and ``weight_grads=False`` (``bwd_no_dw``:
  per-image gradients alone, no weight work) are ``siren_step._passes_bwd``,
  launched from the shipped library: their results are
  ``siren_trunk_bwd_cuda``'s, bit for bit, which is the check;
- ``transcendental=False``: (sin, cos) becomes ``(0.8 * z, 0.6 * z)`` in
  every pass (the fwd passes, the cotangent last pass, the bwd passes and
  the value of layer 0 that bwd pass 0 forms again), the same pass sequence
  built with the linear stand-in in ``csrc/siren_anatomy.cu``; with
  ``weight_grads=False`` too it is the skeleton ("mxu_only");
- ``accum=False``: the TPU probe writes its weight gradients in place of
  accumulating them across its sequential grid, which removes a
  read-modify-write between grid steps. The port has no such accumulation
  (its CTAs run concurrently): what it has in that place is the reduction
  after the passes. So here ``accum=False`` runs the passes with weight
  gradients and ``finish = 0`` (no ``reduce_slots``, no ``wgrad_bf16``), and
  returns the raw per-CTA slots and the scratch in the passes' own layout
  (``siren_step.StepPlan``): ``(part_img (B, chunks, 9H), part_w (B *
  chunks, n_w), sc_h (L, B * P, H), sc_dz (L, B * P, H))``, per CTA dA |
  db0, then mse (0) | dbs | dWf | dbf, and per pixel row the operands h_i and
  dz_i of the product that would form dWs_i. Its plain version takes the
  plan (``plan=``).

Where the shipped backward is the chain kernel (the float32 trunk, bf16
widths that are not a multiple of 64; ``bwd_route`` gives ``"chain"``),
every variant is that kernel's (``csrc/siren_bwd.cuh``): the shipped chain
kernel with and without weight gradients
(``siren_bwd.siren_bwd_chain_cuda``), the linear stand-in, and
``accum=False`` as the chain kernel with weight gradients alone, whose
slots (``part_w`` without the mse lanes) and scratch depend on the launch
grid ``(tiles per CTA, CTAs per image)``, which the plain version takes as
``grid``.

``l2_read_cuda`` reads a buffer that fits in L2 ``reps`` times over and sums
its 32-bit words (modulo 2^32; ``l2_read_reference``), so that its time gives
L2's read rate: the rate at which the fused forward's weight slabs can come.

``weight_grads_cuda`` runs that product alone on a given scratch (the
``wgrad_bf16`` / ``wgrad_f32`` kernel of ``csrc/siren_chain.cuh`` and, with
``reduce``, the sum of its split-K partials), so that it can be timed apart
from the passes: on the scratch that ``accum=False`` returns, which is the
shipped backward's; ``weight_grads_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from reni_tpu_torch.core.fastmath import sincos_fns
from reni_tpu_torch.kernels import siren_bwd, siren_fwd, siren_step
from reni_tpu_torch.kernels.siren_bwd import _rounded, tile_rows
from reni_tpu_torch.kernels.siren_fwd import (
    C_PAD,
    K_PAD,
    _check,
    _cuda_operands,
    _f32,
    _matmul,
    _weights,
)

SINE_LINEAR = 2  # csrc/siren_common.cuh; 0 is the exact sine, 1 the fast one
INTERLEAVES = (1, 2, 4)


def _sincos(transcendental: bool, fast_sine: bool):
    if transcendental:
        return sincos_fns(fast_sine)
    return lambda z: (z * 0.8, z * 0.6)


def _sine_mode(transcendental: bool, fast_sine: bool) -> int:
    return int(bool(fast_sine)) if transcendental else SINE_LINEAR


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def fwd_variant_reference(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16", fast_sine=False,
    transcendental=True, interleave=1,
):
    """Plain version of a forward variant -> (B, P, 8). The pixels are worked
    in ``interleave`` independent parts, as the TPU probe works its tile."""
    sincos = _sincos(transcendental, fast_sine)
    outs = []
    for part in d_pad.chunk(interleave, dim=1):
        h = sincos(omega0 * (_matmul(part, a, trunk) + b0))[0]
        for i in range(ws.shape[0]):
            h = sincos(omega_h * (_matmul(h, ws[i], trunk) + bs[i]))[0]
        outs.append(_matmul(h, wf, trunk) + bf)
    return torch.cat(outs, 1)


def _slots(x: torch.Tensor, rows: int, chunks: int) -> torch.Tensor:
    """(B, P, n) -> (B, chunks, rows, n): each CTA's pixel rows, zero rows
    past P."""
    x = torch.nn.functional.pad(x, (0, 0, 0, chunks * rows - x.shape[1]))
    return x.view(x.shape[0], chunks, rows, x.shape[-1])


def bwd_variant_reference(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16", fast_sine=False,
    transcendental=True, weight_grads=True, accum=True, grid=None, plan=None,
):
    """Plain version of a backward variant. With ``accum`` (or without weight
    gradients) -> what ``siren_trunk_bwd_reference`` returns; with
    ``accum=False`` -> the per-CTA slots and the scratch (module docstring).
    With a backward plan ``plan`` (``bwd_plan``; the route ``"passes"``) it
    runs the plain passes (``siren_step.passes_reference``, in their slot
    layout and with their rounding points); else the plain backward, and
    ``accum=False`` in the chain kernel's layout for the launch grid ``grid
    = (tiles per CTA, CTAs per image)``."""
    kw = dict(omega0=omega0, omega_h=omega_h, trunk=trunk)
    sincos = _sincos(transcendental, fast_sine)
    if plan is not None:
        plan = dataclasses.replace(plan, weight_grads=weight_grads)
        accum = accum or not weight_grads
        work = siren_step.passes_reference(
            plan, (d_pad, a, b0, ws, bs, wf, bf, g),
            dict(kw, fast_sine=fast_sine, sincos=sincos), sms=1, finish=None if accum else 0)
        if accum:
            return siren_step._results(plan, work)
        return work.part_img, work.part_w, work.sc_h, work.sc_dz
    hs, cs = siren_bwd.siren_forward_keep(
        d_pad, a, b0, ws, bs, fast_sine=fast_sine, sincos=sincos, **kw,
    )
    if accum or not weight_grads:
        return siren_bwd.siren_chain_bwd(d_pad, ws, bs, wf, hs, cs, g, weight_grads=weight_grads,
                                         **kw)
    dzs: list = []
    siren_bwd.siren_chain_bwd(d_pad, ws, bs, wf, hs, cs, g, weight_grads=False, dzs=dzs, **kw)
    dz0, dzs = dzs[0], dzs[1:]
    batch, npix, hidden = hs[0].shape
    rows, chunks = grid[0] * tile_rows(trunk), grid[1]
    if chunks * rows < npix:
        raise ValueError(f"grid {grid} covers {chunks * rows} of {npix} pixel rows")

    def slots(x):
        return _slots(x, rows, chunks)

    d = slots(d_pad.expand(batch, *d_pad.shape[1:]))
    da = torch.einsum("bcrk,bcrh->bckh", _rounded(d, trunk), _rounded(slots(dz0), trunk))
    part_img = torch.cat((da.flatten(2), slots(dz0).sum(2)), 2)
    dbs = torch.stack([slots(dz).sum(2) for dz in dzs], 2)  # (B, chunks, L, H)
    dwf = torch.einsum("bcrm,bcrn->bcmn", _rounded(slots(hs[-1]), trunk),
                       _rounded(slots(g), trunk))
    part_w = torch.cat((dbs.flatten(2), dwf.flatten(2), slots(g).sum(2)), 2)
    act = torch.bfloat16 if trunk == "bfloat16" else torch.float32
    sc_h = torch.stack([x.reshape(batch * npix, hidden) for x in hs[:-1]]).to(act)
    sc_dz = torch.stack([x.reshape(batch * npix, hidden) for x in dzs]).to(act)
    return part_img, part_w.flatten(0, 1), sc_h, sc_dz


def bwd_route(trunk: str, hidden: int, n_mm: int) -> str:
    """Which design the backward probes are built from: ``"passes"`` where the
    shipped backward is the layer-major passes (``siren_step.pass_route``),
    else ``"chain"``."""
    return "passes" if siren_step.pass_route(trunk, hidden, n_mm) else "chain"


def bwd_plan(d_pad, a, ws, sms: int) -> "siren_step.StepPlan":
    """The backward plan with weight gradients that the pass-route probes run
    for these operands on a card of ``sms`` SMs: the slot layout of
    ``accum=False``."""
    return siren_step.step_plan(False, a.shape[0], d_pad.shape[1], a.shape[-1], ws.shape[0],
                                sms, bwd=True)


def weight_grads_reference(sc_h: torch.Tensor, sc_dz: torch.Tensor) -> torch.Tensor:
    """dWs (L, H, H) = h_i^T dz_i over all rows of the scratches (L, rows, H),
    summed in float32."""
    return torch.einsum("lrm,lrn->lmn", sc_h.float(), sc_dz.float())


# ---------------------------------------------------------------------------
# CUDA versions
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "reni_anatomy_fwd": [_P, ctypes.c_longlong, *[_P] * 7, *[_I] * 4, _F, _F, _I, _I, _I, _P],
    "reni_anatomy_fwd_fused": [
        _P, ctypes.c_longlong, *[_P] * 7, *[_I] * 4, _F, _F, _I, _I, _I, _P,
    ],
    "reni_anatomy_bwd": [
        _P, ctypes.c_longlong, *[_P] * 14, *[_I] * 8, _F, _F, _I, _I, _I, _I, _P,
    ],
    "reni_anatomy_passes": siren_step._SIGNATURES["reni_siren_step_passes"],
    "reni_anatomy_wgrad": [_P, _P, _P, _P, ctypes.c_longlong, *[_I] * 6, _P],
    "reni_anatomy_l2_read": [_P, ctypes.c_longlong, _I, _P, _I, _P],
}
L2_READ_CTAS_PER_SM = 4


def library():
    """The built ``csrc/siren_anatomy.cu`` (compiled at first call)."""
    from reni_tpu_torch.kernels import _build

    lib = _build.load("siren_anatomy")
    if lib.reni_anatomy_error_string.restype is not ctypes.c_char_p:
        for symbol, argtypes in _SIGNATURES.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.reni_anatomy_error_string.argtypes = [ctypes.c_int]
        lib.reni_anatomy_error_string.restype = ctypes.c_char_p
        # what siren_step._pass_call takes of a library
        lib.source, lib.passes = "siren_anatomy", lib.reni_anatomy_passes
        lib.error_string = lib.reni_anatomy_error_string
    return lib


def fwd_variant_cuda(
    d_pad, a, b0, ws, bs, wf, bf, *, omega0, omega_h, trunk="bfloat16", fast_sine=False,
    transcendental=True, interleave=1,
):
    """A forward variant on the card; returns what ``fwd_variant_reference``
    returns. The linear stand-in is built with ``interleave=1`` only."""
    if interleave not in INTERLEAVES or (interleave != 1 and not transcendental):
        raise ValueError(
            f"no forward variant with interleave={interleave}, transcendental={transcendental}"
        )
    kw = dict(omega0=omega0, omega_h=omega_h, trunk=trunk, fast_sine=fast_sine)
    fused = siren_fwd.fwd_route(trunk, a.shape[-1], ws.shape[0]) == "fused"
    if transcendental and (interleave == 1 or (fused and interleave == 2)):
        sched = siren_fwd.SCHED_LOCKSTEP if interleave == 2 else None
        out = siren_fwd.siren_trunk_cuda(d_pad, a, b0, ws, bs, wf, bf, sched=sched, **kw)
        fwd_variant_cuda.launches += 1
        return out
    batch, hidden = a.shape[0], a.shape[-1]
    d, d_bstride = _cuda_operands("fwd_variant", trunk, d_pad, batch, (a, b0, ws, bs, wf, bf))
    a, b0, bs, bf = _f32(a), _f32(b0), _f32(bs), _f32(bf)
    wf = _weights(wf, trunk)
    npix, n_mm = d.shape[1], ws.shape[0]
    out = torch.empty((batch, npix, C_PAD), dtype=torch.float32, device=d.device)
    lib = library()
    head = (d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr())
    if fused and not transcendental:
        slabs, stages, sched, grid = siren_fwd._fused_args(ws, hidden, False, npix, batch,
                                                           d.device, None)
        fn = lib.reni_anatomy_fwd_fused
        args = (*head, slabs.data_ptr(), bs.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                out.data_ptr(), batch, npix, hidden, n_mm, float(omega0), float(omega_h),
                stages, sched, grid)
    else:
        ws = _weights(ws, trunk)
        fn = lib.reni_anatomy_fwd
        args = (*head, ws.data_ptr(), bs.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                out.data_ptr(), batch, npix, hidden, n_mm, float(omega0), float(omega_h),
                int(trunk == "bfloat16"), _sine_mode(transcendental, fast_sine), interleave)
    with torch.cuda.device(d.device):
        err = fn(*args, torch.cuda.current_stream(d.device).cuda_stream)
    _check(err, lib.reni_anatomy_error_string, "fwd_variant")
    fwd_variant_cuda.launches += 1
    return out


fwd_variant_cuda.launches = 0


def bwd_variant_cuda(
    d_pad, a, b0, ws, bs, wf, bf, g, *, omega0, omega_h, trunk="bfloat16", fast_sine=False,
    transcendental=True, weight_grads=True, accum=True,
):
    """A backward variant on the card, built from the design of ``bwd_route``;
    returns what ``bwd_variant_reference`` returns for the plan ``bwd_plan``
    (the passes) or the grid ``siren_bwd.launch_grid`` (the chain kernel)
    gives these shapes. Each call counts one in ``.launches`` and one in
    ``.routes`` under its design."""
    accum = accum or not weight_grads
    route = bwd_route(trunk, a.shape[-1], ws.shape[0])
    if route == "passes":
        out = _passes_variant((d_pad, a, b0, ws, bs, wf, bf), g,
                              dict(omega0=omega0, omega_h=omega_h, trunk=trunk,
                                   fast_sine=fast_sine),
                              transcendental, weight_grads, accum)
    elif transcendental and accum:  # the shipped chain kernel
        out = siren_bwd.siren_bwd_chain_cuda(
            d_pad, a, b0, ws, bs, wf, bf, g, omega0=omega0, omega_h=omega_h, trunk=trunk,
            fast_sine=fast_sine, weight_grads=weight_grads,
        )
    else:
        out = _chain_variant(d_pad, a, b0, ws, bs, wf, bf, g, omega0, omega_h, trunk,
                             fast_sine, transcendental, weight_grads, accum)
    bwd_variant_cuda.launches += 1
    bwd_variant_cuda.routes[route] += 1
    return out


def _passes_variant(ops, g, kw, transcendental, weight_grads, accum):
    """A backward variant on the passes: the shipped backward from the step
    library, or the same passes with the linear stand-in from this module's
    library, and with ``accum=False`` the passes alone (finish 0)."""
    if transcendental and accum:
        return siren_step._passes_bwd(False, ops, g, kw, weight_grads)
    d, d_bstride = siren_step._validate_passes(False, True, (*ops, g), kw)
    plan = siren_step.step_plan_cuda(False, (*ops, g), d.device, bwd=True,
                                     weight_grads=weight_grads)
    prep = siren_step.pass_operands(plan, (*ops, g), kw, d, d_bstride)
    lib = None
    if not transcendental:
        prep = dataclasses.replace(prep, flags=(SINE_LINEAR, *prep.flags[1:]))
        lib = library()
    work = siren_step.PassWork.for_plan(plan, "bfloat16", d.device)
    finish = siren_step._finish_flags(plan) if accum else 0
    siren_step._pass_call(plan, prep, work, 0, len(plan.passes), finish, lib=lib)
    if not accum:
        return work.part_img, work.part_w, work.sc_h, work.sc_dz
    return siren_step._results(plan, work)


def _chain_variant(d_pad, a, b0, ws, bs, wf, bf, g, omega0, omega_h, trunk, fast_sine,
                   transcendental, weight_grads, accum):
    """A backward variant of the chain kernel that the shipped library does
    not hold (the linear stand-in, or weight gradients without the
    reduction), from this module's library."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride, g, tiles, chunks, part, out, work = siren_bwd._prepare(
        "bwd_variant", False, trunk, d_pad, batch, hidden, n_mm, g, (a, b0, ws, bs, wf, bf),
        weight_grads,
    )
    pointers, wchunks = siren_bwd._work_args(work)
    a, b0, bs = _f32(a), _f32(b0), _f32(bs)
    ws, wf = _weights(ws, trunk), _weights(wf, trunk)
    lib = library()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.reni_anatomy_bwd(
            d.data_ptr(), d_bstride, a.data_ptr(), b0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wf.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), *pointers, batch,
            d.shape[1], hidden, n_mm, tiles, chunks, *wchunks, float(omega0), float(omega_h),
            int(trunk == "bfloat16"), _sine_mode(transcendental, fast_sine),
            int(bool(weight_grads)), int(bool(accum)), stream,
        )
    _check(err, lib.reni_anatomy_error_string, "bwd_variant")
    if not accum:
        return part, work.part_w, work.sc_h, work.sc_dz
    da = out[:, : K_PAD * hidden].view(batch, K_PAD, hidden)
    db0 = out[:, K_PAD * hidden :].view(batch, 1, hidden)
    if work is None:
        return da, db0, None, None, None, None
    return (da, db0, work.dws, *work.small_sums(n_mm, hidden))


bwd_variant_cuda.launches = 0
bwd_variant_cuda.routes = {"passes": 0, "chain": 0}


def weight_grads_cuda(sc_h: torch.Tensor, sc_dz: torch.Tensor, *, reduce: bool = True):
    """The training kernels' weight-gradient product alone, on the scratches
    (L, rows, H) a backward wrote (bf16 or float32; the passes' or a chain
    kernel's, which ``bwd_variant_cuda(..., accum=False)`` returns) -> dWs
    (L, H, H); with ``reduce=False`` the split-K partials (chunks, L, H, H),
    not summed."""
    trunk = "bfloat16" if sc_h.dtype == torch.bfloat16 else "float32"
    if not (sc_h.is_cuda and sc_dz.is_cuda):
        raise ValueError("weight_grads kernel operands must all be CUDA tensors")
    if sc_h.shape != sc_dz.shape or sc_h.dtype != sc_dz.dtype or sc_h.dim() != 3:
        raise ValueError(f"scratch shapes {tuple(sc_h.shape)} and {tuple(sc_dz.shape)}")
    n_mm, rows, hidden = sc_h.shape
    per, chunks = siren_bwd.wgrad_chunks(rows, hidden, n_mm, trunk, sc_h.device)
    f32 = dict(dtype=torch.float32, device=sc_h.device)
    part_dws = torch.empty((chunks, n_mm, hidden, hidden), **f32)
    dws = torch.empty((n_mm, hidden, hidden), **f32)
    sc_h, sc_dz = sc_h.contiguous(), sc_dz.contiguous()
    lib = library()
    with torch.cuda.device(sc_h.device):
        stream = torch.cuda.current_stream(sc_h.device).cuda_stream
        err = lib.reni_anatomy_wgrad(
            sc_h.data_ptr(), sc_dz.data_ptr(), part_dws.data_ptr(), dws.data_ptr(), rows, per,
            chunks, hidden, n_mm, int(trunk == "bfloat16"), int(bool(reduce)), stream,
        )
    _check(err, lib.reni_anatomy_error_string, "weight_grads")
    weight_grads_cuda.launches += 1
    return dws if reduce else part_dws


weight_grads_cuda.launches = 0


def l2_read_reference(buf: torch.Tensor, reps: int) -> torch.Tensor:
    """The sum of the 32-bit words of ``buf`` (uint8, a multiple of 16 bytes),
    ``reps`` times, modulo 2^32 -> (1,) int64."""
    words = buf.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((words.sum() * reps) % 2**32).reshape(1)


def l2_read_cuda(buf: torch.Tensor, reps: int) -> torch.Tensor:
    """``l2_read_reference`` on the card: every SM reads ``buf`` from L2
    ``reps`` times over (the time of a call gives L2's read rate)."""
    if not buf.is_cuda or buf.dtype != torch.uint8 or buf.numel() % 16 or not buf.is_contiguous():
        raise ValueError("l2_read takes a contiguous CUDA uint8 buffer of 16-byte pieces")
    sink = torch.zeros(1, dtype=torch.int32, device=buf.device)
    grid = L2_READ_CTAS_PER_SM * siren_fwd._sm_count(buf.device)
    lib = library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.reni_anatomy_l2_read(buf.data_ptr(), buf.numel(), reps, sink.data_ptr(), grid,
                                       stream)
    _check(err, lib.reni_anatomy_error_string, "l2_read")
    l2_read_cuda.launches += 1
    return sink.to(torch.int64) & 0xFFFFFFFF


l2_read_cuda.launches = 0
