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
``csrc/siren_step.cu`` / ``csrc/film_step.cu`` (CUDA tensors only; a failed
build or launch raises) and count their calls in ``.launches``; two calls on
the same inputs give the same bits. By ``pass_route`` a step runs either as
layer-major ``wgmma`` passes over 128-row tiles (``csrc/step_passes.cuh``; the
bf16 trunk at widths that are a multiple of 64, up to 256) or as the chain
kernel (``csrc/siren_step.cuh``; the float32 trunk, other bf16 widths, a FiLM
trunk of one layer). The same passes, with a last pass that reads an output
cotangent in place of the loss, are the backward of ``kernels/siren_bwd.py``
on that route (``StepPlan(bwd=True)``, ``_passes_bwd``); a differentiable
forward on that route runs the fwd passes and a last pass that writes the
output, and hands their scratch to the backward (``passes_forward``,
``passes_bwd_handoff``).
``siren_step_reference`` / ``film_step_reference`` are their plain PyTorch
versions, step by step like the TPU kernels with their bf16 rounding;
``step_pass_reference`` is the plain version of one pass, in the passes' own
scratch and slot layout (``StepPlan``, ``PassWork``), which ``step_pass_cuda``
runs on the card.

The passes keep h, dz and the kept values of every row in device memory
(about 9 KB a row at 5 x 256). A call whose scratch the caching allocator
refuses takes a budget (the card's free memory less ``MEM_MARGIN``) and runs
its images in groups, one after another, each into its own rows of the
per-CTA slots (``StepPlan.groups``): the per-image results and the loss keep
the bits of one call, and dWs sums the groups' products in group order.
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
import dataclasses
import math

import torch

from reni_tpu_torch.core.fastmath import sincos_fns
from reni_tpu_torch.kernels import siren_bwd
from reni_tpu_torch.kernels.siren_bwd import (
    WARPS,
    WeightGradWork,
    _align128,
    _pixel_dot,
    _rounded,
    tile_rows,
    wgrad_chunks,
)
from reni_tpu_torch.kernels.siren_fwd import (
    C_PAD,
    K_PAD,
    ROW_PAD,
    SMEM_LIMIT,
    _check,
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


PASS_ROWS = 128  # rows of one tile of the layer-major passes (csrc/step_passes.cuh TILE)
PASS_WIDTH = 64  # the passes take widths that are a multiple of this (one wgmma column block)
# device memory a grouped call leaves free beside its pass scratch: the
# operands' casts, the split-K partials of dWs (52 MB at 5 x 256 on 132 SMs)
# and the allocator's rounding
MEM_MARGIN = 1 << 30
FINISH_IMG, FINISH_W, FINISH_DWS = 1, 2, 4  # csrc/step_passes.cuh FINISH_*


def pass_route(trunk: str, hidden: int, n_mm: int) -> bool:
    """The routing rule between the layer-major wgmma passes
    (``csrc/step_passes.cuh``) and the chain kernels, for the train steps and
    the backward alike. The passes take the bf16 trunk at a width that is a
    multiple of 64 with at least one H x H product, where one layer's
    weights and a 128-row tile fit in a CTA's shared memory (H <= 256); the
    chain kernels (``csrc/siren_step.cuh``, ``csrc/siren_bwd.cuh``) take the
    float32 trunk, other bf16 widths and a FiLM trunk of one layer (no H x H
    product). The rule is by dtype and shape only: a failed build or launch
    raises on either route."""
    return (trunk == "bfloat16" and hidden % PASS_WIDTH == 0 and n_mm >= 1
            and pass_smem_bytes(hidden) <= SMEM_LIMIT)


def pass_smem_bytes(hidden: int) -> int:
    """Shared memory of one CTA of any pass (the ``pass_layout`` of
    ``csrc/step_passes.cuh``): one layer's weights and one 128-row input tile
    in bf16, per-warp column sums (or a tile's g), the layer's vectors, the
    directions, the final or first-layer weight in float32, the output
    cotangent, the loss and dbf partials, and 1 KB to align the base to the
    128-byte swizzle's atom."""
    parts = (
        PASS_ROWS * hidden * 2 + hidden * hidden * 2,  # input tile, weights
        _align128(max(WARPS * hidden, PASS_ROWS * C_PAD) * 4),
        _align128(4 * hidden * 4),
        _align128(PASS_ROWS * K_PAD * 4),
        _align128(K_PAD * hidden * 4),
        _align128(PASS_ROWS * C_PAD * 4),
        _align128(2 * C_PAD * 4),
    )
    return sum(parts) + 1024


def chain_smem_bytes(trunk: str, hidden: int, n_mm: int, film: bool = False) -> int:
    """Shared memory of one CTA of the chain kernel (the ``layout`` of
    ``csrc/siren_step.cuh``): what the backward kernel keeps, every layer of
    a tile, plus a target, a pixel-weight and a loss tile and the loss
    partials. ``n_mm`` is the number of H x H products (Cond-by-Concat L,
    FiLM T - 1)."""
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


def step_smem_bytes(trunk: str, hidden: int, n_mm: int, film: bool = False) -> int:
    """Shared memory of one CTA of the step, by ``pass_route``: the passes'
    ``pass_smem_bytes`` (no depth in it: activations live in device memory)
    or ``chain_smem_bytes``."""
    if pass_route(trunk, hidden, n_mm):
        return pass_smem_bytes(hidden)
    return chain_smem_bytes(trunk, hidden, n_mm, film)


def film_step_smem_bytes(trunk: str, hidden: int, n_mm: int) -> int:
    """``step_smem_bytes`` of the FiLM step (``n_mm`` = T - 1)."""
    return step_smem_bytes(trunk, hidden, n_mm, film=True)


def step_unsupported_reason(
    hidden_features: int, hidden_layers: int, trunk: str = "bfloat16", film: bool = False
) -> str | None:
    """Why the step cannot take this trunk (None = it can). The
    Cond-by-Concat step needs one hidden layer at least, the FiLM step one
    trunk layer; a CTA's shared memory must hold what its route keeps: for
    the passes one layer's weights and a 128-row tile (H <= 256 in bf16, any
    depth), for the chain kernel one tile of every layer."""
    if hidden_layers < 1:
        what = "trunk layer" if film else "hidden layer"
        return f"hidden_layers={hidden_layers}: the train-step kernel needs a {what}"
    n_mm = hidden_layers - 1 if film else hidden_layers
    smem = step_smem_bytes(trunk, hidden_features, n_mm, film)
    if smem > SMEM_LIMIT:
        what = ("one layer's weights and a 128-row tile" if pass_route(trunk, hidden_features, n_mm)
                else "one tile of every layer")
        return (
            f"the {'FiLM ' if film else ''}train step of a {hidden_layers} x {hidden_features} "
            f"trunk needs {smem} B of shared memory per CTA with the {trunk} trunk for {what} "
            f"(limit {SMEM_LIMIT})"
        )
    return None


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _loss_cotangent(o, tgt, sw, bm, out_act, gscale, rows=False):
    """(mse_row (1, 8), g (B, P, 8)): the loss partials of the output ``o``
    and the cotangent of ``o`` under the scaled loss (``rows``: the loss
    terms (B, P, 8) in place of their sum)."""
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
    mse_row = rs * r if rows else (rs * r).sum((0, 1))[None]
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
# the layer-major passes: plan and plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The pass plan of one call (``csrc/step_passes.cuh``): a grid of
    (``chunks`` per image, ``batch``) CTAs, each walking ``tiles_per_cta``
    consecutive 128-row tiles of one image, and ``2 n_mm`` passes:
    ``("fwd", j)`` for products 0..n_mm-2, ``("last", n_mm - 1)``, then
    ``("bwd", j)`` from n_mm - 1 down to 0. A train step (``bwd=False``)
    forms the output cotangent from the loss in its last pass; a backward
    (``bwd=True``) reads it, and without ``weight_grads`` forms the
    per-image gradients alone. A differentiable forward runs a backward
    plan's passes up to its last one in the output mode and hands the
    scratch to the backward (``passes_forward``)."""

    film: bool
    batch: int
    npix: int
    hidden: int
    n_mm: int
    tiles_per_cta: int
    chunks: int
    bwd: bool = False
    weight_grads: bool = True

    @property
    def rows(self) -> int:
        return self.batch * self.npix

    @property
    def n_keep(self) -> int:
        """Layers whose kept value (cos factor / pre-modulation) is stored."""
        return self.n_mm - 1

    @property
    def n_img(self) -> int:
        return siren_bwd.image_values(self.film, self.hidden, self.n_mm)

    @property
    def n_w(self) -> int:
        return weight_values(self.hidden, self.n_mm, self.film)

    @property
    def passes(self) -> tuple:
        n = self.n_mm
        return (*(("fwd", j) for j in range(n - 1)), ("last", n - 1),
                *(("bwd", j) for j in reversed(range(n))))

    def scratch_shapes(self) -> dict:
        """Shapes of the device scratch: sc_h and sc_dz in bf16, sc_keep in
        float32, the per-image and per-CTA slots in float32."""
        R, H = self.rows, self.hidden
        return {"sc_h": (self.n_mm, R, H), "sc_keep": (self.n_keep, R, H),
                "sc_dz": (self.n_mm, R, H), "part_img": (self.batch, self.chunks, self.n_img),
                "part_w": (self.batch * self.chunks, self.n_w)}

    @property
    def row_bytes(self) -> int:
        """Scratch bytes per row: sc_h and sc_dz (bf16), sc_keep (float32)."""
        return self.hidden * (2 * 2 * self.n_mm + 4 * self.n_keep)

    @property
    def scratch_bytes(self) -> int:
        """Device memory of one call's scratch and slots (``scratch_shapes``
        and the slots' sums); the split-K partials of dWs sit in
        ``MEM_MARGIN``."""
        slots = self.batch * self.chunks * (self.n_img + self.n_w)
        return self.rows * self.row_bytes + 4 * (slots + self.batch * self.n_img + self.n_w)

    def groups(self, budget: int) -> tuple:
        """The image ranges [g0, g1) a call runs one after another under a
        device-memory budget of ``budget`` bytes: all images at once when
        ``scratch_bytes`` fits, else as few groups as fit, of one size but
        the last, at least one image each. Every group keeps this plan's
        grid (``tiles_per_cta``, ``chunks``), so each per-CTA slot holds what
        it holds in one call."""
        if self.scratch_bytes <= budget:
            return ((0, self.batch),)
        fixed = self.scratch_bytes - self.rows * self.row_bytes
        fit = max(1, (budget - fixed) // (self.npix * self.row_bytes))
        size = math.ceil(self.batch / math.ceil(self.batch / fit))
        return tuple((g0, min(g0 + size, self.batch)) for g0 in range(0, self.batch, size))

    def pass_cost(self, k: int) -> tuple[float, int]:
        """(FLOP, bytes) of pass k: bytes of each operand read once and each
        result written once (directions, targets, pixel weights and the
        output cotangent as the kernel reads them, 8 float32 lanes), weights
        once. Without weight gradients h_0 is not stored and dWf not formed."""
        kind, j = self.passes[k]
        R, H = self.rows, self.hidden
        flops = 2.0 * R * H * H
        nbytes = 2 * H * H
        if kind != "bwd":
            first = j == 0
            h0 = 2 * H if self.weight_grads else 0
            nbytes += R * ((K_PAD * 4 + h0) if first else 2 * H)  # input (and h_0 out)
            flops += 2.0 * R * K_PAD * H if first else 0.0
        if kind == "fwd":
            nbytes += R * (2 * H + 4 * H)  # h and the kept value out
        elif kind == "last" and self.bwd:
            nbytes += R * (C_PAD * 4 + 2 * H) + H * C_PAD * 2  # g in; dz out; Wf
            flops += (2 if self.weight_grads else 1) * 2.0 * R * H * C_PAD  # g Wf^T (, dWf)
        elif kind == "last":
            nbytes += R * (2 * C_PAD * 4 + 2 * H) + H * C_PAD * 2  # tgt, sw in; dz out; Wf
            flops += 3 * 2.0 * R * H * C_PAD  # final layer, dWf, g Wf^T
        else:
            nbytes += R * 2 * H  # dz in
            if j > 0:
                nbytes += R * (4 * H + 2 * H)  # kept value in, dz out
            else:
                nbytes += R * K_PAD * 4
                flops += 2 * 2.0 * R * K_PAD * H  # layer 0 again, d^T dz0
        return flops, nbytes

    def wgrad_cost(self) -> tuple[float, int]:
        """(FLOP, bytes) of dWs = h^T dz over the scratch (none without
        weight gradients)."""
        if not self.weight_grads:
            return 0.0, 0
        R, H = self.rows, self.hidden
        return 2.0 * self.n_mm * R * H * H, self.n_mm * (R * 4 * H + H * H * 4)


def pass_grid(npix: int, batch: int, sms: int) -> tuple[int, int]:
    """(tiles per CTA, CTAs per image) of the passes on a card of ``sms``
    SMs: 128-row tiles, the grid rule of ``siren_bwd.tile_grid``."""
    return siren_bwd.tile_grid(npix, batch, PASS_ROWS, sms)


def step_plan(film: bool, batch: int, npix: int, hidden: int, n_mm: int, sms: int,
              bwd: bool = False, weight_grads: bool = True) -> StepPlan:
    tiles, chunks = pass_grid(npix, batch, sms)
    return StepPlan(film, batch, npix, hidden, n_mm, tiles, chunks, bwd, weight_grads)


@dataclasses.dataclass
class PassWork(WeightGradWork):
    """``WeightGradWork`` plus what the passes add: the kept values' scratch
    ``sc_keep`` (n_mm - 1, rows, H) float32, the per-image slots
    ``part_img`` (B, chunks, n_img) and their sum ``out_img``. Without weight
    gradients ``part_dws`` and ``dws`` are empty."""

    sc_keep: torch.Tensor
    part_img: torch.Tensor
    out_img: torch.Tensor

    @classmethod
    def for_plan(cls, plan: StepPlan, trunk: str, device, sms: int | None = None,
                 images: int | None = None):
        """The work space of ``plan``: the slots for the whole batch, the
        scratch (and dWs partials) for ``images`` images, all of them by
        default (a group's size in a grouped call)."""
        rows = (plan.batch if images is None else images) * plan.npix
        n_mm, H = plan.n_mm, plan.hidden
        f32 = dict(dtype=torch.float32, device=device)
        act = dict(dtype=torch.bfloat16 if trunk == "bfloat16" else torch.float32, device=device)
        per, chunks = (wgrad_chunks(rows, H, n_mm, trunk, device, sms) if plan.weight_grads
                       else (0, 0))
        return cls(part_w=torch.empty((plan.batch * plan.chunks, plan.n_w), **f32),
                   out_w=torch.empty((plan.n_w,), **f32),
                   sc_h=torch.empty((n_mm, rows, H), **act),
                   sc_dz=torch.empty((n_mm, rows, H), **act),
                   part_dws=torch.empty((chunks, n_mm, H, H), **f32),
                   dws=torch.empty((n_mm if plan.weight_grads else 0, H, H), **f32),
                   rows_per_chunk=per, n_wchunks=chunks,
                   sc_keep=torch.empty((plan.n_keep, rows, H), **f32),
                   part_img=torch.empty((plan.batch, plan.chunks, plan.n_img), **f32),
                   out_img=torch.empty((plan.batch, plan.n_img), **f32))

    def group(self, plan: StepPlan, g0: int, g1: int, dws: torch.Tensor, trunk: str,
              sms: int | None = None) -> "PassWork":
        """The work space of images [g0, g1) of a grouped call: their rows
        of the slots, the scratch laid out for g1 - g0 images (as the kernels
        index it, from the front of this one's) and their own dWs ``dws``."""
        rows = (g1 - g0) * plan.npix

        def front(t):
            n, _, H = t.shape
            return t.view(-1)[: n * rows * H].view(n, rows, H)

        per, chunks = ((0, 0) if not plan.weight_grads else
                       wgrad_chunks(rows, plan.hidden, plan.n_mm, trunk, dws.device, sms))
        assert chunks <= self.part_dws.shape[0]
        c = plan.chunks
        return dataclasses.replace(
            self, part_w=self.part_w[g0 * c : g1 * c], part_img=self.part_img[g0:g1],
            out_img=self.out_img[g0:g1], sc_h=front(self.sc_h), sc_dz=front(self.sc_dz),
            sc_keep=front(self.sc_keep), dws=dws, rows_per_chunk=per, n_wchunks=chunks)

    def clone(self) -> "PassWork":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def pass_outputs(plan: StepPlan, k: int, work: PassWork) -> dict:
    """Views of what pass k writes: the scratch rows and slot columns."""
    kind, j = plan.passes[k]
    H, T = plan.hidden, plan.n_mm + 1
    img, w = work.part_img, work.part_w
    out = {}
    if kind == "fwd":
        out["sc_h"] = work.sc_h[j + 1]
        out["sc_keep"] = work.sc_keep[j]
    if kind != "bwd" and j == 0 and plan.weight_grads:
        out["sc_h0"] = work.sc_h[0]
    layer = j + 1 if plan.film else j  # the bias row of the dz this pass forms
    if kind == "last":
        out["sc_dz"] = work.sc_dz[j]
        if plan.weight_grads:
            out["mse"] = w[:, :C_PAD]
            out["dbs"] = w[:, C_PAD + layer * H : C_PAD + (layer + 1) * H]
            out["dwf_dbf"] = w[:, -(H * C_PAD + C_PAD):]
    if kind == "bwd":
        layer = j if plan.film else j - 1
        if j > 0:
            out["sc_dz"] = work.sc_dz[j - 1]
        if layer >= 0 and plan.weight_grads:
            out["dbs"] = w[:, C_PAD + layer * H : C_PAD + (layer + 1) * H]
        if j == 0:
            out["dA"] = img[..., : K_PAD * H]
            if not plan.film:
                out["db0"] = img[..., K_PAD * H :]
    if plan.film and kind != "fwd":
        out["dfreqs"] = img[..., (K_PAD + layer) * H : (K_PAD + layer + 1) * H]
        out["dphases"] = img[..., (K_PAD + T + layer) * H : (K_PAD + T + layer + 1) * H]
    return out


def _step_operands(film, ops, bwd=False):
    """The operands of a step (the trunk's, then tgt, sw, bm) or of a
    backward (the trunk's, then the output cotangent g) by name."""
    trunk = (("d", "a", "ws", "bs", "wf", "bf", "fr", "ph") if film
             else ("d", "a", "b0", "ws", "bs", "wf", "bf"))
    return dict(zip(trunk + (("g",) if bwd else ("tgt", "sw", "bm")), ops))


def _cta_rows(x: torch.Tensor, plan: StepPlan) -> torch.Tensor:
    """(B, P, ...) -> (B, chunks, rows of a CTA, ...), zero past P."""
    span = plan.tiles_per_cta * PASS_ROWS
    pad = plan.chunks * span - x.shape[1]
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.reshape(x.shape[0], plan.chunks, span, *x.shape[2:])


def _cta_sums(x: torch.Tensor, plan: StepPlan) -> torch.Tensor:
    """Per-CTA sums over rows: (B, P, n) -> (B, chunks, n)."""
    return _cta_rows(x, plan).sum(2)


def _sincos(kw):
    """The (sin, cos) pair of the plain passes: ``kw["sincos"]`` where given
    (the anatomy probes' linear stand-in), else the trunk's exact or fast
    sine."""
    return kw.get("sincos") or sincos_fns(kw["fast_sine"])


def _layer0(plan, o, kw):
    """Layer 0 of the tile rows: (h_0, kept value, cos factor), each (B, P, H)."""
    sincos = _sincos(kw)
    z = _matmul(o["d"], o["a"], kw["trunk"])
    if plan.film:
        H = plan.hidden
        pre = z + o["bs"][0]
        h, c = sincos(o["fr"][..., :H] * pre + o["ph"][..., :H])
        return h, pre, c
    h, c = sincos(kw["omega0"] * (z + o["b0"]))
    return h, c, c


def _layer(plan, o, kw, z, layer):
    """Layer ``layer`` >= 1 from its product z: (h, kept value, cos factor)."""
    sincos = _sincos(kw)
    if plan.film:
        lo, hi = layer * plan.hidden, (layer + 1) * plan.hidden
        pre = z + o["bs"][layer]
        h, c = sincos(o["fr"][..., lo:hi] * pre + o["ph"][..., lo:hi])
        return h, pre, c
    h, c = sincos(kw["omega_h"] * (z + o["bs"][layer - 1]))
    return h, c, c


def _scratch(t: torch.Tensor, plan: StepPlan) -> torch.Tensor:
    """(n, rows, H) scratch -> (n, B, P, H) view."""
    return t.view(t.shape[0], plan.batch, plan.npix, plan.hidden)


def _film_sums(plan, work, layer, dmod, pre, f):
    """FiLM's per-CTA modulation sums of ``layer``: dfreqs, dphases and
    (with weight gradients) dbs."""
    H, T = plan.hidden, plan.n_mm + 1
    img, w = work.part_img, work.part_w.view(plan.batch, plan.chunks, -1)
    img[..., (K_PAD + layer) * H : (K_PAD + layer + 1) * H] = _cta_sums(dmod * pre, plan)
    img[..., (K_PAD + T + layer) * H : (K_PAD + T + layer + 1) * H] = _cta_sums(dmod, plan)
    if plan.weight_grads:
        w[..., C_PAD + layer * H : C_PAD + (layer + 1) * H] = _cta_sums(dmod * f, plan)


def step_pass_reference(plan: StepPlan, k: int, ops, kw, work: PassWork) -> None:
    """Plain version of pass k of ``csrc/step_passes.cuh``: reads and writes
    ``work`` in the kernel's layout, with its rounding points (both operands
    of every product rounded to bf16 by ``_matmul``, h and dz stored in the
    trunk's dtype, kept values and every sum in float32). ``ops`` and ``kw``
    as for ``siren_step_reference`` / ``film_step_reference``, or for a
    backward plan as for ``siren_trunk_bwd_reference`` /
    ``film_trunk_bwd_reference`` (the trunk's operands and g): its last pass
    takes g in place of the loss, and without weight gradients no pass
    writes h_0 or a weight slot. ``kw["sincos"]``, where given, takes the
    place of the sine (the anatomy probes' linear stand-in)."""
    kind, j = plan.passes[k]
    o, trunk, H = _step_operands(plan.film, ops, plan.bwd), kw["trunk"], plan.hidden
    sc_h, sc_keep, sc_dz = (_scratch(t, plan) for t in (work.sc_h, work.sc_keep, work.sc_dz))
    w_slots = work.part_w.view(plan.batch, plan.chunks, -1)
    if kind in ("fwd", "last"):
        if j == 0:
            h_in = _layer0(plan, o, kw)[0]
            if plan.weight_grads:
                sc_h[0] = h_in
        else:
            h_in = sc_h[j].float()
        h, kept, cos = _layer(plan, o, kw, _matmul(h_in, o["ws"][j], trunk), j + 1)
        if kind == "fwd":
            sc_h[j + 1] = h
            sc_keep[j] = kept
            return
        if plan.bwd:
            g = o["g"]
        else:
            h = h.to(sc_h.dtype).float()  # the final layer takes the stored activation
            out = _matmul(h, o["wf"], trunk) + o["bf"]
            mse_rows, g = _loss_cotangent(out, o["tgt"], o["sw"], o["bm"], kw["out_act"],
                                          kw["gscale"], rows=True)
        if plan.weight_grads:
            h = h.to(sc_h.dtype).float()  # dWf takes the stored activation
            dwf = torch.einsum("bcsm,bcsn->bcmn", *(_rounded(_cta_rows(x, plan), trunk)
                                                    for x in (h, g)))
            w_slots[..., :C_PAD] = 0.0 if plan.bwd else _cta_sums(mse_rows, plan)
            w_slots[..., -(H * C_PAD + C_PAD) : -C_PAD] = dwf.flatten(2)
            w_slots[..., -C_PAD:] = _cta_sums(g, plan)
        dh = _matmul(g, o["wf"].transpose(0, 1), trunk)
        if plan.film:
            dmod = dh * cos
            f = o["fr"][..., (j + 1) * H : (j + 2) * H]
            _film_sums(plan, work, j + 1, dmod, kept, f)
            sc_dz[j] = dmod * f
        else:
            dz = dh * (kw["omega_h"] * cos)
            if plan.weight_grads:
                w_slots[..., C_PAD + j * H : C_PAD + (j + 1) * H] = _cta_sums(dz, plan)
            sc_dz[j] = dz
        return
    dh = _matmul(sc_dz[j].float(), o["ws"][j].transpose(0, 1), trunk)
    if j > 0:
        kept = sc_keep[j - 1]
        cos = (_sincos(kw)(
            o["fr"][..., j * H : (j + 1) * H] * kept + o["ph"][..., j * H : (j + 1) * H])[1]
            if plan.film else kept)
    else:
        _, kept, cos = _layer0(plan, o, kw)
    if plan.film:
        dmod = dh * cos
        f = o["fr"][..., j * H : (j + 1) * H]
        _film_sums(plan, work, j, dmod, kept, f)
        dz = dmod * f
    else:
        dz = dh * ((kw["omega_h"] if j > 0 else kw["omega0"]) * cos)
        if j == 0:
            work.part_img[..., K_PAD * H :] = _cta_sums(dz, plan)
        elif plan.weight_grads:
            w_slots[..., C_PAD + (j - 1) * H : C_PAD + j * H] = _cta_sums(dz, plan)
    if j > 0:
        sc_dz[j - 1] = dz
        return
    d = o["d"].expand(plan.batch, *o["d"].shape[1:])
    da = torch.einsum("bcsk,bcsh->bckh", *(_rounded(_cta_rows(x, plan), trunk)
                                           for x in (d, dz.to(sc_dz.dtype).float())))
    work.part_img[..., : K_PAD * H] = da.flatten(2)


def step_finish_reference(plan: StepPlan, work: PassWork, trunk: str,
                          finish: int = FINISH_IMG | FINISH_W | FINISH_DWS) -> None:
    """Plain version of what follows the passes (``finish`` as the kernels'
    FINISH_* flags): the slot sums and dWs = h^T dz over the scratch."""
    if finish & FINISH_IMG:
        work.out_img.copy_(work.part_img.sum(1))
    if finish & FINISH_W:
        work.out_w.copy_(work.part_w.sum(0))
    if finish & FINISH_DWS:
        for j in range(plan.n_mm):
            work.dws[j] = _pixel_dot(work.sc_h[j][None].float(), work.sc_dz[j][None].float(),
                                     trunk)


def _finish_flags(plan: StepPlan) -> int:
    return FINISH_IMG | (FINISH_W | FINISH_DWS if plan.weight_grads else 0)


def _results(plan: StepPlan, work) -> tuple:
    """What ``siren_step_reference`` / ``film_step_reference`` (a step plan)
    or ``siren_trunk_bwd_reference`` / ``film_trunk_bwd_reference`` (a
    backward plan) return, as views of the summed slots and dWs."""
    B, H = plan.batch, plan.hidden
    out_img = work.out_img
    mse_row = () if plan.bwd else (work.out_w[:C_PAD].view(1, C_PAD),)
    da = out_img[:, : K_PAD * H].view(B, K_PAD, H)
    n_bs = plan.n_mm + 1 if plan.film else plan.n_mm
    weights = ((work.dws, *work.small_sums(n_bs, H, skip=C_PAD)) if plan.weight_grads
               else (None,) * 4)
    if not plan.film:
        return (*mse_row, da, out_img[:, K_PAD * H :].view(B, 1, H), *weights)
    th = (plan.n_mm + 1) * H
    dfr = out_img[:, K_PAD * H : K_PAD * H + th].view(B, 1, th)
    dph = out_img[:, K_PAD * H + th :].view(B, 1, th)
    return (*mse_row, da, *weights, dfr, dph)


def _group_operands(plan: StepPlan, ops, g0: int, g1: int) -> tuple:
    """The operands of images [g0, g1): the per-image ones sliced (the
    directions only where each image has its own grid)."""
    per_image = ("a", "b0", "fr", "ph", "tgt", "bm", "g")
    return tuple(x[g0:g1] if name in per_image or (name == "d" and x.shape[0] > 1) else x
                 for name, x in _step_operands(plan.film, ops, plan.bwd).items())


def passes_reference(plan: StepPlan, ops, kw, sms: int, budget: int | None = None,
                     finish: int | None = None) -> PassWork:
    """The plain passes of ``plan`` chained, then the slot sums and dWs (or
    what ``finish``, FINISH_* flags, asks for), through the scratch and
    per-CTA slots of a card of ``sms`` SMs; with a ``budget`` (bytes) in the
    groups the card runs under it (``StepPlan.groups``), each group's dWs
    summed in group order."""
    trunk, dev = kw["trunk"], ops[0].device
    groups = plan.groups(budget) if budget is not None else ((0, plan.batch),)
    work = PassWork.for_plan(plan, trunk, dev, sms, images=groups[0][1] - groups[0][0])
    finish = _finish_flags(plan) if finish is None else finish
    if len(groups) == 1:
        for k in range(len(plan.passes)):
            step_pass_reference(plan, k, ops, kw, work)
        step_finish_reference(plan, work, trunk, finish)
        return work
    total = None
    for g0, g1 in groups:
        gplan = dataclasses.replace(plan, batch=g1 - g0)
        gwork = work.group(plan, g0, g1, torch.empty_like(work.dws), trunk, sms)
        gops = _group_operands(plan, ops, g0, g1)
        for k in range(len(plan.passes)):
            step_pass_reference(gplan, k, gops, kw, gwork)
        step_finish_reference(gplan, gwork, trunk, finish & FINISH_DWS)
        total = gwork.dws if total is None else total + gwork.dws
    step_finish_reference(plan, work, trunk, finish & ~FINISH_DWS)
    work.dws.copy_(total)
    return work


def step_passes_reference(film: bool, ops, kw, sms: int = 132, budget: int | None = None):
    """The plain passes chained, then the slot sums and dWs: what
    ``siren_step_reference`` / ``film_step_reference`` return, through the
    scratch and per-CTA slots of a card of ``sms`` SMs (in groups under a
    ``budget``, as ``passes_reference``)."""
    o = _step_operands(film, ops)
    plan = step_plan(film, o["a"].shape[0], o["d"].shape[1], o["a"].shape[-1],
                     o["ws"].shape[0], sms)
    return _results(plan, passes_reference(plan, ops, kw, sms, budget))


def bwd_passes_reference(film: bool, ops, g, kw, weight_grads: bool, sms: int = 132,
                         budget: int | None = None):
    """The backward as the plain passes chained (the cotangent last pass,
    no weight slots without ``weight_grads``): what
    ``siren_trunk_bwd_reference`` / ``film_trunk_bwd_reference`` return, on
    the same operands and keyword arguments."""
    o = _step_operands(film, (*ops, g), bwd=True)
    plan = step_plan(film, o["a"].shape[0], o["d"].shape[1], o["a"].shape[-1],
                     o["ws"].shape[0], sms, bwd=True, weight_grads=weight_grads)
    return _results(plan, passes_reference(plan, (*ops, g), kw, sms, budget))


# ---------------------------------------------------------------------------
# CUDA versions
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "reni_siren_step": [_P, ctypes.c_longlong, *[_P] * 17, *[_I] * 8, _F, _F, _F, _I, _I, _I, _P],
    "reni_film_step": [_P, ctypes.c_longlong, *[_P] * 18, *[_I] * 8, _F, _I, _I, _I, _P],
    "reni_siren_step_passes": [_P, ctypes.c_longlong, *[_P] * 21, *[_I] * 8, _F, _F, _F,
                               *[_I] * 6, _P],
    "reni_film_step_passes": [_P, ctypes.c_longlong, *[_P] * 22, *[_I] * 8, _F, *[_I] * 6, _P],
    "reni_pass_reduce": [_P, _P, _I, _I, ctypes.c_longlong, _P],
}


# (source, chain step, pass step, chain shared-memory bytes, error string) of each library
_SYMBOLS = {
    False: ("siren_step", "reni_siren_step", "reni_siren_step_passes", "reni_step_smem_bytes",
            "reni_step_error_string"),
    True: ("film_step", "reni_film_step", "reni_film_step_passes", "reni_film_step_smem_bytes",
           "reni_film_step_error_string"),
}


def library(film: bool = False):
    """The built ``csrc/siren_step.cu`` or ``csrc/film_step.cu`` (compiled at
    first call), with ``step`` (the chain kernel), ``passes`` (a step's or a
    backward's), ``reduce`` (a sum of slots), ``smem_bytes`` (the chain
    kernel's layout), ``pass_smem_bytes`` (the passes') and ``error_string``
    bound."""
    from reni_tpu_torch.kernels import _build

    source, step, passes, smem, error_string = _SYMBOLS[film]
    lib = _build.load(source)
    if not hasattr(lib, "step"):
        lib.source = source
        lib.step, lib.passes = getattr(lib, step), getattr(lib, passes)
        lib.reduce = lib.reni_pass_reduce
        lib.smem_bytes, lib.pass_smem_bytes = getattr(lib, smem), lib.reni_pass_smem_bytes
        lib.error_string = getattr(lib, error_string)
        for fn, name in ((lib.step, step), (lib.passes, passes), (lib.reduce, "reni_pass_reduce")):
            fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        lib.smem_bytes.argtypes, lib.smem_bytes.restype = [_I, _I, _I], ctypes.c_int
        lib.pass_smem_bytes.argtypes, lib.pass_smem_bytes.restype = [_I], ctypes.c_int
        lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _validate(kind, film, trunk, d_pad, batch, hidden, n_layers, out_act, operands, tgt, sw, bm):
    """Validate a step's operands: (d, d batch stride)."""
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
    return d, d_bstride


def _chain_work(film, trunk, d, batch, hidden, n_mm):
    """Work space of the chain kernel: (tiles per CTA, CTAs per image,
    per-image slots, per-image output (B, n_img), weight-gradient work)."""
    npix, dev = d.shape[1], d.device
    tiles, chunks = siren_bwd.launch_grid(npix, batch, trunk, dev)
    n_img = siren_bwd.image_values(film, hidden, n_mm)
    part_img = torch.empty((batch, chunks, n_img), dtype=torch.float32, device=dev)
    out_img = torch.empty((batch, n_img), dtype=torch.float32, device=dev)
    work = WeightGradWork.allocate(
        trunk, n_mm, batch * npix, hidden, batch * chunks, weight_values(hidden, n_mm, film), dev
    )
    return tiles, chunks, part_img, out_img, work


@dataclasses.dataclass
class PassOperands:
    """The operands of the pass kernels, cast and laid out once per call
    (``pass_operands``): ``tensors`` by their C argument name in the C order
    (None where the call has none: tgt, sw and bm of a backward or a
    forward, gin of a step or a forward, out of all but a forward), ``depth``
    n_hidden (cbc) or n_trunk (FiLM), ``scalars`` omega0,
    omega_h, gscale (cbc) or gscale (FiLM), ``flags`` the fast sine and the
    output activation."""

    tensors: dict
    d_bstride: int
    depth: int
    scalars: tuple
    flags: tuple
    device: torch.device

    PER_IMAGE = ("a", "b0", "fr", "ph", "tgt", "bm", "gin", "out")

    def head(self, g0: int = 0) -> tuple:
        """The pointers before the work space, in the C argument order, for
        the images from ``g0`` on (a group of a grouped call)."""
        ptrs = []
        for name, t in self.tensors.items():
            if t is not None and (name in self.PER_IMAGE or (name == "d" and self.d_bstride)):
                t = t[g0:]
            ptrs.append(None if t is None else t.data_ptr())
            if name == "d":
                ptrs.append(self.d_bstride)
        return tuple(ptrs)


def _validate_passes(film: bool, bwd: bool, ops, kw) -> tuple:
    """Validate the operands of a step or (``bwd``) of a backward on the pass
    route: (d, d batch stride). Raises before the card is asked anything."""
    o = _step_operands(film, ops, bwd)
    kind = f"{'film' if film else 'siren'}_{'bwd' if bwd else 'step'} passes"
    batch, hidden, n_mm = o["a"].shape[0], o["a"].shape[-1], o["ws"].shape[0]
    if bwd:
        return siren_bwd._validate(kind, kw["trunk"], ops[0], batch, hidden, n_mm, film,
                                   o["g"], ops[1:-1])
    return _validate(kind, film, kw["trunk"], ops[0], batch, hidden, n_mm + film,
                     kw["out_act"], ops[1:-3], *ops[-3:])


def pass_operands(plan: StepPlan, ops, kw, d=None, d_bstride=0) -> PassOperands:
    """Cast and lay out the operands of a step or (a backward plan) of a
    backward for the pass kernels: the float32 vectors, W in bf16 and its
    transpose per layer (the forward's B operand, K-major; a copy, not a
    product). ``d`` and ``d_bstride`` are the call's validated directions;
    without them the operands are validated here."""
    o = _step_operands(plan.film, ops, plan.bwd)
    if d is None:
        d, d_bstride = _validate_passes(plan.film, plan.bwd, ops, kw)
    ws = _weights(o["ws"], "bfloat16")
    f32 = {k: _f32(v) for k, v in o.items() if k not in ("d", "ws", "wf") and v is not None}
    tensors = dict(d=d, a=f32["a"], b0=f32.get("b0"), ws=ws, wst=ws.transpose(1, 2).contiguous(),
                   bs=f32["bs"], wf=_weights(o["wf"], "bfloat16"), bf=f32["bf"], fr=f32.get("fr"),
                   ph=f32.get("ph"), tgt=f32.get("tgt"), sw=f32.get("sw"), bm=f32.get("bm"),
                   gin=f32.get("g"), out=None)
    if not plan.film:
        del tensors["fr"], tensors["ph"]
    else:
        del tensors["b0"]
    gscale = float(kw.get("gscale", 0.0))
    scalars = (gscale,) if plan.film else (float(kw["omega0"]), float(kw["omega_h"]), gscale)
    flags = (int(bool(kw["fast_sine"])), ACTIVATIONS[kw.get("out_act")])
    return PassOperands(tensors, d_bstride, plan.n_mm + plan.film, scalars, flags, d.device)


def _pass_call(plan: StepPlan, prep: PassOperands, work: PassWork, lo: int, hi: int,
               finish: int, g0: int = 0, lib=None) -> None:
    """Passes [lo, hi) of ``plan`` on the card over ``work`` for the images
    from ``g0`` on, then what ``finish`` (FINISH_* flags) asks for
    (``csrc/step_passes.cuh``), through ``lib``'s ``passes`` (the step
    library of the plan's conditioning by default; the anatomy probes pass
    theirs). Counted in ``pass_launches`` by library."""
    rest = (work.part_img.data_ptr(), work.out_img.data_ptr(), work.part_w.data_ptr(),
            work.out_w.data_ptr(), work.sc_h.data_ptr(), work.sc_keep.data_ptr(),
            work.sc_dz.data_ptr(), work.part_dws.data_ptr(), work.dws.data_ptr(), plan.batch,
            plan.npix, plan.hidden)
    grid = (plan.tiles_per_cta, plan.chunks, work.rows_per_chunk, work.n_wchunks)
    lib = lib or library(plan.film)
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        err = lib.passes(*prep.head(g0), *rest, prep.depth, *grid, *prep.scalars, *prep.flags,
                         int(plan.weight_grads), lo, hi, finish, stream)
    _check(err, lib.error_string,
           f"{'film' if plan.film else 'siren'}_{'bwd' if plan.bwd else 'step'} passes")
    pass_launches[lib.source] += 1


# calls into each library's pass entry (its ``source``): siren_step,
# film_step and the anatomy probes' siren_anatomy
pass_launches = {"siren_step": 0, "film_step": 0, "siren_anatomy": 0}


def device_budget(device) -> int:
    """Bytes the pass scratch of one call may take on ``device``: the
    card's free memory and the blocks the caching allocator holds unused,
    less ``MEM_MARGIN``. cudaMemGetInfo waits for the card to finish its
    queued work, so a call reads this only when the allocator has refused
    its whole scratch (``_work_and_groups``)."""
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return free + cached - MEM_MARGIN


def _work_and_groups(plan: StepPlan, device, budget: int | None) -> tuple:
    """(work space, image groups) of one call. With a ``budget`` (bytes; a
    keyword for the tests) the groups follow ``plan.groups(budget)``.
    Without one the caching allocator is asked for the whole scratch, and
    only when it refuses does the budget come from ``device_budget`` (whose
    cudaMemGetInfo would otherwise hold every call until the card is idle)."""
    if budget is None:
        try:
            return PassWork.for_plan(plan, "bfloat16", device), ((0, plan.batch),)
        except torch.cuda.OutOfMemoryError:
            budget = device_budget(device)
    groups = plan.groups(budget)
    return (PassWork.for_plan(plan, "bfloat16", device, images=groups[0][1] - groups[0][0]),
            groups)


def _run_passes(plan: StepPlan, prep: PassOperands, budget: int | None = None) -> PassWork:
    """Every pass of ``plan`` on the card, then the slot sums and (with
    weight gradients) dWs; returns the work space the results are views of.
    Under the device-memory guard (``_work_and_groups``): when the scratch
    does not fit, the images run in groups (``StepPlan.groups``) over one
    group-sized scratch, each its full pass sequence into its own rows of
    the slots and its dWs into a slot of its own; the slots are then summed
    as in one call, and the groups' dWs in group order."""
    work, groups = _work_and_groups(plan, prep.device, budget)
    finish, n = _finish_flags(plan), len(plan.passes)
    if len(groups) == 1:
        _pass_call(plan, prep, work, 0, n, finish)
        return work
    group_dws = torch.empty((len(groups), *work.dws.shape), dtype=torch.float32,
                            device=prep.device)
    for i, (g0, g1) in enumerate(groups):
        gplan = dataclasses.replace(plan, batch=g1 - g0)
        gwork = work.group(plan, g0, g1, group_dws[i], "bfloat16")
        _pass_call(gplan, prep, gwork, 0, n, finish & FINISH_DWS, g0)
    _pass_call(plan, prep, work, 0, 0, finish & ~FINISH_DWS)
    if plan.weight_grads:
        lib = library(plan.film)
        with torch.cuda.device(prep.device):
            stream = torch.cuda.current_stream(prep.device).cuda_stream
            err = lib.reduce(group_dws.data_ptr(), work.dws.data_ptr(), 1, len(groups),
                             work.dws.numel(), stream)
        _check(err, lib.error_string, "the groups' dWs sum")
    return work


def _passes_step(film, ops, kw, budget: int | None = None) -> tuple:
    """The whole step through the passes (operands validated here): what
    ``siren_step_reference`` / ``film_step_reference`` return."""
    d, d_bstride = _validate_passes(film, False, ops, kw)
    plan = step_plan_cuda(film, ops, d.device)
    return _results(plan, _run_passes(plan, pass_operands(plan, ops, kw, d, d_bstride), budget))


def _passes_bwd(film, ops, g, kw, weight_grads: bool, budget: int | None = None) -> tuple:
    """The backward through the passes (operands validated here): what
    ``siren_trunk_bwd_reference`` / ``film_trunk_bwd_reference`` return."""
    d, d_bstride = _validate_passes(film, True, (*ops, g), kw)
    plan = step_plan_cuda(film, (*ops, g), d.device, bwd=True, weight_grads=weight_grads)
    return _results(plan, _run_passes(plan, pass_operands(plan, (*ops, g), kw, d, d_bstride),
                                      budget))


@dataclasses.dataclass
class Handoff:
    """What a forward through the passes (``passes_forward``) hands to the
    backward: the plan, the cast operands and the scratch the fwd passes
    filled (h_j and the kept values of every row)."""

    plan: StepPlan
    prep: PassOperands
    work: PassWork


def passes_forward(film, ops, kw, weight_grads: bool, budget: int | None = None):
    """The trunk's forward (operands of ``siren_trunk_reference`` /
    ``film_trunk_reference``) as the fwd passes and the output last pass,
    into a scratch that the backward then reads in place of running the
    forward again: (output (B, P, 8), ``Handoff``). None when that scratch,
    held from the forward to the backward, does not fit at once (the
    allocator refuses it, or it exceeds ``budget``): the caller takes the
    forward kernel and the backward recomputes, in groups. Counted in
    ``.launches``."""
    kind = f"{'film' if film else 'siren'}_fwd passes"
    o = _step_operands(film, ops)
    d, d_bstride = _cuda_operands(kind, kw["trunk"], ops[0], o["a"].shape[0], ops[1:])
    plan = step_plan_cuda(film, (*ops, None), d.device, bwd=True, weight_grads=weight_grads)
    if budget is not None and len(plan.groups(budget)) > 1:
        return None
    try:
        work = PassWork.for_plan(plan, "bfloat16", d.device)
    except torch.cuda.OutOfMemoryError:
        return None
    prep = pass_operands(plan, (*ops, None), kw, d, d_bstride)
    out = torch.empty((plan.batch, plan.npix, C_PAD), dtype=torch.float32, device=d.device)
    _pass_call(plan, dataclasses.replace(prep, tensors={**prep.tensors, "out": out}), work, 0,
               plan.n_mm, 0)
    passes_forward.launches += 1
    return out, Handoff(plan, prep, work)


passes_forward.launches = 0


def passes_bwd_handoff(handoff: Handoff, g) -> tuple:
    """The backward on the scratch a ``passes_forward`` filled: the
    cotangent last pass and the bwd passes, then the slot sums and (with
    weight gradients) dWs; returns what ``siren_trunk_bwd_reference`` /
    ``film_trunk_bwd_reference`` return."""
    plan, prep = handoff.plan, handoff.prep
    if not g.is_cuda or tuple(g.shape) != (plan.batch, plan.npix, C_PAD):
        raise ValueError(f"cotangent {tuple(g.shape)} on {g.device}: a CUDA tensor of shape "
                         f"{(plan.batch, plan.npix, C_PAD)} is needed")
    prep = dataclasses.replace(prep, tensors={**prep.tensors, "gin": _f32(g)})
    _pass_call(plan, prep, handoff.work, plan.n_mm - 1, len(plan.passes), _finish_flags(plan))
    return _results(plan, handoff.work)


def step_pass_cuda(plan: StepPlan, k: int, ops, kw, work: PassWork,
                   prepared: PassOperands | None = None) -> None:
    """Pass k alone on the card over ``work`` (which holds the scratch of
    the passes before it): what ``step_pass_reference`` does, for holding
    each pass kernel against its plain pass. ``prepared`` (``pass_operands``
    of these ``ops``, made once) leaves the call's casts and the transpose
    of W out of a timed pass. Counted in ``.launches``, apart from the
    step's and the backward's own counts."""
    _pass_call(plan, prepared or pass_operands(plan, ops, kw), work, k, k + 1, 0)
    step_pass_cuda.launches += 1


step_pass_cuda.launches = 0


def step_plan_cuda(film: bool, ops, device, bwd: bool = False,
                   weight_grads: bool = True) -> StepPlan:
    """The plan the step (or, ``bwd``, the backward) takes for these
    operands on ``device``."""
    o = _step_operands(film, ops, bwd)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return step_plan(film, o["a"].shape[0], o["d"].shape[1], o["a"].shape[-1], o["ws"].shape[0],
                     sms, bwd, weight_grads)


def siren_step_cuda(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """The train step on the card (``csrc/siren_step.cu``): the layer-major
    passes or the chain kernel, by ``pass_route``; returns what
    ``siren_step_reference`` returns."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    if pass_route(trunk, hidden, n_mm):
        kw = dict(omega0=omega0, omega_h=omega_h, out_act=out_act, gscale=gscale, trunk=trunk,
                  fast_sine=fast_sine)
        out = _passes_step(False, (d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm), kw)
        siren_step_cuda.launches += 1
        return out
    d, d_bstride = _validate("siren_step", False, trunk, d_pad, batch, hidden, n_mm, out_act,
                             (a, b0, ws, bs, wf, bf), tgt, sw, bm)
    tiles, chunks, part_img, out_img, work = _chain_work(False, trunk, d, batch, hidden, n_mm)
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
    _check(err, lib.error_string, "siren_step")
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
    """The FiLM train step on the card (``csrc/film_step.cu``): the
    layer-major passes or the chain kernel, by ``pass_route``; returns what
    ``film_step_reference`` returns."""
    batch, hidden, n_trunk = a0.shape[0], a0.shape[-1], bs.shape[0]
    d, d_bstride = _validate("film_step", True, trunk, d_pad, batch, hidden, n_trunk, out_act,
                             (a0, ws, bs, wf, bf, fr, ph), tgt, sw, bm)
    th = n_trunk * hidden
    for name, t in (("freqs", fr), ("phases", ph)):
        if tuple(t.shape) != (batch, 1, th):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(batch, 1, th)}")
    if ws.shape[0] != n_trunk - 1:
        raise ValueError(f"{ws.shape[0]} hidden weights for {n_trunk} trunk layers")
    if pass_route(trunk, hidden, n_trunk - 1):
        kw = dict(out_act=out_act, gscale=gscale, trunk=trunk, fast_sine=fast_sine)
        out = _passes_step(True, (d_pad, a0, ws, bs, wf, bf, fr, ph, tgt, sw, bm), kw)
        film_step_cuda.launches += 1
        return out
    tiles, chunks, part_img, out_img, work = _chain_work(True, trunk, d, batch, hidden,
                                                         n_trunk - 1)
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
    _check(err, lib.error_string, "film_step")
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
