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
bf16 trunk at widths that are a multiple of 64) or as the chain kernel
(``csrc/siren_step.cuh``; the float32 trunk, other bf16 widths, a FiLM trunk
of one layer). ``siren_step_reference`` / ``film_step_reference`` are their
plain PyTorch versions, step by step like the TPU kernels with their bf16
rounding; ``step_pass_reference`` is the plain version of one pass, in the
passes' own scratch and slot layout (``StepPlan``, ``PassWork``), which
``step_pass_cuda`` runs on the card.
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


def pass_route(trunk: str, hidden: int, n_mm: int) -> bool:
    """The routing rule between the two step kernels. The layer-major wgmma
    passes (``csrc/step_passes.cuh``) take the bf16 trunk at a width that is
    a multiple of 64 with at least one H x H product; the chain kernel
    (``csrc/siren_step.cuh``) takes the float32 trunk, bf16 widths that are a
    multiple of 16 but not of 64, and a FiLM trunk of one layer (no H x H
    product). The rule is by dtype and shape only: a failed build or launch
    raises on either route."""
    return trunk == "bfloat16" and hidden % PASS_WIDTH == 0 and n_mm >= 1


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
    """The pass plan of one step (``csrc/step_passes.cuh``): a grid of
    (``chunks`` per image, ``batch``) CTAs, each walking ``tiles_per_cta``
    consecutive 128-row tiles of one image, and ``2 n_mm`` passes:
    ``("fwd", j)`` for products 0..n_mm-2, ``("last", n_mm - 1)``, then
    ``("bwd", j)`` from n_mm - 1 down to 0."""

    film: bool
    batch: int
    npix: int
    hidden: int
    n_mm: int
    tiles_per_cta: int
    chunks: int

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

    def pass_cost(self, k: int) -> tuple[float, int]:
        """(FLOP, bytes) of pass k: bytes of each operand read once and each
        result written once (directions, targets and pixel weights as the
        kernel reads them, 8 float32 lanes), weights once."""
        kind, j = self.passes[k]
        R, H = self.rows, self.hidden
        flops = 2.0 * R * H * H
        nbytes = 2 * H * H
        if kind != "bwd":
            first = j == 0
            nbytes += R * ((K_PAD * 4 + 2 * H) if first else 2 * H)  # input (and h_0 out)
            flops += 2.0 * R * K_PAD * H if first else 0.0
        if kind == "fwd":
            nbytes += R * (2 * H + 4 * H)  # h and the kept value out
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
        """(FLOP, bytes) of dWs = h^T dz over the scratch."""
        R, H = self.rows, self.hidden
        return 2.0 * self.n_mm * R * H * H, self.n_mm * (R * 4 * H + H * H * 4)


def pass_grid(npix: int, batch: int, sms: int) -> tuple[int, int]:
    """(tiles per CTA, CTAs per image) of the passes on a card of ``sms``
    SMs: 128-row tiles, the grid rule of ``siren_bwd.tile_grid``."""
    return siren_bwd.tile_grid(npix, batch, PASS_ROWS, sms)


def step_plan(film: bool, batch: int, npix: int, hidden: int, n_mm: int, sms: int) -> StepPlan:
    tiles, chunks = pass_grid(npix, batch, sms)
    return StepPlan(film, batch, npix, hidden, n_mm, tiles, chunks)


@dataclasses.dataclass
class PassWork(WeightGradWork):
    """``WeightGradWork`` plus what the passes add: the kept values' scratch
    ``sc_keep`` (n_mm - 1, rows, H) float32, the per-image slots
    ``part_img`` (B, chunks, n_img) and their sum ``out_img``."""

    sc_keep: torch.Tensor
    part_img: torch.Tensor
    out_img: torch.Tensor

    @classmethod
    def for_plan(cls, plan: StepPlan, trunk: str, device, sms: int | None = None):
        base = WeightGradWork.allocate(trunk, plan.n_mm, plan.rows, plan.hidden,
                                       plan.batch * plan.chunks, plan.n_w, device, sms)
        shapes, f32 = plan.scratch_shapes(), dict(dtype=torch.float32, device=device)
        return cls(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                   sc_keep=torch.empty(shapes["sc_keep"], **f32),
                   part_img=torch.empty(shapes["part_img"], **f32),
                   out_img=torch.empty((plan.batch, plan.n_img), **f32))

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
    if kind != "bwd" and j == 0:
        out["sc_h0"] = work.sc_h[0]
    layer = j + 1 if plan.film else j  # the bias row of the dz this pass forms
    if kind == "last":
        out["sc_dz"] = work.sc_dz[j]
        out["mse"] = w[:, :C_PAD]
        out["dbs"] = w[:, C_PAD + layer * H : C_PAD + (layer + 1) * H]
        out["dwf_dbf"] = w[:, -(H * C_PAD + C_PAD):]
    if kind == "bwd":
        layer = j if plan.film else j - 1
        if j > 0:
            out["sc_dz"] = work.sc_dz[j - 1]
        if layer >= 0:
            out["dbs"] = w[:, C_PAD + layer * H : C_PAD + (layer + 1) * H]
        if j == 0:
            out["dA"] = img[..., : K_PAD * H]
            if not plan.film:
                out["db0"] = img[..., K_PAD * H :]
    if plan.film and kind != "fwd":
        out["dfreqs"] = img[..., (K_PAD + layer) * H : (K_PAD + layer + 1) * H]
        out["dphases"] = img[..., (K_PAD + T + layer) * H : (K_PAD + T + layer + 1) * H]
    return out


def _step_operands(film, ops):
    """The step's operands by name."""
    names = (("d", "a", "ws", "bs", "wf", "bf", "fr", "ph", "tgt", "sw", "bm") if film
             else ("d", "a", "b0", "ws", "bs", "wf", "bf", "tgt", "sw", "bm"))
    return dict(zip(names, ops))


def _cta_rows(x: torch.Tensor, plan: StepPlan) -> torch.Tensor:
    """(B, P, ...) -> (B, chunks, rows of a CTA, ...), zero past P."""
    span = plan.tiles_per_cta * PASS_ROWS
    pad = plan.chunks * span - x.shape[1]
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.reshape(x.shape[0], plan.chunks, span, *x.shape[2:])


def _cta_sums(x: torch.Tensor, plan: StepPlan) -> torch.Tensor:
    """Per-CTA sums over rows: (B, P, n) -> (B, chunks, n)."""
    return _cta_rows(x, plan).sum(2)


def _layer0(plan, o, kw):
    """Layer 0 of the tile rows: (h_0, kept value, cos factor), each (B, P, H)."""
    sincos = sincos_fns(kw["fast_sine"])
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
    sincos = sincos_fns(kw["fast_sine"])
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
    """FiLM's per-CTA modulation sums of ``layer``: dfreqs, dphases, dbs."""
    H, T = plan.hidden, plan.n_mm + 1
    img, w = work.part_img, work.part_w.view(plan.batch, plan.chunks, -1)
    img[..., (K_PAD + layer) * H : (K_PAD + layer + 1) * H] = _cta_sums(dmod * pre, plan)
    img[..., (K_PAD + T + layer) * H : (K_PAD + T + layer + 1) * H] = _cta_sums(dmod, plan)
    w[..., C_PAD + layer * H : C_PAD + (layer + 1) * H] = _cta_sums(dmod * f, plan)


def step_pass_reference(plan: StepPlan, k: int, ops, kw, work: PassWork) -> None:
    """Plain version of pass k of ``csrc/step_passes.cuh``: reads and writes
    ``work`` in the kernel's layout, with its rounding points (both operands
    of every product rounded to bf16 by ``_matmul``, h and dz stored in the
    trunk's dtype, kept values and every sum in float32). ``kw`` as for
    ``siren_step_reference`` / ``film_step_reference``."""
    kind, j = plan.passes[k]
    o, trunk, H = _step_operands(plan.film, ops), kw["trunk"], plan.hidden
    sc_h, sc_keep, sc_dz = (_scratch(t, plan) for t in (work.sc_h, work.sc_keep, work.sc_dz))
    w_slots = work.part_w.view(plan.batch, plan.chunks, -1)
    if kind in ("fwd", "last"):
        if j == 0:
            h_in = _layer0(plan, o, kw)[0]
            sc_h[0] = h_in
        else:
            h_in = sc_h[j].float()
        h, kept, cos = _layer(plan, o, kw, _matmul(h_in, o["ws"][j], trunk), j + 1)
        if kind == "fwd":
            sc_h[j + 1] = h
            sc_keep[j] = kept
            return
        h = h.to(sc_h.dtype).float()  # the final layer takes the stored activation
        out = _matmul(h, o["wf"], trunk) + o["bf"]
        mse_rows, g = _loss_cotangent(out, o["tgt"], o["sw"], o["bm"], kw["out_act"],
                                      kw["gscale"], rows=True)
        dwf = torch.einsum("bcsm,bcsn->bcmn", *(_rounded(_cta_rows(x, plan), trunk)
                                                for x in (h, g)))
        w_slots[..., :C_PAD] = _cta_sums(mse_rows, plan)
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
            w_slots[..., C_PAD + j * H : C_PAD + (j + 1) * H] = _cta_sums(dz, plan)
            sc_dz[j] = dz
        return
    dh = _matmul(sc_dz[j].float(), o["ws"][j].transpose(0, 1), trunk)
    if j > 0:
        kept = sc_keep[j - 1]
        cos = (sincos_fns(kw["fast_sine"])(
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
        if j > 0:
            w_slots[..., C_PAD + (j - 1) * H : C_PAD + j * H] = _cta_sums(dz, plan)
        else:
            work.part_img[..., K_PAD * H :] = _cta_sums(dz, plan)
    if j > 0:
        sc_dz[j - 1] = dz
        return
    d = o["d"].expand(plan.batch, *o["d"].shape[1:])
    da = torch.einsum("bcsk,bcsh->bckh", *(_rounded(_cta_rows(x, plan), trunk)
                                           for x in (d, dz.to(sc_dz.dtype).float())))
    work.part_img[..., : K_PAD * H] = da.flatten(2)


def step_finish_reference(plan: StepPlan, work: PassWork, trunk: str) -> None:
    """Plain version of what follows the passes: the slot sums and dWs =
    h^T dz over the scratch."""
    work.out_img.copy_(work.part_img.sum(1))
    work.out_w.copy_(work.part_w.sum(0))
    for j in range(plan.n_mm):
        work.dws[j] = _pixel_dot(work.sc_h[j][None].float(), work.sc_dz[j][None].float(), trunk)


def _step_results(plan: StepPlan, work) -> tuple:
    """What ``siren_step_reference`` / ``film_step_reference`` return, as
    views of the summed slots and dWs."""
    B, H = plan.batch, plan.hidden
    out_img = work.out_img
    mse_row = work.out_w[:C_PAD].view(1, C_PAD)
    da = out_img[:, : K_PAD * H].view(B, K_PAD, H)
    if not plan.film:
        db0 = out_img[:, K_PAD * H :].view(B, 1, H)
        return (mse_row, da, db0, work.dws, *work.small_sums(plan.n_mm, H, skip=C_PAD))
    th = (plan.n_mm + 1) * H
    dfr = out_img[:, K_PAD * H : K_PAD * H + th].view(B, 1, th)
    dph = out_img[:, K_PAD * H + th :].view(B, 1, th)
    dbs, dwf, dbf = work.small_sums(plan.n_mm + 1, H, skip=C_PAD)
    return mse_row, da, work.dws, dbs, dwf, dbf, dfr, dph


def step_passes_reference(film: bool, ops, kw, sms: int = 132) -> tuple:
    """The plain passes chained, then the slot sums and dWs: what
    ``siren_step_reference`` / ``film_step_reference`` return, through the
    scratch and per-CTA slots of a card of ``sms`` SMs."""
    o = _step_operands(film, ops)
    B, H, n_mm = o["a"].shape[0], o["a"].shape[-1], o["ws"].shape[0]
    plan = step_plan(film, B, o["d"].shape[1], H, n_mm, sms)
    work = PassWork.for_plan(plan, kw["trunk"], o["d"].device, sms)
    for k in range(len(plan.passes)):
        step_pass_reference(plan, k, ops, kw, work)
    step_finish_reference(plan, work, kw["trunk"])
    return _step_results(plan, work)


# ---------------------------------------------------------------------------
# CUDA versions
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "reni_siren_step": [_P, ctypes.c_longlong, *[_P] * 17, *[_I] * 8, _F, _F, _F, _I, _I, _I, _P],
    "reni_film_step": [_P, ctypes.c_longlong, *[_P] * 18, *[_I] * 8, _F, _I, _I, _I, _P],
    "reni_siren_step_passes": [_P, ctypes.c_longlong, *[_P] * 19, *[_I] * 8, _F, _F, _F,
                               *[_I] * 5, _P],
    "reni_film_step_passes": [_P, ctypes.c_longlong, *[_P] * 20, *[_I] * 8, _F, *[_I] * 5, _P],
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
    first call), with ``step`` (the chain kernel), ``passes``,
    ``smem_bytes`` (the chain kernel's layout), ``pass_smem_bytes`` (the
    passes') and ``error_string`` bound."""
    from reni_tpu_torch.kernels import _build

    source, step, passes, smem, error_string = _SYMBOLS[film]
    lib = _build.load(source)
    if not hasattr(lib, "step"):
        lib.step, lib.passes = getattr(lib, step), getattr(lib, passes)
        lib.smem_bytes, lib.pass_smem_bytes = getattr(lib, smem), lib.reni_pass_smem_bytes
        lib.error_string = getattr(lib, error_string)
        for fn, name in ((lib.step, step), (lib.passes, passes)):
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
    """The operands of the pass kernels, cast and laid out once per step
    (``pass_operands``): ``head`` the pointers before the work space in the C
    argument order, ``depth`` n_hidden (cbc) or n_trunk (FiLM), ``scalars``
    omega0, omega_h, gscale (cbc) or gscale (FiLM), ``flags`` the fast sine
    and the output activation; ``tensors`` own the pointers."""

    head: tuple
    depth: int
    scalars: tuple
    flags: tuple
    device: torch.device
    tensors: tuple


def pass_operands(plan: StepPlan, ops, kw, d=None, d_bstride=0) -> PassOperands:
    """Cast and lay out the step's operands for the pass kernels: the
    float32 vectors, W in bf16 and its transpose per layer (the forward's B
    operand, K-major; a copy, not a product). ``d`` and ``d_bstride`` are
    the step's validated directions; without them the operands are
    validated here."""
    o = _step_operands(plan.film, ops)
    if d is None:
        kind = "film_step passes" if plan.film else "siren_step passes"
        d, d_bstride = _validate(kind, plan.film, kw["trunk"], ops[0], plan.batch, plan.hidden,
                                 plan.n_mm + plan.film, kw["out_act"], ops[1:-3], *ops[-3:])
    ws = _weights(o["ws"], "bfloat16")
    wst = ws.transpose(1, 2).contiguous()
    wf = _weights(o["wf"], "bfloat16")
    first = ("a",) if plan.film else ("a", "b0")
    after = (("bf", "fr", "ph") if plan.film else ("bf",)) + ("tgt", "sw", "bm")
    f32 = {k: _f32(o[k]) for k in (*first, "bs", *after)}
    ptrs = lambda names: [f32[n].data_ptr() for n in names]
    head = (d.data_ptr(), d_bstride, *ptrs(first), ws.data_ptr(), wst.data_ptr(),
            f32["bs"].data_ptr(), wf.data_ptr(), *ptrs(after))
    scalars = ((float(kw["gscale"]),) if plan.film
               else (float(kw["omega0"]), float(kw["omega_h"]), float(kw["gscale"])))
    flags = (int(bool(kw["fast_sine"])), ACTIVATIONS[kw["out_act"]])
    return PassOperands(head, plan.n_mm + plan.film, scalars, flags, d.device,
                        (d, ws, wst, wf, *f32.values()))


def _pass_call(plan: StepPlan, prep: PassOperands, work: PassWork, lo: int, hi: int,
               finish: bool) -> None:
    """Passes [lo, hi) of ``plan`` on the card over ``work`` and, with
    ``finish``, the slot sums and dWs (``csrc/step_passes.cuh``)."""
    rest = (work.part_img.data_ptr(), work.out_img.data_ptr(), work.part_w.data_ptr(),
            work.out_w.data_ptr(), work.sc_h.data_ptr(), work.sc_keep.data_ptr(),
            work.sc_dz.data_ptr(), work.part_dws.data_ptr(), work.dws.data_ptr(), plan.batch,
            plan.npix, plan.hidden)
    grid = (plan.tiles_per_cta, plan.chunks, work.rows_per_chunk, work.n_wchunks)
    lib = library(plan.film)
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        err = lib.passes(*prep.head, *rest, prep.depth, *grid, *prep.scalars, *prep.flags, lo,
                         hi, int(finish), stream)
    _check(err, lib.error_string, "film_step passes" if plan.film else "siren_step passes")


def _passes_step(film, d, d_bstride, ops, kw) -> tuple:
    """The whole step through the passes: plan, work space, every pass, the
    slot sums and dWs."""
    plan = step_plan_cuda(film, ops, d.device)
    prep = pass_operands(plan, ops, kw, d, d_bstride)
    work = PassWork.for_plan(plan, kw["trunk"], d.device)
    _pass_call(plan, prep, work, 0, len(plan.passes), True)
    return _step_results(plan, work)


def step_pass_cuda(plan: StepPlan, k: int, ops, kw, work: PassWork,
                   prepared: PassOperands | None = None) -> None:
    """Pass k alone on the card over ``work`` (which holds the scratch of
    the passes before it): what ``step_pass_reference`` does, for holding
    each pass kernel against its plain pass. ``prepared`` (``pass_operands``
    of these ``ops``, made once) leaves the step's per-call casts and the
    transpose of W out of a timed pass. Counted in ``.launches``, apart from
    the step's own count."""
    _pass_call(plan, prepared or pass_operands(plan, ops, kw), work, k, k + 1, False)
    step_pass_cuda.launches += 1


step_pass_cuda.launches = 0


def step_plan_cuda(film: bool, ops, device) -> StepPlan:
    """The plan the step takes for these operands on ``device``."""
    o = _step_operands(film, ops)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return step_plan(film, o["a"].shape[0], o["d"].shape[1], o["a"].shape[-1], o["ws"].shape[0],
                     sms)


def siren_step_cuda(
    d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm, *, omega0, omega_h, out_act, gscale,
    trunk="bfloat16", fast_sine=False,
):
    """The train step on the card (``csrc/siren_step.cu``): the layer-major
    passes or the chain kernel, by ``pass_route``; returns what
    ``siren_step_reference`` returns."""
    batch, hidden, n_mm = a.shape[0], a.shape[-1], ws.shape[0]
    d, d_bstride = _validate("siren_step", False, trunk, d_pad, batch, hidden, n_mm, out_act,
                             (a, b0, ws, bs, wf, bf), tgt, sw, bm)
    if pass_route(trunk, hidden, n_mm):
        kw = dict(omega0=omega0, omega_h=omega_h, out_act=out_act, gscale=gscale, trunk=trunk,
                  fast_sine=fast_sine)
        out = _passes_step(False, d, d_bstride, (d_pad, a, b0, ws, bs, wf, bf, tgt, sw, bm), kw)
        siren_step_cuda.launches += 1
        return out
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
        out = _passes_step(True, d, d_bstride, (d_pad, a0, ws, bs, wf, bf, fr, ph, tgt, sw, bm),
                           kw)
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
