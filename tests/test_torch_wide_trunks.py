"""The trunks past the wgmma passes' width (bf16 widths from 320 up) and
the float32 trunk, which the port's tiled passes (csrc/tiled_passes.cuh)
take at any depth and width: the routing envelope held against JAX's
``unsupported_reason``, and the port's plain versions (the forward, the
backward and the step as the plain passes chain them) held against the JAX
package's Pallas kernels in interpret mode, as tests/test_pallas.py runs
them, on the same numpy-seeded operands. The CUDA kernels themselves are
checked on the card (tests/test_torch_cuda.py and chip_smoke.py's wide
phase)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.kernels import siren_pallas as jk
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.kernels import siren_step as ts
from reni_tpu_torch.models.reni import RENIConfig, RENIModel

ENVELOPE = [(H, depth) for H in range(128, 1025, 128) for depth in range(1, 17)] + [
    (H, depth) for H in (1152, 1536, 2048, 4096) for depth in (1, 2, 5, 16)]


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
@pytest.mark.parametrize("H,depth", ENVELOPE, ids=[f"H{h}-L{d}" for h, d in ENVELOPE])
def test_port_takes_every_trunk_jax_takes(H, depth, conditioning, trunk):
    """Wherever JAX's unsupported_reason accepts a trunk (a width that is a
    multiple of 128, any depth, both trunks), the port's step kernel
    (fused_step_reason) and apply's guard with a gradient (decode_reason)
    accept it too, at FIT_DECODER's batch and last stage."""
    B, npix = 100, 8192
    assert jk.unsupported_reason(npix, H, batch=B) is None
    model = RENIModel(RENIConfig(conditioning=conditioning, hidden_layers=depth,
                                 hidden_features=H, use_pallas=True, pallas_trunk=trunk))
    assert model.fused_step_reason(B, npix) is None
    assert model.decode_reason(B, npix, grad=True) is None
    n_mm = depth - 1 if conditioning == "FiLM" else depth
    assert ts.pass_design(trunk, H, n_mm) == ("wgmma" if trunk == "bfloat16" and H <= 256 and n_mm
                                              else "tiled")


BATCHES = [1, 2, 100, 65_535, 65_536, 65_537, 100_000, 131_071, 131_072, 199_999, 200_000]


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_port_takes_every_batch_jax_takes(conditioning, trunk):
    """C-8: JAX's unsupported_reason puts no bound on the batch; neither do
    the port's guards (the grids put images on x): decode_reason with and
    without a gradient and fused_step_reason are None for every batch of
    the sweep up to 200,000 images, at the Zoo's width and past 1,024."""
    for H in (128, 512, 2048):
        model = RENIModel(RENIConfig(conditioning=conditioning, hidden_layers=5,
                                     hidden_features=H, use_pallas=True, pallas_trunk=trunk))
        for B in BATCHES:
            assert jk.unsupported_reason(64, H, batch=B) is None
            assert tk.unsupported_reason(64, H, batch=B, trunk=trunk) is None
            assert model.decode_reason(B, 64) is None
            assert model.decode_reason(B, 64, grad=True) is None
            assert model.fused_step_reason(B, 64) is None


def _operands(film, B, P, H, n_mm, seed):
    """Packed trunk operands (SIREN-scaled weights, frequencies near 30 for
    FiLM), an output cotangent g (B, P, 8) and the loss operands, from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    u = lambda *s, b=1.0: torch.from_numpy(rng.uniform(-b, b, size=s).astype(np.float32))
    d = torch.zeros(1, P, 8)
    d[..., :4] = u(1, P, 4)
    a = torch.zeros(B, 8, H)
    a[:, :4] = u(B, 4, H, b=0.5)
    ws = u(n_mm, H, H, b=np.sqrt(6 / H) / 30)
    wf = torch.zeros(H, 8)
    wf[:, :3] = u(H, 3, b=np.sqrt(6 / H) / 30)
    bf = torch.zeros(1, 8)
    bf[0, :3] = u(3, b=0.1)
    g = torch.from_numpy(rng.normal(size=(B, P, 8)).astype(np.float32))
    tgt, sw = torch.zeros(B, P, 8), torch.zeros(1, P, 8)
    tgt[..., :3], sw[..., :3] = u(B, P, 3, b=0.5), u(1, P, 3).abs()
    bm = torch.ones(B, 1, 8)
    bm[-1] = 0.0  # a masked row
    if film:
        T = n_mm + 1
        ops = (d, a, ws, u(T, H, b=0.05), wf, bf, 30 + 5 * u(B, 1, T * H), u(B, 1, T * H))
        kw = dict(fast_sine=True)
    else:
        ops = (d, a, u(B, 1, H, b=0.1), ws, u(n_mm, H, b=0.05), wf, bf)
        kw = dict(omega0=30.0, omega_h=30.0, fast_sine=True)
    return ops, g, (tgt, sw, bm), kw


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _worst(got, ref):
    """The largest max |diff| / max |ref| over the results."""
    worst = 0.0
    for x, r in zip(got, ref):
        x, r = _np(x), _np(r)
        assert x.shape == r.shape, (x.shape, r.shape)
        if r.size:
            worst = max(worst, float(np.abs(x - r).max() / np.abs(r).max()))
    return worst


WIDE_CASES = [  # (film, H, n_mm, P)
    (False, 384, 2, 256), (True, 384, 2, 256), (False, 512, 3, 256), (True, 512, 2, 256),
    (False, 1152, 2, 64), (True, 1152, 1, 64)]
# float32: 5e-5 of each result's largest entry; bf16: the output at the bars
# of test_fused_bf16_trunk_close (max 0.05, mean 0.01), the loss to 1e-3
# relative and each gradient to 2.5e-3 of its largest entry (the bars of
# tests/test_torch_step.py's bf16 step against Pallas)
BARS = {"float32": (5e-5, 5e-5), "bfloat16": (1e-3, 2.5e-3)}


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=[f"{'film' if c[0] else 'cbc'}-H{c[1]}-mm{c[2]}"
                                                  for c in WIDE_CASES])
def test_plain_versions_match_pallas_past_256(case, trunk):
    """At H = 384, 512 and 1,152 (the tiled passes' route on the card) the
    port's plain forward, the backward and the step as the plain passes
    chain them (the scratch and per-CTA slots of a 2-SM card) against JAX's
    Pallas forward, _bwd_kernel / _film_bwd_kernel and _step_kernel /
    _film_step_kernel in interpret mode on the same operands (B = 2, P = 256:
    two 128-row tiles on both sides; past 1,024 depth 2 at P = 64, one
    64-row tile)."""
    film, H, n_mm, P = case
    B, tile = 2, min(P, 128)
    ops, g, loss_ops, kw = _operands(film, B, P, H, n_mm, seed=H + n_mm)
    kw["trunk"] = trunk
    assert ts.pass_design(trunk, H, n_mm) == "tiled"
    dtype = {"bfloat16": jnp.bfloat16, "float32": None}[trunk]
    gscale = 1.0 / (3 * P)
    if film:
        fwd, bwd = jk._film_calls(n_mm + 1, H, tile=tile, trunk_dtype=dtype, interpret=True,
                                  fast_sine=True)
        step = jk._film_step_call_builder(n_mm + 1, H, out_act="tanh", gscale=gscale, tile=tile,
                                          trunk_dtype=dtype, interpret=True, fast_sine=True)
        plain_fwd = tk.film_trunk_reference
    else:
        fwd, bwd = jk._siren_calls(n_mm, H, 30.0, 30.0, tile=tile, trunk_dtype=dtype,
                                   interpret=True, fast_sine=True)
        step = jk._step_call_builder(n_mm, H, 30.0, 30.0, out_act="tanh", gscale=gscale,
                                     tile=tile, trunk_dtype=dtype, interpret=True, fast_sine=True)
        plain_fwd = tk.siren_trunk_reference
    j = lambda ts_: [jnp.asarray(_np(t)) for t in ts_]
    loss_bar, grad_bar = BARS[trunk]
    with torch.no_grad():
        out = _np(plain_fwd(*ops, **kw))
        ref_out = np.asarray(fwd(*j(ops)))
        err = np.abs(out - ref_out)
        if trunk == "float32":
            assert err.max() <= 5e-5, err.max()
        else:
            assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())

        got = ts.bwd_passes_reference(film, ops, g, kw, True, sms=2)
        ref = bwd(*j(ops), jnp.asarray(_np(g)))
        assert _worst(got, ref) <= grad_bar

        step_kw = dict(kw, out_act="tanh", gscale=gscale)
        got = ts.step_passes_reference(film, (*ops, *loss_ops), step_kw, sms=2)
        ref = step(*j(ops), *j(loss_ops))
        loss, loss_ref = float(got[0].sum()), float(np.asarray(ref[0]).sum())
        assert abs(loss - loss_ref) <= loss_bar * abs(loss_ref), (loss, loss_ref)
        assert _worst(got[1:], ref[1:]) <= grad_bar


TILED_CASES = [  # (film, trunk, H, n_mm, P)
    (False, "float32", 80, 3, 300), (True, "float32", 48, 2, 200), (False, "bfloat16", 320, 1, 140),
    (True, "bfloat16", 1024, 0, 130), (True, "float32", 1024, 1, 70)]


@pytest.mark.parametrize("case", TILED_CASES, ids=[
    f"{'film' if c[0] else 'cbc'}-{c[1]}-H{c[2]}-mm{c[3]}" for c in TILED_CASES])
def test_plain_passes_match_plain_step_on_the_tiled_route(case):
    """The plain passes of the tiled route's shapes (float32 widths that are
    a multiple of 16, a bf16 width past 256, a one-layer FiLM trunk whose
    last pass forms layer 0 and dA itself) chained equal the plain step and
    the plain backward. Bars: float32 1e-6 x max |reference| (the slots sum
    in another order), bf16 1e-2 x max |reference|."""
    film, trunk, H, n_mm, P = case
    B = 3
    ops, g, loss_ops, kw = _operands(film, B, P, H, n_mm, seed=7)
    kw["trunk"] = trunk
    bar = 1e-6 if trunk == "float32" else 1e-2
    step_kw = dict(kw, out_act="tanh", gscale=1.0 / (3 * P))
    plain_step = ts.film_step_reference if film else ts.siren_step_reference
    with torch.no_grad():
        got = ts.step_passes_reference(film, (*ops, *loss_ops), step_kw, sms=2)
        ref = plain_step(*ops, *loss_ops, **step_kw)
        assert _worst(got, ref) <= bar
        plain_bwd = tb.film_trunk_bwd_reference if film else tb.siren_trunk_bwd_reference
        for weight_grads in (False, True):
            got = ts.bwd_passes_reference(film, ops, g, kw, weight_grads, sms=2)
            ref = plain_bwd(*ops, g, **kw, weight_grads=weight_grads)
            assert all((x is None) == (r is None) for x, r in zip(got, ref))
            assert _worst([x for x in got if x is not None], [r for r in ref if r is not None]) <= bar


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_tiled_plan_scratch_and_costs(trunk):
    """The tiled route's plan at 5 x 512 (FIT_DECODER's 100 x 8,192 on a
    132-SM card): the trunk's dtype in the scratch (bf16 20 KB a row,
    float32 30 KB: h and dz, the kept values and the last layer's
    pre-activation, the column blocks' partial final layers and g) and in
    the byte counts (52 KB and 83 KB of traffic a row), the products' FLOP,
    and the split-K partials of dWs in the device-memory budget (C-1)."""
    plan = ts.step_plan(False, 100, 8192, 512, 5, 132, trunk=trunk)
    assert plan.design == "tiled"
    e = 2 if trunk == "bfloat16" else 4
    n_cb = 2 if trunk == "bfloat16" else 8  # 256- and 64-column blocks
    assert (plan.n_keep, plan.n_cb) == (5, n_cb)
    assert plan.row_bytes == 512 * (e * 2 * 5 + 4 * 5) + 4 * 8 * (n_cb + 1)
    assert plan.scratch_shapes()["sc_o"] == (n_cb, plan.rows, 8)
    flops = sum(plan.pass_cost(k)[0] for k in range(10)) + plan.wgrad_cost()[0]
    assert 15 * 2 * 512 * 512 * plan.rows <= flops < 1.02 * 15 * 2 * 512 * 512 * plan.rows
    per_row = (sum(plan.pass_cost(k)[1] for k in range(10)) + plan.wgrad_cost()[1]) / plan.rows
    assert per_row == pytest.approx(51_530 if trunk == "bfloat16" else 82_640, rel=0.01)
    # bf16: 4 x 2 blocks of 128 x 256 a layer, 26 chunks (1,040 CTAs: the
    # cap of 8 waves, under 50 blocks of 16,384 rows, so two blocks a
    # chunk); float32: 16 tiles of 128 x 128, 6 CTAs an SM
    chunks = {"bfloat16": 26, "float32": 9}[trunk]
    assert tb.wgrad_split(plan.rows, 512, 5, trunk, 132) == chunks
    assert plan.wgrad_bytes == (chunks + 3) * 5 * 512 * 512 * 4
    slots = plan.batch * plan.chunks * (plan.n_img + plan.n_w) + plan.batch * plan.n_img + plan.n_w
    assert plan.scratch_bytes == plan.rows * plan.row_bytes + 4 * slots + plan.wgrad_bytes
    per, n = tb.wgrad_chunks(plan.rows, 512, 5, trunk, "cpu", sms=132)
    assert n <= chunks  # a call's partials never exceed what the budget counts
    no_w = ts.step_plan(False, 100, 8192, 512, 5, 132, bwd=True, weight_grads=False, trunk=trunk)
    assert no_w.wgrad_bytes == 0


def test_budget_counts_the_split_k_partials_at_1024():
    """C-1: at 5 x 1,024 the split-K partials of dWs (and dWs with a grouped
    call's running sum) are in the budget a grouped call divides, not in
    MEM_MARGIN: a budget that holds the scratch of 10 images besides them
    gives groups of 10, one that holds it only without them gives more."""
    plan = ts.step_plan(False, 100, 8192, 1024, 5, 132)
    assert plan.wgrad_bytes >= 4 * 5 * 1024 * 1024 * 4  # partials, dWs, sum and group slot
    fixed = plan.scratch_bytes - plan.rows * plan.row_bytes
    per_image = plan.npix * plan.row_bytes
    assert plan.groups(fixed + 10 * per_image)[0] == (0, 10)
    assert plan.groups(fixed - plan.wgrad_bytes + 10 * per_image)[0][1] < 10


# bf16 widths and the output block of the wgmma weight-gradient product:
# the fewest blocks of at most 256 columns, as even as 64-column atoms allow
WGRAD_BLOCKS = {16: 64, 64: 64, 96: 128, 128: 128, 192: 192, 256: 256, 320: 192, 384: 192,
                448: 256, 512: 256, 576: 192, 1024: 256, 1152: 256, 2048: 256, 4096: 256}


@pytest.mark.parametrize("H", sorted(WGRAD_BLOCKS))
def test_wgrad_tile_rule(H):
    """The bf16 product's output block at every width the routes hand it
    (multiples of 64 on the wgmma and tiled passes, other multiples of 16 on
    the chain route): 128 rows (two warpgroups of m64) by WGRAD_BLOCKS[H]
    columns, as the kernel's wgrad_nb computes it; float32 keeps 128 x 128."""
    rows, cols = tb.wgrad_tile("bfloat16", H)
    assert (rows, cols) == (128, WGRAD_BLOCKS[H])
    blocks = math.ceil(H / 256)
    assert math.ceil(H / cols) == blocks and cols % 64 == 0 and cols <= 256
    # csrc/siren_chain.cuh::wgrad_nb, term for term
    assert 64 * (((H + blocks - 1) // blocks + 63) // 64) == cols
    assert tb.wgrad_tile("float32", H) == (128, 128)


@pytest.mark.parametrize("rows,H,n_mm,sms,want", [
    (100 * 8192, 256, 5, 132, 50), (100 * 8192, 256, 4, 132, 50), (21 * 32768, 256, 5, 132, 42),
    (100 * 8192, 512, 5, 132, 26), (100 * 8192, 512, 4, 132, 33), (21 * 8192, 256, 5, 132, 13),
    (3000, 128, 2, 132, 66), (3000, 96, 3, 132, 44), (100 * 8192, 2048, 2, 132, 4),
    (100 * 8192, 4096, 16, 132, 1), (100 * 8192, 256, 5, 114, 50), (21 * 8192, 256, 5, 114, 11)])
def test_wgrad_split_fills_the_card(rows, H, n_mm, sms, want):
    """The bf16 split, one CTA an SM: a chunk a block of 16,384 rows (the
    kernel's accumulators then reach the slot once: the Zoo's 5 x 256 at
    100 x 8,192 in 50 chunks, 21 x 32,768 in 42), at least one wave of CTAs
    (FIT_LATENT's 21 x 8,192: 13 chunks, 130 CTAs) and at most eight (bf16
    5 x 512: 26 chunks, 1,040 CTAs), so the partials stay within about
    8 x 132 output blocks; float32 keeps about WGRAD_CTAS_PER_SM CTAs an SM
    of 128 x 128 tiles, whatever the rows."""
    assert tb.wgrad_split(rows, H, n_mm, "bfloat16", sms) == want
    tiles = math.prod(math.ceil(H / t) for t in tb.wgrad_tile("bfloat16", H)) * n_mm
    assert max(1, sms // tiles) <= want <= max(1, tb.WGRAD_WAVES * sms // tiles)
    assert want * tiles <= max(tiles, tb.WGRAD_WAVES * sms)
    # more rows never give fewer chunks (a grouped call's partials fit)
    assert tb.wgrad_split(rows // 3, H, n_mm, "bfloat16", sms) <= want
    f32_tiles = math.ceil(H / 128) ** 2 * n_mm
    assert tb.wgrad_split(rows, H, n_mm, "float32", sms) == max(
        1, tb.WGRAD_CTAS_PER_SM * sms // f32_tiles)


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 792, 3000, 21 * 8192, 100 * 8192])
def test_wgrad_chunks_cover_the_rows(rows, trunk):
    """Blocks of whole 64-row K-slabs (a slab never reaches into the next
    block; the last block's tail is the kernel's zero fill) covering every
    row once, block b in chunk b % chunks, at most wgrad_split chunks: a
    function of rows, width, depth and SM count only. float32 takes one
    block a chunk; bf16 blocks take at most WGRAD_WINDOW_ROWS rows (the
    rows of one tensor-core sum), and its chunks hold as many blocks as
    one another, give or take one."""
    for H, n_mm in ((96, 3), (256, 5), (512, 5), (1152, 1), (2048, 2)):
        per, chunks = tb.wgrad_chunks(rows, H, n_mm, trunk, "cpu", sms=132)
        blocks = math.ceil(rows / per)
        assert per % 64 == 0 and per > 0
        assert (blocks - 1) * per < rows <= blocks * per
        assert chunks == min(blocks, tb.wgrad_split(rows, H, n_mm, trunk, 132))
        if trunk == "float32":
            assert blocks == chunks
        else:
            assert per <= tb.WGRAD_WINDOW_ROWS
            held = [len(range(c, blocks, chunks)) for c in range(chunks)]
            assert max(held) - min(held) <= 1 and min(held) >= 1
        assert (per, chunks) == tb.wgrad_chunks(rows, H, n_mm, trunk, "cpu", sms=132)


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_wgrad_groups_fit_the_partials(trunk):
    """A grouped call's dWs partials: every group's chunks fit the partials
    that PassWork.for_plan allocates for the whole batch and that
    StepPlan.wgrad_bytes counts in the budget."""
    plan = ts.step_plan(False, 7, 200, 256, 5, 132, trunk=trunk)
    work = ts.PassWork.for_plan(plan, trunk, "cpu", sms=132)
    split = tb.wgrad_split(plan.rows, 256, 5, trunk, 132)
    assert work.part_dws.shape[0] <= split
    assert plan.wgrad_bytes == (split + 3) * 5 * 256 * 256 * 4
    for g0, g1 in ((0, 3), (3, 6), (6, 7)):
        sub = work.group(plan, g0, g1, torch.empty(5, 256, 256), trunk, sms=132)
        assert sub.n_wchunks <= work.part_dws.shape[0] and sub.rows_per_chunk % 64 == 0
        assert sub.sc_h.shape == (5, (g1 - g0) * 200, 256)


def test_declines_that_remain():
    """What the port still declines, and why: a bf16 width that is not a
    multiple of 64 (the chain kernel's depth limit; JAX declines it too, not
    a multiple of 128; past the row tile the forward too), and at call time
    a trunk whose one image's pass scratch does not fit the device-memory
    budget (a MemoryError that names memory). Widths past 1,024 and the
    float32 forward at H = 2,048 are taken."""
    assert ts.pass_design("bfloat16", 96, 40) is None
    assert "shared memory" in ts.step_unsupported_reason(96, 40, "bfloat16")
    assert "shared memory" in tb.bwd_unsupported_reason(96, 40, False, "bfloat16")
    assert jk.unsupported_reason(8192, 96) is not None
    assert "shared memory" in tk.unsupported_reason(8192, 3600, trunk="bfloat16")
    assert jk.unsupported_reason(8192, 3600) is not None
    assert ts.pass_design("bfloat16", 1088, 5) == "tiled"
    assert ts.step_unsupported_reason(1088, 5, "bfloat16") is None
    assert tk.unsupported_reason(8192, 2048, trunk="float32") is None
    assert tk.fwd_route("float32", 2048, 2) == "passes"
    plan = ts.step_plan(False, 4, 1 << 20, 4096, 16, 132)
    fixed = plan.scratch_bytes - plan.rows * plan.row_bytes
    with pytest.raises(MemoryError, match="device memory"):
        plan.groups(fixed + plan.npix * plan.row_bytes - 1)
    assert plan.groups(fixed + plan.npix * plan.row_bytes) == tuple((b, b + 1) for b in range(4))
