"""The backward on the layer-major passes (reni_tpu_torch.kernels.siren_step:
the plain passes of a backward plan, the device-memory guard's groups) held
against the plain backward of kernels/siren_bwd.py and against the JAX
package's Pallas _bwd_kernel and _film_bwd_kernel, run in interpret mode on
the CPU as tests/test_pallas.py runs them; the forward's row-tile rule and
the latent noise draw on the CPU. The CUDA kernels themselves are checked on
the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.kernels import siren_pallas as jk
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.kernels import siren_step as ts
from reni_tpu_torch.models.reni import RENIConfig, RENIModel


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bwd_operands(film, B, P, H, n_mm, per_image, seed):
    """Packed trunk operands (SIREN-scaled weights, frequencies near 30 for
    FiLM) and an output cotangent g (B, P, 8), from a seeded numpy
    generator."""
    rng = np.random.default_rng(seed)
    u = lambda *s, b=1.0: torch.from_numpy(rng.uniform(-b, b, size=s).astype(np.float32))
    d = torch.zeros(B if per_image else 1, P, 8)
    d[..., :4] = u(d.shape[0], P, 4)
    a = torch.zeros(B, 8, H)
    a[:, :4] = u(B, 4, H, b=0.5)
    ws = u(n_mm, H, H, b=np.sqrt(6 / H) / 30)
    wf = torch.zeros(H, 8)
    wf[:, :3] = u(H, 3, b=np.sqrt(6 / H) / 30)
    bf = torch.zeros(1, 8)
    bf[0, :3] = u(3, b=0.1)
    g = torch.from_numpy(rng.normal(size=(B, P, 8)).astype(np.float32))
    if film:
        T = n_mm + 1
        ops = (d, a, ws, u(T, H, b=0.05), wf, bf, 30 + 5 * u(B, 1, T * H), u(B, 1, T * H))
        return ops, g, dict(fast_sine=True)
    return (d, a, u(B, 1, H, b=0.1), ws, u(n_mm, H, b=0.05), wf, bf), g, dict(
        omega0=30.0, omega_h=30.0, fast_sine=True)


def _plain(film):
    return tb.film_trunk_bwd_reference if film else tb.siren_trunk_bwd_reference


BWD_CASES = [  # (film, B, P, H, n_mm, per-image grids)
    (False, 3, 300, 64, 2, False),  # P = 2 x 128 + 44: a ragged tail tile
    (False, 3, 200, 64, 3, True),
    (False, 2, 130, 64, 9, False),  # deeper than the chain kernel takes at any width
    (False, 2, 130, 256, 7, False),  # the chain kernel's ceiling at H = 256 is 6 products
    (False, 2, 140, 64, 1, False),  # one product: the last pass forms layer 0 itself
    (True, 3, 300, 64, 2, False),
    (True, 3, 200, 64, 3, True),
    (True, 2, 130, 64, 9, False),
    (True, 2, 130, 256, 7, False),
    (True, 2, 140, 64, 1, False),
]


@pytest.mark.parametrize("weight_grads", [False, True], ids=["no_wgrad", "wgrad"])
@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"{'film' if c[0] else 'cbc'}-H{c[3]}-mm{c[4]}-P{c[2]}"
                              f"{'-per_image' if c[5] else ''}" for c in BWD_CASES])
def test_bwd_passes_match_plain_bwd(case, trunk, weight_grads):
    """The backward as the plain passes chained (the cotangent last pass,
    the scratch and per-CTA slots of a 2-SM card, slot sums, dWs over the
    scratch) equals the plain backward. Bars: float32 rtol 1e-6 with atol
    1e-6 x max |reference| (the slots sum in another order; inside the 5e-5
    of ROADMAP's float32 yardstick); bf16 each result within 1e-2 x max
    |reference|, the backward bar of tests/test_torch_cuda.py. Without
    weight gradients those results are None on both sides."""
    film, B, P, H, n_mm, per_image = case
    ops, g, kw = _bwd_operands(film, B, P, H, n_mm, per_image, seed=40)
    kw["trunk"] = trunk
    ref = _plain(film)(*ops, g, weight_grads=weight_grads, **kw)
    got = ts.bwd_passes_reference(film, ops, g, kw, weight_grads, sms=2)
    assert ts.step_plan(film, B, P, H, n_mm, 2).chunks > 1 or P <= 2 * ts.PASS_ROWS
    assert len(got) == len(ref)
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            assert x is None, i
            continue
        assert x.shape == y.shape, (i, x.shape, y.shape)
        scale = float(y.abs().max())
        if trunk == "float32":
            np.testing.assert_allclose(_np(x), _np(y), rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=str(i))
        else:
            assert float((x - y).abs().max()) <= 1e-2 * scale, i


# test_fused_gradients_match_jnp bars (tests/test_torch_kernels.py BWD_F32);
# FiLM's dfreqs sum sin'(30 x) * pre
BWD_F32 = {False: (5e-5, 2e-5), True: (1e-4, 5e-5)}


@pytest.mark.parametrize("weight_grads", [False, True], ids=["no_wgrad", "wgrad"])
@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_bwd_passes_match_pallas(film, trunk, weight_grads):
    """The plain passes of the backward against the Pallas _bwd_kernel /
    _film_bwd_kernel in interpret mode on the same packed operands and
    cotangent (P = 256: two 128-row tiles on both sides, two CTAs per image
    here): float32 at the bars of
    test_plain_bwd_matches_pallas_f32, bf16 each result within 2.5e-3 x max
    |Pallas| (test_plain_bwd_matches_pallas_bf16). Without weight
    gradients the per-image results are held, as FIT_LATENT uses them."""
    B, P, H, n_mm = 3, 256, 128, 3
    ops, g, kw = _bwd_operands(film, B, P, H, n_mm, per_image=False, seed=42)
    kw["trunk"] = trunk
    dtype = {"bfloat16": jnp.bfloat16, "float32": None}[trunk]
    if film:
        bwd = jk._film_calls(n_mm + 1, H, tile=128, trunk_dtype=dtype, interpret=True,
                             fast_sine=True)[1]
    else:
        bwd = jk._siren_calls(n_mm, H, 30.0, 30.0, tile=128, trunk_dtype=dtype,
                              interpret=True, fast_sine=True)[1]
    ref = [_np(r) for r in bwd(*(jnp.asarray(_np(t)) for t in ops), jnp.asarray(_np(g)))]
    got = ts.bwd_passes_reference(film, ops, g, kw, weight_grads, sms=2)
    assert len(got) == len(ref)
    worst = 0.0
    for i, (x, r) in enumerate(zip(got, ref)):
        if x is None:
            assert not weight_grads
            continue
        x = _np(x)
        assert x.shape == r.shape, (i, x.shape, r.shape)
        if trunk == "float32":
            np.testing.assert_allclose(x, r, rtol=BWD_F32[film][0], atol=BWD_F32[film][1],
                                       err_msg=f"gradient {i}")
        elif r.size:
            worst = max(worst, float(np.abs(x - r).max() / np.abs(r).max()))
    assert worst < 2.5e-3, worst


def test_bwd_plan_passes_cost_and_scratch():
    """The backward's plan at FIT_LATENT's last stage (21 x 8,192, 5 x 256)
    on a 132-SM card: the step's grid and pass list; without weight
    gradients no h_0 out, g in place of targets and pixel weights, one
    product of the last pass (g Wf^T) and no dWs; with them the dWf product
    and dWs come back. Its scratch (h and dz in bf16, the kept values in
    float32) is about 9 KB a row."""
    kw = dict(film=False, batch=21, npix=8192, hidden=256, n_mm=5, sms=132)
    step = ts.step_plan(**kw)
    bwd = ts.step_plan(**kw, bwd=True, weight_grads=False)
    full = ts.step_plan(**kw, bwd=True, weight_grads=True)
    assert (bwd.tiles_per_cta, bwd.chunks) == (step.tiles_per_cta, step.chunks) == (2, 32)
    assert bwd.passes == step.passes == full.passes
    R, H = bwd.rows, 256
    fwd0 = bwd.pass_cost(0)
    assert fwd0[1] == 2 * H * H + R * (8 * 4 + 2 * H + 4 * H)  # d in; h_1 and c_1 out
    assert full.pass_cost(0)[1] == fwd0[1] + R * 2 * H  # h_0 to sc_h[0]
    last = bwd.pass_cost(4)
    assert last == (2.0 * R * H * H + 2.0 * R * H * 8,
                    2 * H * H + R * (2 * H) + R * (8 * 4 + 2 * H) + H * 8 * 2)
    assert full.pass_cost(4)[0] == last[0] + 2.0 * R * H * 8  # dWf
    assert step.pass_cost(4)[1] - last[1] == R * 8 * 4  # targets and weights for g
    assert all(bwd.pass_cost(k) == step.pass_cost(k) for k in range(5, 10))
    assert bwd.wgrad_cost() == (0.0, 0) and full.wgrad_cost() == step.wgrad_cost()
    assert bwd.row_bytes == H * (2 * 2 * 5 + 4 * 4) == 9216
    slots = 21 * 32 * (bwd.n_img + bwd.n_w) + 21 * bwd.n_img + bwd.n_w
    assert bwd.scratch_bytes == R * 9216 + 4 * slots
    per_row = sum(bwd.pass_cost(k)[1] for k in range(10)) / R
    assert 17_000 < per_row < 18_000, per_row


@pytest.mark.parametrize("budget_images,groups", [
    (100, ((0, 100),)), (60, ((0, 50), (50, 100))), (34, ((0, 34), (34, 68), (68, 100))),
    (1, tuple((i, i + 1) for i in range(100))), (0, tuple((i, i + 1) for i in range(100)))])
def test_group_plan_keeps_the_grid(budget_images, groups):
    """The device-memory guard's groups at the flagship step shape (100 x
    8,192): all images at once when the scratch fits; else as few groups as
    fit, of one size but the last, at least one image each, covering every
    image once; each group keeps the whole batch's grid."""
    plan = ts.step_plan(False, 100, 8192, 256, 5, 132)
    fixed = plan.scratch_bytes - plan.rows * plan.row_bytes
    budget = fixed + budget_images * plan.npix * plan.row_bytes
    got = plan.groups(budget)
    assert got == groups
    covered = [i for g0, g1 in got for i in range(g0, g1)]
    assert covered == list(range(100))
    gplan = dataclasses.replace(plan, batch=got[0][1] - got[0][0])
    assert (gplan.tiles_per_cta, gplan.chunks) == (plan.tiles_per_cta, plan.chunks) == (12, 6)


GROUP_CASES = [  # (film, a backward, weight gradients)
    (False, False, True), (True, False, True), (False, True, False), (False, True, True),
    (True, True, False), (True, True, True)]


@pytest.mark.parametrize("film,bwd,weight_grads", GROUP_CASES,
                         ids=[f"{'film' if f else 'cbc'}-{'bwd' if b else 'step'}"
                              f"{'-wgrad' if w and b else ''}" for f, b, w in GROUP_CASES])
def test_grouped_plain_passes_equal_one_call(film, bwd, weight_grads):
    """The plain passes in the guard's groups (5 images with per-image grids
    under a budget that holds 2: groups of 2, 2 and 1) against one call:
    every per-CTA slot written once, the per-image results and the loss
    bitwise equal, dWs (summed by group, in group order) within float32
    rounding."""
    B, P, H, n_mm = 5, 300, 64, 3
    ops, g, kw = _bwd_operands(film, B, P, H, n_mm, per_image=True, seed=44)
    kw["trunk"] = "bfloat16"
    if bwd:
        call_ops = (*ops, g)
    else:
        tgt, sw = torch.zeros(B, P, 8), torch.zeros(1, P, 8)
        tgt[..., :3], sw[..., :3] = g[..., :3], g[:1, :, 3:6].abs()
        bm = torch.ones(B, 1, 8)
        bm[-1] = 0.0
        call_ops = (*ops, tgt, sw, bm)
        kw.update(out_act="tanh", gscale=1.0 / (3 * P))
    plan = ts.step_plan(film, B, P, H, n_mm, 2, bwd=bwd, weight_grads=weight_grads)
    budget = plan.scratch_bytes - 3 * P * plan.row_bytes
    assert plan.groups(budget) == ((0, 2), (2, 4), (4, 5))
    one = ts.passes_reference(plan, call_ops, kw, sms=2)
    grouped_work = []
    real_for_plan = ts.PassWork.for_plan

    def nan_filled(*a, **k):  # every slot a group does not write stays NaN
        work = real_for_plan(*a, **k)
        for t in (work.part_img, work.part_w):
            t.fill_(float("nan"))
        grouped_work.append(work)
        return work

    ts.PassWork.for_plan = nan_filled
    try:
        grouped = ts.passes_reference(plan, call_ops, kw, sms=2, budget=budget)
    finally:
        ts.PassWork.for_plan = real_for_plan
    assert grouped_work[0].sc_h.shape[1] == 2 * P  # a scratch of two images
    assert not torch.isnan(grouped.part_img).any()
    assert torch.equal(grouped.part_img, one.part_img) and torch.equal(grouped.out_img,
                                                                       one.out_img)
    if weight_grads:
        assert not torch.isnan(grouped.part_w).any()
        assert torch.equal(grouped.part_w, one.part_w) and torch.equal(grouped.out_w, one.out_w)
        scale = float(one.dws.abs().max())
        assert float((grouped.dws - one.dws).abs().max()) <= 1e-6 * scale
    results, ref = ts._results(plan, grouped), ts._results(plan, one)
    for x, y in zip(results, ref):
        assert (x is None and y is None) or x.shape == y.shape


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_bwd_passes_write_every_slot_once(film):
    """Each pass of a backward writes only its own outputs (pass_outputs),
    and together they fill the scratch and slots the backward uses: with
    weight gradients all of them, without them the per-image slots and the
    scratch but h_0 and the weight slots."""
    ops, g, kw = _bwd_operands(film, 3, 300, 64, 3, False, seed=46)
    kw["trunk"] = "bfloat16"
    for weight_grads in (False, True):
        plan = ts.step_plan(film, 3, 300, 64, 3, 2, bwd=True, weight_grads=weight_grads)
        work = ts.PassWork.for_plan(plan, "bfloat16", "cpu", sms=2)
        names = ("sc_h", "sc_keep", "sc_dz", "part_img", "part_w")
        for name in names:
            getattr(work, name).fill_(float("nan"))
        for k in range(len(plan.passes)):
            before = work.clone()
            ts.step_pass_reference(plan, k, (*ops, g), kw, work)
            outs = ts.pass_outputs(plan, k, work)
            assert all(not torch.isnan(v).any() for v in outs.values()), plan.passes[k]
            for name in names:
                old, new = getattr(before, name), getattr(work, name)
                changed = ~torch.eq(old, new) & ~(torch.isnan(old) & torch.isnan(new))
                covered = torch.zeros_like(changed)
                for v in outs.values():
                    if v.untyped_storage().data_ptr() == new.untyped_storage().data_ptr():
                        mark = torch.zeros_like(new, dtype=torch.bool)
                        mark.as_strided(v.shape, v.stride(), v.storage_offset()).fill_(True)
                        covered |= mark
                assert not (changed & ~covered).any(), (plan.passes[k], name)
        assert not torch.isnan(work.part_img).any()
        assert not torch.isnan(work.sc_h[1:]).any() and not torch.isnan(work.sc_dz).any()
        assert torch.isnan(work.sc_h[0]).all() is not weight_grads
        assert torch.isnan(work.part_w).all() is not weight_grads


@pytest.mark.parametrize("hidden,trunk,tm", [
    (256, "bfloat16", 64), (256, "float32", 64), (512, "bfloat16", 64), (512, "float32", 32),
    (880, "bfloat16", 32), (1024, "bfloat16", 32), (1024, "float32", 16),
    (2048, "bfloat16", 16), (2048, "float32", None), (4096, "bfloat16", None)])
def test_forward_row_tile_rule(hidden, trunk, tm):
    """The forward takes the largest row tile (64, 32 or 16) whose two
    activation buffers fit in a CTA's shared memory; past the 16-row tile
    unsupported_reason declines and names the tile it tried."""
    assert tk.tile_rows(hidden, trunk) == tm
    reason = tk.unsupported_reason(512, hidden, batch=4, trunk=trunk)
    if tm is None:
        assert "shared memory" in reason and "(16 rows;" in reason, reason
        assert str(tk.fwd_smem_bytes(16, hidden, trunk)) in reason
    else:
        assert reason is None
        assert tk.fwd_smem_bytes(tm, hidden, trunk) <= tk.SMEM_LIMIT
        if tm < 64:
            assert tk.fwd_smem_bytes(2 * tm, hidden, trunk) > tk.SMEM_LIMIT


@pytest.mark.parametrize("hidden,n_mm,passes", [(256, 5, True), (256, 12, True), (64, 1, True),
                                                (320, 1, False), (512, 1, False), (96, 2, False)])
def test_bwd_route_and_depth_limit(hidden, n_mm, passes):
    """The backward follows pass_route: on the passes (bf16, a multiple of 64
    up to 256) any depth is taken; the chain kernel (H = 320 and 512, whose
    weights and a tile do not fit one CTA; bf16 widths not a multiple of 64;
    the float32 trunk) keeps its shared-memory depth limit, written down in
    bwd_unsupported_reason."""
    assert ts.pass_route("bfloat16", hidden, n_mm) is passes
    for film in (False, True):
        reason = tb.bwd_unsupported_reason(hidden, n_mm, film, "bfloat16")
        if passes:
            assert reason is None
        else:
            smem = tb.bwd_smem_bytes(film, "bfloat16", hidden, n_mm)
            assert (reason is None) is (smem <= tk.SMEM_LIMIT)
    assert "shared memory" in tb.bwd_unsupported_reason(256, 12, False, "float32")
    assert "shared memory" in tb.bwd_unsupported_reason(512, 5, True, "bfloat16")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sample_latent_on_cpu_draws_the_generators_numbers(dtype):
    """On the CPU sample_latent draws eps with torch.randn from the
    generator, as before the card's pinned draw: the same numbers bit for
    bit, and the generator advances by the same amount."""
    model = RENIModel(RENIConfig(model_type="VariationalAutoDecoder", latent_dim=5))
    params = model.init(torch.Generator().manual_seed(0), 6, device="cpu")
    params = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if k == "latents" else v)
              for k, v in params.items()}
    idx = [0, 3, 5]
    gen = torch.Generator().manual_seed(7)
    Z, mu, log_var = model.sample_latent(params, idx, gen)
    ref_gen = torch.Generator().manual_seed(7)
    eps = torch.randn(mu.shape, generator=ref_gen, dtype=dtype)
    assert Z.dtype == dtype
    assert torch.equal(Z, mu + eps * torch.exp(0.5 * log_var))
    assert torch.equal(torch.randn(4, generator=gen), torch.randn(4, generator=ref_gen))
