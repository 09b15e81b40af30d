"""The plain versions of the anatomy probes (reni_tpu_torch.kernels.anatomy)
held against the JAX package's probe kernels (_fwd_kernel_variant,
_bwd_kernel_variant of benchmarks/bwd_anatomy.py), run in interpret mode on
the CPU. The CUDA probes themselves are checked against these plain versions
on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import bwd_anatomy as ja
from reni_tpu.core.fastmath import sincos_fns, sine_fns
from reni_tpu_torch.kernels import anatomy as ta
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.kernels import siren_step as ts

B, P, H, L = 2, 256, 128, 2
TILE = 128
DTYPES = {"float32": None, "bfloat16": jnp.bfloat16}


def _operands(seed=0, batch=B, npix=P, hidden=H):
    """Numpy operands in the kernel layout, scaled as bwd_anatomy._run scales
    them; one shared direction grid (the probes' index map)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.normal(size=(1, npix, 8)).astype(f32),
        (rng.normal(size=(batch, 8, hidden)) * 0.02).astype(f32),
        (rng.normal(size=(batch, 1, hidden)) * 0.02).astype(f32),
        (rng.normal(size=(L, hidden, hidden)) * 0.01).astype(f32),
        (rng.normal(size=(L, hidden)) * 0.01).astype(f32),
        (rng.normal(size=(hidden, 8)) * 0.01).astype(f32),
        (rng.normal(size=(1, 8)) * 0.01).astype(f32),
        rng.normal(size=(batch, npix, 8)).astype(f32),
    )


def _jax_fwd(ops, trunk, fast_sine, **variant):
    kw = dict(n_hidden=L, omega0=30.0, omega_h=30.0, trunk_dtype=DTYPES[trunk],
              sine=sine_fns(fast_sine)[0])
    batch, npix = ops[1].shape[0], ops[0].shape[1]
    call = ja.fwd_variant_call(kw, H, TILE, batch, npix, interpret=True, **variant)
    return np.asarray(call(*map(jnp.asarray, ops[:7])))


def _jax_bwd(ops, trunk, fast_sine, tile=TILE, **variant):
    """_bwd_kernel_variant through a pallas_call of the test's own, as
    bwd_variant_call builds it but in interpret mode."""
    kw = dict(n_hidden=L, omega0=30.0, omega_h=30.0, trunk_dtype=DTYPES[trunk],
              sincos=sincos_fns(fast_sine))
    d_pad, a, b0, ws, bs, wf, bf, g = map(jnp.asarray, ops)
    batch, npix = a.shape[0], d_pad.shape[1]
    whole = pl.BlockSpec(memory_space=ja.pltpu.VMEM)

    def block(shape, index):
        return pl.BlockSpec(shape, index, memory_space=ja.pltpu.VMEM)

    per_image = [block((1, 8, H), lambda b, p: (b, 0, 0)), block((1, 1, H), lambda b, p: (b, 0, 0))]
    outs = pl.pallas_call(
        functools.partial(ja._bwd_kernel_variant, **kw, **variant),
        grid=(batch, npix // tile),
        in_specs=[block((1, tile, 8), lambda b, p: (0, p, 0)), *per_image, whole, whole, whole,
                  whole, block((1, tile, 8), lambda b, p: (b, p, 0))],
        out_specs=(*per_image, whole, whole, whole, whole),
        out_shape=tuple(jax.ShapeDtypeStruct(x.shape, jnp.float32)
                        for x in (a, b0, ws, bs, wf, bf)),
        interpret=True,
    )(d_pad, a, b0, ws, bs, wf, bf, g)
    return [np.asarray(x) for x in outs]


def _torch(ops):
    return [torch.from_numpy(x) for x in ops]


def _kw(trunk, fast_sine):
    return dict(omega0=30.0, omega_h=30.0, trunk=trunk, fast_sine=fast_sine)


def _assert_rel(got, ref, rel, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("fast_sine", [False, True], ids=["sin", "fast_sine"])
@pytest.mark.parametrize(
    "variant", [dict(transcendental=False), dict(interleave=2), dict(interleave=4), dict()],
    ids=["no_sine", "interleave2", "interleave4", "shipped"],
)
def test_fwd_variant_plain_matches_jax(variant, fast_sine):
    """Float32 trunk: each forward variant within 2e-5 x max |JAX| of the
    Pallas probe (the forward's float32 bar; the output without sines is not
    bounded by 1, hence relative); the interleaved ones equal the plain
    shipped forward bit for bit."""
    ops = _operands(1)
    ref = _jax_fwd(ops, "float32", fast_sine, **variant)
    out = ta.fwd_variant_reference(*_torch(ops[:7]), **variant, **_kw("float32", fast_sine))
    _assert_rel(out, ref, 2e-5, variant)
    if variant.get("transcendental", True):
        shipped = tk.siren_trunk_reference(*_torch(ops[:7]), **_kw("float32", fast_sine))
        assert torch.equal(out, shipped)
    else:
        assert np.abs(ref).max() > 1.5  # the stand-in really replaced the sine


@pytest.mark.parametrize("fast_sine", [False, True], ids=["sin", "fast_sine"])
@pytest.mark.parametrize(
    "variant",
    [dict(transcendental=False), dict(weight_grads=False),
     dict(transcendental=False, weight_grads=False), dict()],
    ids=["no_sincos", "no_dw", "mxu_only", "shipped"],
)
def test_bwd_variant_plain_matches_jax(variant, fast_sine):
    """Float32 trunk, two images x two tiles: every gradient the variant
    computes within 5e-5 x max |JAX| of the Pallas probe (the bar of the plain
    backward against _bwd_kernel); without weight gradients the port returns
    None where the probe leaves its outputs unwritten."""
    ops = _operands(2)
    ref = _jax_bwd(ops, "float32", fast_sine, **variant)
    got = ta.bwd_variant_reference(*_torch(ops), **variant, **_kw("float32", fast_sine))
    names = ("dA", "db0", "dWs", "dbs", "dWf", "dbf")
    n = 6 if variant.get("weight_grads", True) else 2
    for name, x, y in zip(names[:n], got, ref):
        _assert_rel(x, y.reshape(x.shape), 5e-5, (variant, name))
    assert all(x is None for x in got[n:])
    if variant.get("transcendental", True) and n == 6:
        shipped = tb.siren_trunk_bwd_reference(*_torch(ops), **_kw("float32", fast_sine))
        assert all(torch.equal(x, y) for x, y in zip(got, shipped))


@pytest.mark.parametrize("transcendental", [True, False], ids=["sincos", "no_sincos"])
def test_bwd_variant_no_accum_matches_jax(transcendental):
    """accum=False depends on the tiling, so one image and one tile: there the
    Pallas probe writes the whole gradient, and the port's raw result (the
    slots of four CTAs of four 8-row tiles each, and the scratch) sums to it:
    slots to 5e-5 x max |JAX|, h^T dz over the scratch rows likewise."""
    ops = _operands(3, batch=1, npix=TILE)
    ref = _jax_bwd(ops, "float32", True, accum=False, transcendental=transcendental)
    grid = (4, 4)  # 4 CTAs x 4 tiles x 8 rows = 128 rows
    part_img, part_w, sc_h, sc_dz = ta.bwd_variant_reference(
        *_torch(ops), accum=False, transcendental=transcendental, grid=grid,
        **_kw("float32", True))
    assert part_img.shape == (1, 4, 9 * H) and part_w.shape == (4, L * H + H * 8 + 8)
    assert sc_h.shape == sc_dz.shape == (L, TILE, H)
    img, w = part_img.sum(1), part_w.sum(0)
    got = (img[:, : 8 * H].view(1, 8, H), img[:, 8 * H :].view(1, 1, H),
           ta.weight_grads_reference(sc_h, sc_dz), w[: L * H].view(L, H),
           w[L * H : L * H + H * 8].view(H, 8), w[-8:].view(1, 8))
    for name, x, y in zip(("dA", "db0", "dWs", "dbs", "dWf", "dbf"), got, ref):
        _assert_rel(x, y, 5e-5, name)
    # another grid, the same sums; a grid that does not cover the rows raises
    other = ta.bwd_variant_reference(*_torch(ops), accum=False, transcendental=transcendental,
                                     grid=(3, 6), **_kw("float32", True))
    _assert_rel(other[0].sum(1), img, 1e-5, "grid (3, 6)")
    with pytest.raises(ValueError, match="covers"):
        ta.bwd_variant_reference(*_torch(ops), accum=False, grid=(1, 4), **_kw("float32", True))


def test_variants_plain_match_jax_bf16():
    """bf16 trunk, the probes without sines: the forward within 1e-2 x max
    |JAX| and each gradient within 2.5e-3 of its largest entry (the bars of
    the shipped kernels' plain versions against Pallas)."""
    ops = _operands(4)
    ref = _jax_fwd(ops, "bfloat16", True, transcendental=False)
    out = ta.fwd_variant_reference(*_torch(ops[:7]), transcendental=False,
                                   **_kw("bfloat16", True))
    _assert_rel(out, ref, 1e-2, "fwd_no_sine bf16")
    ref = _jax_bwd(ops, "bfloat16", True, transcendental=False)
    got = ta.bwd_variant_reference(*_torch(ops), transcendental=False, **_kw("bfloat16", True))
    for name, x, y in zip(("dA", "db0", "dWs", "dbs", "dWf", "dbf"), got, ref):
        _assert_rel(x, y.reshape(x.shape), 2.5e-3, name)


def _slot_sums(plan, part_img, part_w, sc_h, sc_dz):
    """The per-CTA slots and the scratch of a pass-layout accum=False result,
    summed: (dA, db0, dWs, dbs, dWf, dbf), the mse lanes (0 in a backward)
    checked and dropped."""
    hidden, n_mm = plan.hidden, plan.n_mm
    img, w = part_img.sum(1), part_w.sum(0)
    assert torch.equal(w[:8], torch.zeros(8))
    w = w[8:]
    return (img[:, : 8 * hidden].view(-1, 8, hidden), img[:, 8 * hidden :].view(-1, 1, hidden),
            ta.weight_grads_reference(sc_h, sc_dz), w[: n_mm * hidden].view(n_mm, hidden),
            w[n_mm * hidden : -8].view(hidden, 8), w[-8:].view(1, 8))


@pytest.mark.parametrize("sms", [1, 2])
@pytest.mark.parametrize("transcendental", [True, False], ids=["sincos", "no_sincos"])
def test_no_accum_pass_layout_sums_to_the_plain_passes(transcendental, sms):
    """accum=False on the pass route (bf16, a 2 x 64 trunk, 2 images, P = 456:
    four 128-row tiles, the last ragged): the slots and scratch have the
    plan's layout (two CTAs of two tiles an image on a card of one SM, four
    of one on two SMs), their per-CTA sums are bitwise those of
    siren_step.bwd_passes_reference (the same slot sums; dWs h^T dz over the
    scratch to 1e-5 x max, a float32 einsum against the plain pass
    product)."""
    hidden, npix = 64, 456
    ops = _torch(_operands(6, batch=2, npix=npix, hidden=hidden))
    kw = _kw("bfloat16", True)
    assert ta.bwd_route("bfloat16", hidden, L) == "passes"
    plan = ta.bwd_plan(ops[0], ops[1], ops[3], sms)
    assert plan.bwd and plan.weight_grads and plan.npix == npix
    assert (plan.tiles_per_cta, plan.chunks) == ((2, 2) if sms == 1 else (1, 4))
    got = ta.bwd_variant_reference(*ops, accum=False, transcendental=transcendental, plan=plan,
                                   **kw)
    part_img, part_w, sc_h, sc_dz = got
    assert part_img.shape == (2, plan.chunks, 9 * hidden)
    assert part_w.shape == (2 * plan.chunks, plan.n_w)
    assert sc_h.shape == sc_dz.shape == (L, 2 * npix, hidden) and sc_h.dtype == torch.bfloat16
    pkw = dict(kw, sincos=ta._sincos(transcendental, True))
    ref = ts.bwd_passes_reference(False, ops[:7], ops[7], pkw, weight_grads=True, sms=sms)
    sums = _slot_sums(plan, *got)
    for name, x, y in zip(("dA", "db0", "dWs", "dbs", "dWf", "dbf"), sums, ref):
        if name == "dWs":
            _assert_rel(x, y, 1e-5, name)
        else:
            assert torch.equal(x, y), name
    # accum=True with the plan: the plain passes' results, within the bf16
    # bars of the plain backward
    whole = ta.bwd_variant_reference(*ops, transcendental=transcendental, plan=plan, **kw)
    assert all(torch.equal(x, y) for x, y in zip(whole, ref))
    chain = ta.bwd_variant_reference(*ops, transcendental=transcendental, **kw)
    for name, x, y in zip(("dA", "db0", "dWs", "dbs", "dWf", "dbf"), whole, chain):
        _assert_rel(x, y, 2.5e-3, name)


@pytest.mark.parametrize(
    "variant",
    [dict(transcendental=False), dict(transcendental=False, weight_grads=False),
     dict(transcendental=False, accum=False), dict(accum=False)],
    ids=["no_sincos", "mxu_only", "no_sincos_no_accum", "no_accum"],
)
def test_pass_route_variants_plain_match_jax_bf16(variant):
    """The backward probes on the pass route (bf16, H = 128) through the
    plain passes against the Pallas probe in interpret mode, at the bars of
    test_variants_plain_match_jax_bf16: every gradient within 2.5e-3 of its
    largest entry. accum=False depends on the tiling, so one image and one
    tile there: the probe writes the whole gradient and the port's slots and
    scratch sum to it."""
    accum = variant.get("accum", True)
    ops = _operands(7, batch=B if accum else 1, npix=P if accum else TILE)
    assert ta.bwd_route("bfloat16", H, L) == "passes"
    ref = _jax_bwd(ops, "bfloat16", True, **variant)
    plan = ta.bwd_plan(*_torch(ops)[:2], _torch(ops)[3], sms=1)
    got = ta.bwd_variant_reference(*_torch(ops), plan=plan, **variant, **_kw("bfloat16", True))
    if not accum:
        got = _slot_sums(plan, *got)
    n = 6 if variant.get("weight_grads", True) else 2
    for name, x, y in zip(("dA", "db0", "dWs", "dbs", "dWf", "dbf")[:n], got, ref):
        _assert_rel(x, y.reshape(x.shape), 2.5e-3, (variant, name))
    assert all(x is None for x in got[n:])


def test_probe_wrappers_refuse_cpu_tensors():
    """A probe wrapper launches its kernel or raises: CPU tensors are refused
    and nothing is counted; a variant that does not exist is named."""
    ops = _torch(_operands(5))
    kw = _kw("bfloat16", True)
    before = (ta.fwd_variant_cuda.launches, ta.bwd_variant_cuda.launches,
              ta.weight_grads_cuda.launches)
    for call in (
        lambda: ta.fwd_variant_cuda(*ops[:7], transcendental=False, **kw),
        lambda: ta.fwd_variant_cuda(*ops[:7], interleave=2, **kw),
        lambda: ta.fwd_variant_cuda(*ops[:7], **kw),
        lambda: ta.bwd_variant_cuda(*ops, accum=False, **kw),
        lambda: ta.bwd_variant_cuda(*ops, weight_grads=False, **kw),
        lambda: ta.weight_grads_cuda(torch.zeros(2, 64, 32), torch.zeros(2, 64, 32)),
    ):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="no forward variant"):
        ta.fwd_variant_cuda(*ops[:7], interleave=3, **kw)
    assert before == (ta.fwd_variant_cuda.launches, ta.bwd_variant_cuda.launches,
                      ta.weight_grads_cuda.launches)
