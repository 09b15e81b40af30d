"""The CUDA kernels of reni_tpu_torch.kernels.siren_fwd, siren_bwd, siren_step
and anatomy against their plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU and
skips without one; this file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from reni_tpu_torch.core import encodings
from reni_tpu_torch.kernels import anatomy as ta
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.kernels import siren_step as ts

# bf16-trunk bars of the JAX package's test_fused_bf16_trunk_close
BF16_MAX, BF16_MEAN = 0.05, 0.01
# float32-trunk bars of test_fused_forward_matches_jnp (exact sine) and
# test_fused_apply_fast_sine_matches_fast_jnp (fast sine)
F32_MAX = {False: 1e-5, True: 2e-5}


def _assert_close(out, ref, trunk, fast_sine, what):
    err = (out - ref).abs()
    mx, mean = err.max().item(), err.mean().item()
    if trunk == "float32":
        assert mx < F32_MAX[fast_sine], (what, mx, mean)
    else:
        assert mx < BF16_MAX and mean < BF16_MEAN, (what, mx, mean)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _decoder(rng, equiv, N, H, L, film, device):
    """Random decoder params in the JAX layout, SIREN-scaled."""
    def linear(n_in, n_out, bound):
        return {"w": _uniform(rng, (n_in, n_out), bound),
                "b": _uniform(rng, (n_out,), 1 / math.sqrt(n_in))}

    hidden = math.sqrt(6 / H) / (25.0 if film else 30.0)
    if film:
        s_in, m_in = encodings.film_in_features(equiv, N)
        layers = [linear(s_in, H, 1 / s_in)] + [linear(H, H, hidden) for _ in range(L - 1)]
        mapping = {"layers": [linear(m_in, 64, 0.1)], "last": linear(64, 2 * L * H, 0.02)}
        tree = {"layers": layers, "final": linear(H, 3, hidden), "mapping": mapping}
    else:
        n_in = encodings.concat_in_features(equiv, N)
        layers = [linear(n_in, H, 1 / n_in)] + [linear(H, H, hidden) for _ in range(L)]
        tree = {"layers": layers, "final": linear(H, 3, hidden)}

    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v) for v in t]
        return torch.as_tensor(t, device=device)

    return to(tree)


def _run(fn, dec, equiv, N, Z, D, film, L, H, trunk, fast_sine):
    kw = dict(hidden_layers=L, hidden_features=H, out_features=3,
              output_activation="tanh", trunk=trunk, fast_sine=fast_sine)
    if film:
        return fn(dec, equiv, Z, D, **kw)
    return fn(dec, equiv, N, Z, D, first_omega_0=30.0, hidden_omega_0=30.0, **kw)


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
@pytest.mark.parametrize("equiv", ["SO3", "SO2", "None"])
def test_kernel_matches_plain(cuda, equiv, film, trunk, fast_sine):
    """Shared and per-image grids, a ragged tail tile (P = 264 is not a
    multiple of the 64-row CTA tile), H = 128 and 256."""
    rng = np.random.default_rng(0)
    N, B = 7, 3
    for H, L, P, per_image in ((128, 2, 256, False), (256, 3, 264, True), (128, 1, 64, False)):
        dec = _decoder(rng, equiv, N, H, L, film, cuda)
        Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
        D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
        D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
        wrap = tk.fused_film_apply if film else tk.fused_apply
        ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
        n0 = wrap.launches
        out = _run(wrap, dec, equiv, N, Z, D, film, L, H, trunk, fast_sine)
        ref = _run(ref_fn, dec, equiv, N, Z, D, film, L, H, trunk, fast_sine)
        torch.cuda.synchronize()
        assert wrap.launches == n0 + 1
        assert out.shape == (B, P, 3) and torch.isfinite(out).all()
        _assert_close(out, ref, trunk, fast_sine, (H, L, P))


def test_stride0_grid_is_shared(cuda):
    rng = np.random.default_rng(1)
    dec = _decoder(rng, "SO2", 5, 128, 2, False, cuda)
    Z = torch.as_tensor(rng.normal(size=(4, 5, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, 128, 3, device=cuda), dim=-1)
    a = _run(tk.fused_apply, dec, "SO2", 5, Z, D, False, 2, 128, "bfloat16", True)
    b = _run(tk.fused_apply, dec, "SO2", 5, Z, D.expand(4, 128, 3), False, 2, 128,
             "bfloat16", True)
    assert torch.equal(a, b)


def _pack(dec, equiv, N, Z, D, film, H):
    d_feats = encodings.d_features(equiv, D)
    if film:
        return tk.pack_film_inputs(dec, equiv, Z, d_feats, H)
    return tk.pack_inputs(dec, equiv, N, Z, d_feats)


def _bwd_pair(film):
    if film:
        return tb.film_trunk_bwd_cuda, tb.film_trunk_bwd_reference
    return tb.siren_trunk_bwd_cuda, tb.siren_trunk_bwd_reference


def _assert_grads_close(got, ref, trunk, what):
    """Each gradient within (1e-2 bf16, 1e-4 float32) x max |plain|."""
    rel = 1e-2 if trunk == "bfloat16" else 1e-4
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            assert x is None, (what, i)
            continue
        assert x.shape == y.shape and torch.isfinite(x).all(), (what, i)
        if not y.numel():  # dWs of a one-layer FiLM trunk
            continue
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        assert err <= rel * scale, (what, i, err, scale)


@pytest.mark.parametrize("weight_grads", [True, False], ids=["wgrad", "no_wgrad"])
@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
@pytest.mark.parametrize("equiv", ["SO3", "SO2", "None"])
def test_bwd_kernel_matches_plain(cuda, equiv, film, trunk, fast_sine, weight_grads):
    """Every gradient of the backward kernel against its plain version:
    shared and per-image grids, a ragged tail tile (P = 264), H = 128 and
    256, one trunk layer, and at least 4 CTAs per image."""
    rng = np.random.default_rng(20)
    N, B = 7, 3
    kernel, plain = _bwd_pair(film)
    for H, L, P, per_image in ((128, 2, 256, False), (256, 3, 264, True), (128, 1, 64, False)):
        dec = _decoder(rng, equiv, N, H, L, film, cuda)
        Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
        D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
        D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
        ops = _pack(dec, equiv, N, Z, D, film, H)
        g = torch.as_tensor(rng.normal(size=(B, P, 8)).astype(np.float32), device=cuda)
        kw = dict(trunk=trunk, fast_sine=fast_sine, weight_grads=weight_grads)
        if not film:
            kw.update(omega0=30.0, omega_h=30.0)
        assert tb.launch_grid(P, B, trunk, cuda)[1] >= 4
        n0 = kernel.launches
        got = kernel(*ops, g, **kw)
        ref = plain(*ops, g, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1
        _assert_grads_close(got, ref, trunk, (H, L, P))


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_bwd_kernel_walks_several_tiles_per_cta(cuda, film, monkeypatch):
    """Several tiles per CTA on each route: the passes (bf16 at H = 128, the
    wgmma design; float32, the tiled one; 128-row tiles) two per CTA, and
    the chain kernel (bf16 at H = 96, a width no pass design takes) 3 tiles
    per image (the last CTA has one). The per-image sums are the same as
    with the default grid, to float32 rounding, and bitwise the same from
    run to run."""
    rng = np.random.default_rng(21)
    N, B, L, P = 5, 3, 2, 264
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
    g = torch.randn(B, P, 8, device=cuda)
    kernel, plain = _bwd_pair(film)
    for trunk, H in (("float32", 128), ("bfloat16", 128), ("bfloat16", 96)):
        ops = _pack(_decoder(rng, "SO2", N, H, L, film, cuda), "SO2", N, Z, D, film, H)
        assert ts.pass_route(trunk, H, ops[2 if film else 3].shape[0]) is (H == 128)
        kw = dict(trunk=trunk, fast_sine=True, weight_grads=False)
        if not film:
            kw.update(omega0=30.0, omega_h=30.0)
        one = kernel(*ops, g, **kw)
        with monkeypatch.context() as m:
            m.setattr(tb, "launch_grid", lambda npix, b, t, dev: (
                3, math.ceil(npix / tb.tile_rows(t) / 3)))
            m.setattr(ts, "pass_grid", lambda npix, b, sms: (2, math.ceil(npix / 128 / 2)))
            three = kernel(*ops, g, **kw)
            again = kernel(*ops, g, **kw)
        ref = plain(*ops, g, **kw)
        torch.cuda.synchronize()
        _assert_grads_close(three, ref, trunk, f"several tiles per CTA, {trunk} {H}")
        for x, y, z in zip(one, three, again):
            if x is not None:
                assert torch.equal(y, z)
                assert (x - y).abs().max().item() <= 1e-5 * x.abs().max().item()


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_fused_apply_backward_launches_both_kernels(cuda, film):
    """One autograd backward through fused_apply on the card launches a
    forward and the backward once each, and its gradients (latents and every
    decoder weight) match the plain Function's. On the passes' routes (bf16
    at H = 128 the wgmma passes, float32 the tiled ones) the forward is the
    passes' (siren_step.passes_forward, whose scratch the backward reads),
    not the forward kernel."""
    rng = np.random.default_rng(22)
    N, B, H, L, P = 5, 3, 128, 2, 200
    dec = _decoder(rng, "SO2", N, H, L, film, cuda)
    Z0 = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    kernel = _bwd_pair(film)[0]
    leaves = [dec["final"]["w"], dec["layers"][-1]["w"], dec["layers"][0]["b"]]

    def grads(fn, trunk):
        Z = Z0.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        out = _run(fn, dec, "SO2", N, Z, D, film, L, H, trunk, True)
        (out ** 2).sum().backward()
        got = [Z.grad] + [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return got

    for trunk, passes in (("bfloat16", 1), ("float32", 1)):
        counts = lambda: (wrap.launches, ts.passes_forward.launches, kernel.launches)
        n0 = counts()
        got = grads(wrap, trunk)
        torch.cuda.synchronize()
        assert counts() == (n0[0] + 1 - passes, n0[1] + passes, n0[2] + 1), trunk
        ref = grads(ref_fn, trunk)
        assert counts() == (n0[0] + 1 - passes, n0[1] + passes, n0[2] + 1), trunk
        _assert_grads_close(got, ref, trunk, f"fused_apply backward, {trunk}")


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_model_apply_with_grad_outside_bwd_limit_raises(cuda, film):
    """H = 512 with 5 layers, which the backward's chain kernel declined
    before the tiled passes: with a latent that requires grad RENIModel.apply
    now trains through the kernels (the tiled passes' forward and backward,
    no plain PyTorch on the card), its latent gradient within the bf16 bar of
    the plain bf16 Function's; a bf16 width that is not a multiple of 64 past the
    chain kernel's depth still raises."""
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel

    rng = np.random.default_rng(23)
    cfg = RENIConfig(conditioning="FiLM" if film else "Cond-by-Concat", latent_dim=5,
                     hidden_layers=5, hidden_features=512, mapping_layers=1,
                     mapping_features=64, use_pallas=True, fast_sine=True,
                     output_activation="tanh", first_omega_0=30.0, hidden_omega_0=30.0)
    dec = _decoder(rng, "SO2", 5, 512, 5, film, cuda)
    D = torch.nn.functional.normalize(torch.randn(1, 64, 3, device=cuda), dim=-1)
    Z0 = torch.as_tensor(rng.normal(size=(2, 5, 3)).astype(np.float32), device=cuda)
    model = RENIModel(cfg)
    assert model.apply({"decoder": dec}, Z0, D).shape == (2, 64, 3)
    tiled, fwd = ts.pass_calls("tiled", "bfloat16"), ts.passes_forward.launches
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    grads = []
    for kernel in (True, False):  # the kernels through apply; the plain bf16 Function
        Z = Z0.clone().requires_grad_()
        out = (model.apply({"decoder": dec}, Z, D) if kernel
               else _run(ref_fn, dec, "SO2", 5, Z, D, film, 5, 512, "bfloat16", True))
        (out ** 2).sum().backward()
        grads.append(Z.grad)
    torch.cuda.synchronize()
    assert ts.pass_calls("tiled", "bfloat16") == tiled + 2  # forward, backward
    assert ts.passes_forward.launches == fwd + 1
    err, scale = (grads[0] - grads[1]).abs().max().item(), grads[1].abs().max().item()
    assert torch.isfinite(grads[0]).all() and err <= 1e-2 * scale, (err, scale)
    deep = RENIModel(dataclasses.replace(cfg, hidden_features=96, hidden_layers=21 - film))
    with pytest.raises(ValueError, match="shared memory"):
        deep.apply({"decoder": _decoder(rng, "SO2", 5, 96, 21 - film, film, cuda)},
                   Z0.clone().requires_grad_(), D)


def test_bwd_smem_formula_matches_kernel(cuda):
    """The chain backward's layout and, for the backward's new routes, the
    tiled passes' (tiled_smem_bytes: the product's ring of K-slabs of one
    column block, whatever the width) as each library reports them."""
    lib = tb.library()
    for film in (False, True):
        for trunk in tk.TRUNKS:
            for H, n_mm in ((128, 2), (256, 5), (256, 4), (512, 1), (64, 0)):
                got = lib.reni_bwd_smem_bytes(int(film), int(trunk == "bfloat16"), H, n_mm)
                assert got == tb.bwd_smem_bytes(film, trunk, H, n_mm)
            tiled = ts.tiled_library(film, trunk)
            for H in (64, 320, 384, 512, 1024, 1152, 2048, 4096):
                assert tiled.smem_bytes(H) == ts.tiled_smem_bytes(trunk, H)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_model_apply_on_card_takes_kernel_or_raises(cuda, film):
    """RENIModel.apply on the card: width 6 (P = 18, not a multiple of 8)
    and H = 32 go through the kernel; a hidden width the kernel cannot
    take raises instead of decoding with plain PyTorch on the card."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel

    rng = np.random.default_rng(3)
    D = sphere.get_directions(6, device=cuda)
    Z = torch.as_tensor(rng.normal(size=(2, 5, 3)).astype(np.float32), device=cuda)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    for H, ok in ((32, True), (24, False)):
        cfg = RENIConfig(conditioning="FiLM" if film else "Cond-by-Concat", latent_dim=5,
                         hidden_layers=2, hidden_features=H, mapping_layers=1,
                         mapping_features=64, use_pallas=True, fast_sine=True)
        dec = _decoder(rng, "SO2", 5, H, 2, film, cuda)
        model = RENIModel(cfg)
        n0 = wrap.launches
        if not ok:
            with pytest.raises(ValueError, match="multiple of 16"):
                model.apply({"decoder": dec}, Z, D)
            assert wrap.launches == n0
            continue
        with torch.inference_mode():
            out = model.apply({"decoder": dec}, Z, D)
        assert wrap.launches == n0 + 1 and out.shape == (2, 18, 3)


def test_bwd_weight_grads_bitwise_equal_across_calls(cuda):
    """The weight gradients take no float atomics: two calls on the same
    inputs give the same bits, with several CTAs per image and several
    chunks of the split-K product per weight."""
    rng = np.random.default_rng(24)
    N, B, H, L, P = 5, 3, 128, 2, 264
    for film in (False, True):
        dec = _decoder(rng, "SO2", N, H, L, film, cuda)
        Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
        D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
        ops = _pack(dec, "SO2", N, Z, D, film, H)
        g = torch.randn(B, P, 8, device=cuda)
        kw = dict(trunk="bfloat16", fast_sine=True, weight_grads=True)
        if not film:
            kw.update(omega0=30.0, omega_h=30.0)
        assert tb.wgrad_chunks(B * P, H, L, "bfloat16", cuda)[1] >= 4
        kernel = _bwd_pair(film)[0]
        one, two = kernel(*ops, g, **kw), kernel(*ops, g, **kw)
        torch.cuda.synchronize()
        for x, y in zip(one, two):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the train-step kernel
# ---------------------------------------------------------------------------

STEP_BAR = {"bfloat16": (1e-4, 1e-2), "float32": (1e-6, 1e-4)}  # loss rel, gradient rel


def _step_operands(rng, cuda, equiv, N, H, L, B, P, per_image, expand=False):
    dec = _decoder(rng, equiv, N, H, L, False, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
    ops = _pack(dec, equiv, N, Z, D, False, H)
    if expand:  # a (B, P, 8) view with batch stride 0: one shared grid
        ops = (ops[0].expand(B, P, 8), *ops[1:])
    tgt = torch.zeros(B, P, 8, device=cuda)
    tgt[..., :3] = torch.as_tensor(rng.normal(size=(B, P, 3)).astype(np.float32))
    sw = torch.zeros(1, P, 8, device=cuda)
    sw[..., :3] = torch.as_tensor(np.abs(rng.normal(size=(1, P, 3))).astype(np.float32))
    bm = torch.ones(B, 1, 8, device=cuda)
    bm[-1] = 0.0  # a masked row
    return dec, Z, D, (*ops, tgt, sw, bm)


def _step_ctas_per_image(P, B, trunk, H, n_mm, cuda):
    """CTAs per image of the step's route: the passes' 128-row grid or the
    chain kernel's."""
    if ts.pass_route(trunk, H, n_mm):
        return ts.pass_grid(P, B, torch.cuda.get_device_properties(cuda).multi_processor_count)[1]
    return tb.launch_grid(P, B, trunk, cuda)[1]


def _assert_step_close(got, ref, trunk, what):
    loss_rel, grad_rel = STEP_BAR[trunk]
    mse, mse_ref = got[0].sum().item(), ref[0].sum().item()
    assert abs(mse - mse_ref) <= loss_rel * abs(mse_ref), (what, mse, mse_ref)
    assert got[0][0, 3:].abs().max().item() == 0.0
    for i, (x, y) in enumerate(zip(got[1:], ref[1:])):
        assert x.shape == y.shape and torch.isfinite(x).all(), (what, i)
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        assert err <= grad_rel * scale, (what, i, err, scale)


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("act", ["tanh", "exp", None])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_step_kernel_matches_plain(cuda, trunk, act, fast_sine):
    """The loss partials and every gradient of the step kernel against its
    plain version: hidden_layers 1, 2 and 5, H = 128 and 256, a ragged tail
    tile (P = 264), shared, per-image and stride-0 grids, a masked row,
    several CTAs per image and several split-K chunks per weight; two calls
    give the same bits. Bars: loss 1e-4 (bf16) / 1e-6 (float32) relative,
    each gradient 1e-2 / 1e-4 x max |plain|."""
    rng = np.random.default_rng(30)
    N, B = 7, 3
    kw = dict(omega0=30.0, omega_h=30.0, trunk=trunk, fast_sine=fast_sine, out_act=act)
    for equiv, H, L, P, per_image, expand in (
        ("SO2", 128, 2, 256, False, False), ("SO3", 256, 5, 264, True, False),
        ("SO2", 128, 1, 264, False, True), ("None", 32, 2, 100, False, False),
    ):
        _, _, _, ops = _step_operands(rng, cuda, equiv, N, H, L, B, P, per_image, expand)
        if H >= 128:
            assert _step_ctas_per_image(P, B, trunk, H, L, cuda) >= 2
            assert tb.wgrad_chunks(B * P, H, L, trunk, cuda)[1] >= 4
        n0 = ts.siren_step_cuda.launches
        got = ts.siren_step_cuda(*ops, gscale=1.0 / (3 * P), **kw)
        again = ts.siren_step_cuda(*ops, gscale=1.0 / (3 * P), **kw)
        ref = ts.siren_step_reference(*ops, gscale=1.0 / (3 * P), **kw)
        torch.cuda.synchronize()
        assert ts.siren_step_cuda.launches == n0 + 2
        _assert_step_close(got, ref, trunk, (equiv, H, L, P))
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        assert got[1][-1].abs().max().item() == 0.0  # the masked row: dA = 0


def test_step_kernel_walks_several_tiles_per_cta(cuda, monkeypatch):
    """The passes with three 128-row tiles per CTA: 8 tiles per image (P =
    900, the last ragged), so the last CTA of an image walks two."""
    rng = np.random.default_rng(31)
    _, _, _, ops = _step_operands(rng, cuda, "SO2", 5, 128, 2, 3, 900, False)
    kw = dict(omega0=30.0, omega_h=30.0, trunk="bfloat16", fast_sine=True, out_act="tanh",
              gscale=1.0 / (3 * 900))
    monkeypatch.setattr(ts, "pass_grid", lambda npix, b, sms: (3, math.ceil(npix / 128 / 3)))
    assert ts.step_plan_cuda(False, ops, cuda).chunks == 3
    got = ts.siren_step_cuda(*ops, **kw)
    ref = ts.siren_step_reference(*ops, **kw)
    torch.cuda.synchronize()
    _assert_step_close(got, ref, "bfloat16", "3 tiles per CTA")


def test_fused_step_mse_launches_the_step_kernel_only(cuda):
    """fused_step_mse and its backward on the card launch the step kernel
    once and neither the forward nor the backward kernel; the gradients
    (latents and every decoder leaf) match the plain Function's."""
    rng = np.random.default_rng(32)
    N, B, H, L, P = 5, 4, 128, 2, 200
    dec, Z0, D, ops = _step_operands(rng, cuda, "SO2", N, H, L, B, P, False)
    tgt, sw, bm = ops[-3][..., :3], ops[-2][..., :3], ops[-1][:, 0, 0]
    leaves = [t for layer in dec["layers"] for t in layer.values()] + list(dec["final"].values())
    kw = dict(hidden_layers=L, hidden_features=H, out_features=3, first_omega_0=30.0,
              hidden_omega_0=30.0, output_activation="tanh", trunk="bfloat16", fast_sine=True)

    def grads(fn):
        Z = Z0.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        loss = fn(dec, "SO2", N, Z, D, tgt, sw, bm, **kw)
        (3.0 * loss).backward()
        got = [Z.grad] + [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return loss.item(), got

    counts = lambda: (ts.siren_step_cuda.launches, tk.fused_apply.launches,
                      tb.siren_trunk_bwd_cuda.launches)
    n0 = counts()
    loss, got = grads(ts.fused_step_mse)
    torch.cuda.synchronize()
    assert counts() == (n0[0] + 1, n0[1], n0[2])
    loss_ref, ref = grads(ts.fused_step_mse_reference)
    assert counts() == (n0[0] + 1, n0[1], n0[2])
    assert abs(loss - loss_ref) <= 1e-4 * abs(loss_ref)
    _assert_grads_close(got, ref, "bfloat16", "fused_step_mse backward")


def test_step_smem_formula_matches_kernel(cuda):
    """The shared memory of each route's layout, as the library reports it,
    equals its mirror: chain_smem_bytes for the chain kernel,
    pass_smem_bytes for the passes (pass_route alone picks between them)."""
    lib = ts.library()
    for trunk in tk.TRUNKS:
        for H, n_mm in ((128, 2), (256, 5), (256, 1), (512, 1), (32, 3), (96, 2), (256, 12),
                        (64, 1)):
            got = lib.smem_bytes(int(trunk == "bfloat16"), H, n_mm)
            assert got == ts.chain_smem_bytes(trunk, H, n_mm)
    for H in (64, 128, 192, 256, 320):
        assert lib.pass_smem_bytes(H) == ts.pass_smem_bytes(H)


def test_fit_decoder_step_on_card_takes_the_step_kernel(cuda):
    """One FIT_DECODER step of a fresh VAD on the card: the step kernel
    launches once, the forward and backward kernels do not, and every
    trainable leaf moves."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.params import tree_leaves
    from reni_tpu_torch.train import tasks
    from reni_tpu_torch.train.optim import OptimConfig

    model = RENIModel(RENIConfig(latent_dim=5, hidden_layers=2, hidden_features=64,
                                 use_pallas=True, fast_sine=True))
    params = model.init(torch.Generator().manual_seed(0), 6, device=cuda)
    state = tasks.init_train_state(model, params, OptimConfig(lr_start=1e-3, lr_end=1e-4),
                                   torch.Generator().manual_seed(1))
    step = tasks.make_fit_decoder_step(model, sphere.get_directions(16, device=cuda),
                                       sphere.get_sineweight(16, device=cuda),
                                       kld_weighting=1e-4)
    imgs = torch.rand(4, 128, 3, device=cuda)
    batch = (imgs, torch.tensor([0, 1, 2, 0], device=cuda),
             torch.tensor([1.0, 1.0, 1.0, 0.0], device=cuda))
    before = [t.detach().clone() for t in tree_leaves(state.trainable)]
    n0 = (ts.siren_step_cuda.launches, tk.fused_apply.launches, tb.siren_trunk_bwd_cuda.launches)
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (ts.siren_step_cuda.launches, tk.fused_apply.launches,
            tb.siren_trunk_bwd_cuda.launches) == (n0[0] + 1, n0[1], n0[2])
    assert set(metrics) == {"loss", "mse_loss", "kld_loss"}
    assert all(torch.isfinite(v) for v in metrics.values())
    for old, new in zip(before, tree_leaves(state.trainable)):
        assert not torch.equal(old, new)


# ---------------------------------------------------------------------------
# the FiLM train-step kernel
# ---------------------------------------------------------------------------


def _film_step_operands(rng, cuda, equiv, N, H, T, B, P, per_image, expand=False):
    dec = _decoder(rng, equiv, N, H, T, True, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
    ops = _pack(dec, equiv, N, Z, D, True, H)
    if expand:  # a (B, P, 8) view with batch stride 0: one shared grid
        ops = (ops[0].expand(B, P, 8), *ops[1:])
    tgt = torch.zeros(B, P, 8, device=cuda)
    tgt[..., :3] = torch.as_tensor(rng.normal(size=(B, P, 3)).astype(np.float32))
    sw = torch.zeros(1, P, 8, device=cuda)
    sw[..., :3] = torch.as_tensor(np.abs(rng.normal(size=(1, P, 3))).astype(np.float32))
    bm = torch.ones(B, 1, 8, device=cuda)
    bm[-1] = 0.0  # a masked row
    return dec, Z, D, (*ops, tgt, sw, bm)


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("act", ["tanh", "exp", None])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_film_step_kernel_matches_plain(cuda, trunk, act, fast_sine):
    """The loss partials and every gradient (dfreqs and dphases included) of
    the FiLM step kernel against its plain version: 1, 2, 3 and 5 trunk
    layers (one layer has no H x H product), H = 32, 128 and 256, SO2, SO3
    and None, a ragged tail tile (P = 264), shared, per-image and stride-0
    grids, a masked row, several CTAs per image and several split-K chunks
    per weight; two calls give the same bits. Bars: loss 1e-4 (bf16) / 1e-6
    (float32) relative, each gradient 1e-2 / 1e-4 x max |plain|."""
    rng = np.random.default_rng(40)
    N, B = 7, 3
    kw = dict(trunk=trunk, fast_sine=fast_sine, out_act=act)
    for equiv, H, T, P, per_image, expand in (
        ("SO2", 128, 3, 256, False, False), ("SO3", 256, 5, 264, True, False),
        ("SO2", 128, 1, 264, False, True), ("None", 32, 2, 100, False, False),
    ):
        _, _, _, ops = _film_step_operands(rng, cuda, equiv, N, H, T, B, P, per_image, expand)
        if H >= 128:
            assert _step_ctas_per_image(P, B, trunk, H, T - 1, cuda) >= 2
            assert T == 1 or tb.wgrad_chunks(B * P, H, T - 1, trunk, cuda)[1] >= 4
        n0 = ts.film_step_cuda.launches
        got = ts.film_step_cuda(*ops, gscale=1.0 / (3 * P), **kw)
        again = ts.film_step_cuda(*ops, gscale=1.0 / (3 * P), **kw)
        ref = ts.film_step_reference(*ops, gscale=1.0 / (3 * P), **kw)
        torch.cuda.synchronize()
        assert ts.film_step_cuda.launches == n0 + 2
        assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in ref]
        assert tuple(got[2].shape) == (T - 1, H, H) and tuple(got[3].shape) == (T, H)
        loss_rel, grad_rel = STEP_BAR[trunk]
        mse, mse_ref = got[0].sum().item(), ref[0].sum().item()
        assert abs(mse - mse_ref) <= loss_rel * abs(mse_ref), ((equiv, H, T, P), mse, mse_ref)
        assert got[0][0, 3:].abs().max().item() == 0.0
        _assert_grads_close(got[1:], ref[1:], trunk, (equiv, H, T, P))
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        # the masked row: dA0, dfreqs and dphases are exact zeros
        for i in (1, 6, 7):
            assert got[i][-1].abs().max().item() == 0.0


def test_film_step_kernel_walks_several_tiles_per_cta(cuda, monkeypatch):
    """The FiLM passes with three 128-row tiles per CTA: 8 tiles per image (P
    = 900, the last ragged), so the last CTA of an image walks two."""
    rng = np.random.default_rng(41)
    _, _, _, ops = _film_step_operands(rng, cuda, "SO2", 5, 128, 3, 3, 900, False)
    kw = dict(trunk="bfloat16", fast_sine=True, out_act="tanh", gscale=1.0 / (3 * 900))
    monkeypatch.setattr(ts, "pass_grid", lambda npix, b, sms: (3, math.ceil(npix / 128 / 3)))
    assert ts.step_plan_cuda(True, ops, cuda).chunks == 3
    got = ts.film_step_cuda(*ops, **kw)
    ref = ts.film_step_reference(*ops, **kw)
    torch.cuda.synchronize()
    assert abs(got[0].sum().item() - ref[0].sum().item()) <= 1e-4 * abs(ref[0].sum().item())
    _assert_grads_close(got[1:], ref[1:], "bfloat16", "3 tiles per CTA")


def test_fused_film_step_mse_launches_the_step_kernel_only(cuda):
    """fused_film_step_mse and its backward on the card launch the FiLM step
    kernel once and no forward or backward kernel; the gradients (latents,
    trunk, final layer and mapping network) match the plain Function's."""
    rng = np.random.default_rng(42)
    N, B, H, T, P = 5, 4, 128, 3, 200
    dec, Z0, D, ops = _film_step_operands(rng, cuda, "SO2", N, H, T, B, P, False)
    tgt, sw, bm = ops[-3][..., :3], ops[-2][..., :3], ops[-1][:, 0, 0]
    leaves = [t for layer in dec["layers"] for t in layer.values()]
    leaves += list(dec["final"].values()) + list(dec["mapping"]["last"].values())
    leaves += [t for layer in dec["mapping"]["layers"] for t in layer.values()]
    kw = dict(hidden_layers=T, hidden_features=H, out_features=3, output_activation="tanh",
              trunk="bfloat16", fast_sine=True)

    def grads(fn):
        Z = Z0.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        loss = fn(dec, "SO2", Z, D, tgt, sw, bm, **kw)
        (3.0 * loss).backward()
        got = [Z.grad] + [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return loss.item(), got

    counts = lambda: (ts.film_step_cuda.launches, ts.siren_step_cuda.launches,
                      tk.fused_film_apply.launches, tb.film_trunk_bwd_cuda.launches)
    n0 = counts()
    loss, got = grads(ts.fused_film_step_mse)
    torch.cuda.synchronize()
    assert counts() == (n0[0] + 1, *n0[1:])
    loss_ref, ref = grads(ts.fused_film_step_mse_reference)
    assert counts() == (n0[0] + 1, *n0[1:])
    assert abs(loss - loss_ref) <= 1e-4 * abs(loss_ref)
    _assert_grads_close(got, ref, "bfloat16", "fused_film_step_mse backward")


def test_film_step_smem_formula_matches_kernel(cuda):
    """The FiLM counterpart of test_step_smem_formula_matches_kernel: the
    chain kernel's layout at every shape, one trunk layer (n_mm = 0) too."""
    lib = ts.library(film=True)
    for trunk in tk.TRUNKS:
        for H, n_mm in ((128, 2), (256, 4), (256, 0), (512, 1), (32, 3), (96, 2), (256, 12),
                        (64, 1)):
            got = lib.smem_bytes(int(trunk == "bfloat16"), H, n_mm)
            assert got == ts.chain_smem_bytes(trunk, H, n_mm, film=True)
    for H in (64, 128, 192, 256, 320):
        assert lib.pass_smem_bytes(H) == ts.pass_smem_bytes(H)


def test_fit_decoder_step_on_card_takes_the_film_step_kernel(cuda):
    """One FIT_DECODER step of a fresh FiLM VAD on the card: the FiLM step
    kernel launches once, no forward or backward kernel does, and every
    trainable leaf (the mapping network included) moves."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.params import tree_leaves
    from reni_tpu_torch.train import tasks
    from reni_tpu_torch.train.optim import OptimConfig

    model = RENIModel(RENIConfig(conditioning="FiLM", latent_dim=5, hidden_layers=2,
                                 hidden_features=64, mapping_layers=2, mapping_features=32,
                                 use_pallas=True, fast_sine=True))
    params = model.init(torch.Generator().manual_seed(0), 6, device=cuda)
    state = tasks.init_train_state(model, params, OptimConfig(lr_start=1e-3, lr_end=1e-4),
                                   torch.Generator().manual_seed(1))
    step = tasks.make_fit_decoder_step(model, sphere.get_directions(16, device=cuda),
                                       sphere.get_sineweight(16, device=cuda),
                                       kld_weighting=1e-4)
    imgs = torch.rand(4, 128, 3, device=cuda)
    batch = (imgs, torch.tensor([0, 1, 2, 0], device=cuda),
             torch.tensor([1.0, 1.0, 1.0, 0.0], device=cuda))
    before = [t.detach().clone() for t in tree_leaves(state.trainable)]
    counts = lambda: (ts.film_step_cuda.launches, tk.fused_film_apply.launches,
                      tb.film_trunk_bwd_cuda.launches)
    n0 = counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert counts() == (n0[0] + 1, n0[1], n0[2])
    assert set(metrics) == {"loss", "mse_loss", "kld_loss"}
    assert all(torch.isfinite(v) for v in metrics.values())
    for old, new in zip(before, tree_leaves(state.trainable)):
        assert not torch.equal(old, new)


# ---------------------------------------------------------------------------
# the layer-major passes of both steps
# ---------------------------------------------------------------------------


def _pass_case(rng, cuda, film, H, n_mm, B, P, per_image=False):
    if film:
        return _film_step_operands(rng, cuda, "SO2", 7, H, n_mm + 1, B, P, per_image)[3]
    return _step_operands(rng, cuda, "SO2", 7, H, n_mm, B, P, per_image)[3]


def _pass_kw(film, P, act="tanh", fast_sine=True):
    kw = dict(trunk="bfloat16", fast_sine=fast_sine, out_act=act, gscale=1.0 / (3 * P))
    if not film:
        kw.update(omega0=30.0, omega_h=30.0)
    return kw


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("H,n_mm", [(256, 5), (64, 2), (192, 1)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_each_pass_matches_its_plain_pass(cuda, film, H, n_mm, fast_sine):
    """Each pass kernel against its plain pass on the same scratch (the
    plain chain up to it): every output it writes, max |diff| <= 1e-2 x max
    |plain| (h and dz are bf16 and sin(30 x) flips a rounding now and then),
    a ragged P and a masked row. Not counted as steps."""
    rng = np.random.default_rng(50)
    B, P = 3, 1000
    ops, kw = _pass_case(rng, cuda, film, H, n_mm, B, P), _pass_kw(film, P, fast_sine=fast_sine)
    plan = ts.step_plan_cuda(film, ops, cuda)
    ref = ts.PassWork.for_plan(plan, "bfloat16", cuda)
    steps = (ts.siren_step_cuda.launches, ts.film_step_cuda.launches)
    with torch.no_grad():
        for k in range(len(plan.passes)):
            got = ref.clone()
            ts.step_pass_cuda(plan, k, ops, kw, got)
            ts.step_pass_reference(plan, k, ops, kw, ref)
            torch.cuda.synchronize()
            outs = ts.pass_outputs(plan, k, got)
            for name, y in ts.pass_outputs(plan, k, ref).items():
                x, y = outs[name].float(), y.float()
                assert torch.isfinite(x).all(), (plan.passes[k], name)
                err, scale = (x - y).abs().max().item(), y.abs().max().item()
                assert err <= 1e-2 * scale, (plan.passes[k], name, err, scale)
    assert (ts.siren_step_cuda.launches, ts.film_step_cuda.launches) == steps


@pytest.mark.parametrize("npix", [512, 2048, 8192])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_steps_match_plain_at_fit_decoder_shapes(cuda, film, npix):
    """Both steps through the passes at FIT_DECODER's batch and stage
    shapes (100 x 512, 2,048, 8,192; 5 x 256, FiLM 5 trunk layers) and, at
    100 x 2,048, a trunk deeper than 5 hidden layers (8): against the plain
    step at the step bars, two calls bitwise equal."""
    rng = np.random.default_rng(51)
    B = 100
    n_mm = 4 if film else 5
    shapes = [(n_mm, npix)] + ([(7 if film else 8, npix)] if npix == 2048 else [])
    kernel = ts.film_step_cuda if film else ts.siren_step_cuda
    plain = ts.film_step_reference if film else ts.siren_step_reference
    for depth, P in shapes:
        ops, kw = _pass_case(rng, cuda, film, 256, depth, B, P), _pass_kw(film, P)
        assert ts.pass_route("bfloat16", 256, depth)
        with torch.no_grad():
            got, again = kernel(*ops, **kw), kernel(*ops, **kw)
            ref = plain(*ops, **kw)
            torch.cuda.synchronize()
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        _assert_step_close(got, ref, "bfloat16", (film, depth, P))
        del got, again, ref
        torch.cuda.empty_cache()


@pytest.mark.parametrize(
    "trunk,H,passes", [("bfloat16", 128, True), ("float32", 128, True), ("bfloat16", 96, False),
                       ("bfloat16", 32, False)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_step_route_on_card(cuda, film, trunk, H, passes, monkeypatch):
    """The routing rule on the card: bf16 widths that are not a multiple of
    64 take the chain kernel (no pass launches), bf16 at a multiple of 64
    the wgmma passes, the float32 trunk the tiled passes; each route matches
    the plain step."""
    calls = []
    real = ts._pass_call
    monkeypatch.setattr(ts, "_pass_call", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    rng = np.random.default_rng(52)
    ops = _pass_case(rng, cuda, film, H, 2, 3, 300)
    kw = {**_pass_kw(film, 300), "trunk": trunk}
    got = (ts.film_step_cuda if film else ts.siren_step_cuda)(*ops, **kw)
    ref = (ts.film_step_reference if film else ts.siren_step_reference)(*ops, **kw)
    torch.cuda.synchronize()
    assert bool(calls) is passes
    if film:
        assert abs(got[0].sum().item() - ref[0].sum().item()) <= STEP_BAR[trunk][0] * abs(
            ref[0].sum().item())
        _assert_grads_close(got[1:], ref[1:], trunk, (trunk, H))
    else:
        _assert_step_close(got, ref, trunk, (trunk, H))


# ---------------------------------------------------------------------------
# the anatomy probes
# ---------------------------------------------------------------------------


def _probe_operands(rng, cuda, H, L, B, P):
    dec = _decoder(rng, "SO2", 7, H, L, False, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, 7, 3)).astype(np.float32), device=cuda)
    D = rng.normal(size=(1, P, 3)).astype(np.float32)
    D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
    return _pack(dec, "SO2", 7, Z, D, False, H)


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_fwd_variants_match_plain(cuda, trunk, fast_sine):
    """The interleaved forwards give the bits of the kernel they rearrange
    (the shipped forward; interleave 4 on the fused route the row-tile
    kernel) and hold its bars against the plain version; the forward
    without sines is held to 1e-2 (bf16) / 1e-4 (float32) x max |plain| (its
    values are not bounded by 1). A ragged tail tile (P = 264)."""
    rng = np.random.default_rng(50)
    kw = dict(omega0=30.0, omega_h=30.0, trunk=trunk, fast_sine=fast_sine)
    for H, L, P in ((128, 2, 256), (256, 3, 264)):
        ops = _probe_operands(rng, cuda, H, L, 3, P)
        shipped = tk.siren_trunk_cuda(*ops, **kw)
        tile = tk.siren_trunk_cuda(*ops, route="tile", **kw)
        fused = tk.fwd_route(trunk, H, L) == "fused"
        assert fused == (trunk == "bfloat16")
        n0 = ta.fwd_variant_cuda.launches
        for il in (1, 2, 4):
            out = ta.fwd_variant_cuda(*ops, interleave=il, **kw)
            ref = ta.fwd_variant_reference(*ops, interleave=il, **kw)
            torch.cuda.synchronize()
            assert torch.equal(out, tile if fused and il == 4 else shipped), il
            _assert_close(out, ref, trunk, fast_sine, (H, L, P, il))
        out = ta.fwd_variant_cuda(*ops, transcendental=False, **kw)
        ref = ta.fwd_variant_reference(*ops, transcendental=False, **kw)
        torch.cuda.synchronize()
        assert ta.fwd_variant_cuda.launches == n0 + 4
        _assert_grads_close([out], [ref], trunk, (H, L, P, "no sine"))
    with pytest.raises(ValueError, match="no forward variant"):
        ta.fwd_variant_cuda(*ops, transcendental=False, interleave=2, **kw)


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_bwd_variants_match_plain(cuda, trunk, fast_sine):
    """Every backward variant against its plain version, each result within
    1e-2 (bf16) / 1e-4 (float32) x max |plain|: without sincos, without
    weight gradients, both, and without the reduction (the raw per-CTA slots
    and the scratch, several CTAs per image; the scratch of activations is a
    forward result and holds the forward's bars). The bf16 probes run the
    layer-major passes and are held against the plain passes in their slot
    layout (``plan``), the float32 ones the chain kernel in its (``grid``)."""
    rng = np.random.default_rng(51)
    kw = dict(omega0=30.0, omega_h=30.0, trunk=trunk, fast_sine=fast_sine)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for H, L, P in ((128, 2, 256), (256, 3, 264)):
        ops = _probe_operands(rng, cuda, H, L, 3, P)
        g = torch.as_tensor(rng.normal(size=(3, P, 8)).astype(np.float32), device=cuda)
        passes = ta.bwd_route(trunk, H, L) == "passes"
        assert passes == (trunk == "bfloat16")
        layout = (dict(plan=ta.bwd_plan(ops[0], ops[1], ops[3], sms)) if passes
                  else dict(grid=tb.launch_grid(P, 3, trunk, cuda)))
        assert (layout["plan"].chunks if passes else layout["grid"][1]) >= 2
        n0 = ta.bwd_variant_cuda.launches
        for variant in (dict(), dict(transcendental=False), dict(weight_grads=False),
                        dict(transcendental=False, weight_grads=False), dict(accum=False),
                        dict(transcendental=False, accum=False)):
            got = ta.bwd_variant_cuda(*ops, g, **variant, **kw)
            ref = ta.bwd_variant_reference(*ops, g, **layout, **variant, **kw)
            torch.cuda.synchronize()
            assert len(got) == len(ref) == (6 if variant.get("accum", True) else 4)
            got = [None if x is None else x.float() for x in got]
            ref = [None if x is None else x.float() for x in ref]
            if not variant.get("accum", True):
                h, h_ref = got.pop(2), ref.pop(2)
                if variant.get("transcendental", True):
                    _assert_close(h, h_ref, trunk, fast_sine, (H, L, P, variant))
                else:  # the linear stand-in's activations are not bounded by 1
                    _assert_grads_close([h], [h_ref], trunk, (H, L, P, variant))
            _assert_grads_close(got, ref, trunk, (H, L, P, variant))
        assert ta.bwd_variant_cuda.launches == n0 + 6


@pytest.mark.parametrize("H,L,P", [(128, 2, 256), (256, 5, 8192)])
def test_bwd_probes_run_the_shipped_passes(cuda, H, L, P):
    """On the pass route (bf16, H a multiple of 64) the backward probes run
    the passes, not the chain kernel: ``bwd`` and ``bwd_no_dw`` give the bits
    of ``siren_trunk_bwd_cuda``, every probe gives the same bits twice, the
    route counter says "passes", the pass entries of the step library and of
    the anatomy library are called and the chain kernel's anatomy entry is
    not; the weight-gradient product alone on the ``bwd_no_accum`` scratch
    gives the shipped dWs bit for bit (the same scratch and chunks)."""
    rng = np.random.default_rng(52)
    kw = dict(omega0=30.0, omega_h=30.0, trunk="bfloat16", fast_sine=True)
    ops = _probe_operands(rng, cuda, H, L, 3, P)
    g = torch.as_tensor(rng.normal(size=(3, P, 8)).astype(np.float32), device=cuda)
    assert ta.bwd_route("bfloat16", H, L) == "passes"
    routes, calls = dict(ta.bwd_variant_cuda.routes), dict(ts.pass_launches)
    for wgrad in (True, False):
        got = ta.bwd_variant_cuda(*ops, g, weight_grads=wgrad, **kw)
        shipped = tb.siren_trunk_bwd_cuda(*ops, g, weight_grads=wgrad, **kw)
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, shipped))
    shipped_dws, dws = tb.siren_trunk_bwd_cuda(*ops, g, **kw)[2], None
    for variant in (dict(), dict(weight_grads=False), dict(transcendental=False),
                    dict(transcendental=False, weight_grads=False), dict(accum=False)):
        one = [x.clone() for x in ta.bwd_variant_cuda(*ops, g, **variant, **kw) if x is not None]
        two = [x for x in ta.bwd_variant_cuda(*ops, g, **variant, **kw) if x is not None]
        assert all(torch.equal(x, y) for x, y in zip(one, two)), variant
        if variant == dict(accum=False):
            dws = ta.weight_grads_cuda(one[2], one[3])
    torch.cuda.synchronize()
    assert torch.equal(dws, shipped_dws)
    assert ta.bwd_variant_cuda.routes == {"passes": routes["passes"] + 12,
                                          "chain": routes["chain"]}
    assert ts.pass_launches["siren_step"] > calls["siren_step"]
    assert ts.pass_launches["siren_anatomy"] == calls["siren_anatomy"] + 4


def test_weight_grads_product_alone_matches_plain(cuda):
    """The split-K weight-gradient product on a given scratch: bf16 and
    float32, several chunks; its partials sum to its result; bitwise
    repeatable."""
    for dtype, rel in ((torch.bfloat16, 1e-4), (torch.float32, 1e-4)):
        h = torch.randn(2, 3000, 128, device=cuda).to(dtype)
        dz = torch.randn(2, 3000, 128, device=cuda).to(dtype)
        n0 = ta.weight_grads_cuda.launches
        got, again = ta.weight_grads_cuda(h, dz), ta.weight_grads_cuda(h, dz)
        parts = ta.weight_grads_cuda(h, dz, reduce=False)
        ref = ta.weight_grads_reference(h, dz)
        torch.cuda.synchronize()
        assert ta.weight_grads_cuda.launches == n0 + 3 and parts.shape[0] >= 4
        assert torch.equal(got, again)
        assert (got - ref).abs().max().item() <= rel * ref.abs().max().item()
        assert (parts.sum(0) - got).abs().max().item() <= rel * ref.abs().max().item()


def _wgrad_held(h, dz):
    """The bf16 product on (h, dz) against weight_grads_reference (the
    float64 product) within 1e-4 x its max |dWs|: two calls bitwise equal,
    the split-K partials (wgrad_chunks' count) summing to the result."""
    L, rows, H = h.shape
    n0 = ta.weight_grads_cuda.launches
    got, again = ta.weight_grads_cuda(h, dz), ta.weight_grads_cuda(h, dz)
    parts = ta.weight_grads_cuda(h, dz, reduce=False)
    ref = ta.weight_grads_reference(h, dz)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert ta.weight_grads_cuda.launches == n0 + 3
    assert parts.shape[0] == tb.wgrad_chunks(rows, H, L, "bfloat16", h.device)[1]
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 1e-4 * scale, (H, rows)
    assert (parts.sum(0) - got).abs().max().item() <= 1e-4 * scale, (H, rows)


@pytest.mark.parametrize("H", [64, 96, 128, 256, 320, 512, 1152, 2048])
def test_wgmma_weight_grads_every_width(cuda, H):
    """The bf16 weight-gradient product (wgmma over tensor-map K-slabs,
    csrc/siren_chain.cuh) at every kind of width the three routes hand it:
    multiples of 64 (the wgmma and tiled passes; one to four 64-column
    atoms a block, paired or odd m blocks) and 96 (the chain route), on 1
    row (one slab, 63 rows zero-filled) and 3,000 (a ragged last chunk)."""
    gen = torch.Generator(device=cuda).manual_seed(H)
    for rows in (1, 3000):
        h = torch.randn(2, rows, H, device=cuda, generator=gen).to(torch.bfloat16)
        dz = torch.randn(2, rows, H, device=cuda, generator=gen).to(torch.bfloat16)
        _wgrad_held(h, dz)


@pytest.mark.parametrize("H,n_mm", [(256, 5), (512, 5), (1152, 1)])
def test_wgmma_weight_grads_at_fit_decoder_rows(cuda, H, n_mm):
    """The product at FIT_DECODER's 100 x 8,192 rows: the Zoo's 5 x 256 (50
    chunks of one block), the 5 x 512 trunk (26 chunks of two blocks) and a
    width past 1,024 (23 chunks of three). No tensor-core sum takes more
    than one block of siren_bwd.WGRAD_WINDOW_ROWS rows, so the float32 sums
    stay within the bar of the float64 product."""
    gen = torch.Generator(device=cuda).manual_seed(H + n_mm)
    h = torch.randn(n_mm, 100 * 8192, H, device=cuda, generator=gen).to(torch.bfloat16)
    dz = torch.randn(n_mm, 100 * 8192, H, device=cuda, generator=gen).to(torch.bfloat16)
    _wgrad_held(h, dz)


# ---------------------------------------------------------------------------
# the backward on the layer-major passes, the device-memory guard of the
# passes' scratch, the forward's smaller row tiles
# ---------------------------------------------------------------------------


def _bwd_case(rng, cuda, film, H, n_mm, B, P, per_image=False):
    """The trunk operands of a pass case and an output cotangent (B, P, 8)."""
    ops = _pass_case(rng, cuda, film, H, n_mm, B, P, per_image)[: 8 if film else 7]
    return ops, torch.as_tensor(rng.normal(size=(B, P, 8)).astype(np.float32), device=cuda)


def _bwd_kw(film, weight_grads, fast_sine=True):
    kw = dict(trunk="bfloat16", fast_sine=fast_sine, weight_grads=weight_grads)
    if not film:
        kw.update(omega0=30.0, omega_h=30.0)
    return kw


@pytest.mark.parametrize("weight_grads", [False, True], ids=["no_wgrad", "wgrad"])
@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("H,n_mm", [(256, 5), (64, 2), (192, 1)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_each_bwd_pass_matches_its_plain_pass(cuda, film, H, n_mm, fast_sine, weight_grads):
    """Each pass kernel of the backward (the cotangent last pass among them)
    against its plain pass on the same scratch: every output it writes,
    max |diff| <= 1e-2 x max |plain|, a ragged P. Not counted as backward
    calls."""
    rng = np.random.default_rng(60)
    B, P = 3, 1000
    ops, g = _bwd_case(rng, cuda, film, H, n_mm, B, P)
    kw = _bwd_kw(film, weight_grads, fast_sine)
    plan = ts.step_plan_cuda(film, (*ops, g), cuda, bwd=True, weight_grads=weight_grads)
    ref = ts.PassWork.for_plan(plan, "bfloat16", cuda)
    calls = (tb.siren_trunk_bwd_cuda.launches, tb.film_trunk_bwd_cuda.launches)
    with torch.no_grad():
        for k in range(len(plan.passes)):
            got = ref.clone()
            ts.step_pass_cuda(plan, k, (*ops, g), kw, got)
            ts.step_pass_reference(plan, k, (*ops, g), kw, ref)
            torch.cuda.synchronize()
            outs = ts.pass_outputs(plan, k, got)
            for name, y in ts.pass_outputs(plan, k, ref).items():
                x, y = outs[name].float(), y.float()
                assert torch.isfinite(x).all(), (plan.passes[k], name)
                err, scale = (x - y).abs().max().item(), y.abs().max().item()
                assert err <= 1e-2 * scale, (plan.passes[k], name, err, scale)
    assert (tb.siren_trunk_bwd_cuda.launches, tb.film_trunk_bwd_cuda.launches) == calls


@pytest.mark.parametrize("npix", [512, 2048, 8192, 32768])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_bwd_passes_match_plain_at_fit_latent_shapes(cuda, film, npix):
    """Both backward kernels on the pass route at FIT_LATENT's batch (21) and
    stage shapes and at 21 x 32,768 (5 x 256; FiLM 5 trunk layers) and, at 21
    x 2,048, 8 products, with and without weight gradients: each result
    within 1e-2 x max |plain|, two calls bitwise equal, one launch each."""
    rng = np.random.default_rng(61)
    kernel, plain = _bwd_pair(film)
    depths = [4 if film else 5] + ([8] if npix == 2048 else [])
    for n_mm in depths:
        ops, g = _bwd_case(rng, cuda, film, 256, n_mm, 21, npix)
        assert ts.pass_route("bfloat16", 256, n_mm)
        for weight_grads in (False, True):
            kw = _bwd_kw(film, weight_grads)
            n0 = kernel.launches
            with torch.no_grad():
                got, again = kernel(*ops, g, **kw), kernel(*ops, g, **kw)
                ref = plain(*ops, g, **kw)
            torch.cuda.synchronize()
            assert kernel.launches == n0 + 2
            for x, y in zip(got, again):
                assert (x is None and y is None) or torch.equal(x, y)
            _assert_grads_close(got, ref, "bfloat16", (film, n_mm, npix, weight_grads))
            del got, again, ref
        torch.cuda.empty_cache()


@pytest.mark.parametrize(
    "trunk,H,passes", [("bfloat16", 128, True), ("float32", 128, True), ("bfloat16", 96, False),
                       ("bfloat16", 512, True)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_bwd_route_on_card(cuda, film, trunk, H, passes, monkeypatch):
    """The backward follows the steps' routing rule: bf16 at a multiple of
    64 up to 256 takes the wgmma passes, H = 512 (one layer's weights and a
    tile do not fit) and the float32 trunk the tiled passes, other bf16
    widths the chain kernel. Each route matches the plain backward, with
    weight gradients."""
    calls = []
    real = ts._pass_call
    monkeypatch.setattr(ts, "_pass_call", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    rng = np.random.default_rng(63)
    ops, g = _bwd_case(rng, cuda, film, H, 1 if H == 512 else 2, 3, 300)
    kw = {**_bwd_kw(film, True), "trunk": trunk}
    kernel, plain = _bwd_pair(film)
    got, ref = kernel(*ops, g, **kw), plain(*ops, g, **kw)
    torch.cuda.synchronize()
    assert bool(calls) is passes
    _assert_grads_close(got, ref, trunk, (trunk, H))


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_grouped_passes_equal_one_call(cuda, film):
    """The device-memory guard: under a budget that holds the scratch of 2
    of 5 images the step and the backward (with and without weight
    gradients) run in groups of 2, 2 and 1 images (per-image grids, a ragged
    P). Every result but dWs is bitwise that of one call (the same per-CTA
    slots, summed in the same order); dWs sums the same products by group,
    within 1e-5 x max |one call|."""
    rng = np.random.default_rng(62)
    B, P, H, n_mm = 5, 1000, 128, 3
    ops = _pass_case(rng, cuda, film, H, n_mm, B, P, per_image=True)
    g = torch.as_tensor(rng.normal(size=(B, P, 8)).astype(np.float32), device=cuda)
    trunk_ops = ops[: 8 if film else 7]
    # dWs follows mse_row, dA (and db0) in a step's results, dA (and db0) in a backward's
    runs = [(ts.step_plan_cuda(film, ops, cuda),
             lambda budget: ts._passes_step(film, ops, _pass_kw(film, P), budget=budget),
             2 if film else 3)]
    for wgrad in (False, True):
        runs.append((ts.step_plan_cuda(film, (*trunk_ops, g), cuda, bwd=True, weight_grads=wgrad),
                     lambda budget, w=wgrad: ts._passes_bwd(film, trunk_ops, g, _bwd_kw(film, w),
                                                            w, budget=budget),
                     1 if film else 2))
    for plan, run, dws_at in runs:
        budget = plan.scratch_bytes - 3 * P * plan.row_bytes
        assert plan.groups(budget) == ((0, 2), (2, 4), (4, 5))
        with torch.no_grad():
            one, grouped = run(None), run(budget)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(one, grouped)):
            if x is None:
                assert y is None
            elif i == dws_at:
                assert (x - y).abs().max().item() <= 1e-5 * x.abs().max().item(), plan
            else:
                assert torch.equal(x, y), (plan, i)


@pytest.mark.parametrize("trunk,H,tm", [("float32", 512, 32), ("bfloat16", 1024, 32)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_forward_takes_wide_trunks_on_a_smaller_row_tile(cuda, film, trunk, H, tm):
    """H = 512 with the float32 trunk and H = 1024 in bf16, where two
    64-row activation buffers do not fit in shared memory: the forward takes
    the 32-row tile (the library's choice and its mirror agree) and holds
    the forward bars against the plain version; a ragged P."""
    lib = tk._kernel("reni_siren_fwd")[1]
    lib.reni_fwd_tile_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    for width in (256, H):
        assert lib.reni_fwd_tile_rows(width, int(trunk == "bfloat16")) == tk.tile_rows(width, trunk)
    assert tk.tile_rows(H, trunk) == tm and tk.tile_rows(256, trunk) == 64
    rng = np.random.default_rng(64)
    N, B, L, P = 5, 3, 2, 1000
    dec = _decoder(rng, "SO2", N, H, L, film, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    n0 = wrap.launches
    with torch.no_grad():
        out = _run(wrap, dec, "SO2", N, Z, D, film, L, H, trunk, True)
        ref = _run(ref_fn, dec, "SO2", N, Z, D, film, L, H, trunk, True)
    torch.cuda.synchronize()
    assert wrap.launches == n0 + 1
    _assert_close(out, ref, trunk, True, (H, trunk))


@pytest.mark.parametrize("weight_grads", [False, True], ids=["no_wgrad", "wgrad"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_handoff_forward_and_backward_match_plain(cuda, film, weight_grads):
    """The differentiable trunk's route on the card: the forward as the
    passes (the fwd passes and the output last pass) holds the forward bars
    against the plain forward; the backward from their scratch holds 1e-2 x
    max |plain| per result against the plain backward and equals the
    backward that recomputes the forward bit for bit (the same passes on the
    same scratch). A ragged P; one launch counted on each side."""
    rng = np.random.default_rng(65)
    B, P, H, n_mm = 3, 1000, 256, 5
    ops, g = _bwd_case(rng, cuda, film, H, n_mm, B, P)
    kw = _bwd_kw(film, weight_grads)
    fkw = {k: v for k, v in kw.items() if k != "weight_grads"}
    kernel, plain = _bwd_pair(film)
    n0 = ts.passes_forward.launches
    with torch.no_grad():
        out, handed = ts.passes_forward(film, ops, fkw, weight_grads)
        got = ts.passes_bwd_handoff(handed, g)
        again = kernel(*ops, g, **kw)
        ref_out = (tk.film_trunk_reference if film else tk.siren_trunk_reference)(*ops, **fkw)
        ref = plain(*ops, g, **kw)
    torch.cuda.synchronize()
    assert ts.passes_forward.launches == n0 + 1
    _assert_close(out, ref_out, "bfloat16", True, "the passes' forward")
    _assert_grads_close(got, ref, "bfloat16", "the backward from the handoff")
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    assert ts.passes_forward(film, ops, fkw, weight_grads, budget=0) is None


# ---------------------------------------------------------------------------
# the fused forward (csrc/fused_fwd.cuh)
# ---------------------------------------------------------------------------

# (H, H x H products, P, per-image grids): every width, depths 1-6, P = 1,
# 127, 129 (a ragged tile), 8,450 (serving width 130) and 32,768
FUSED_CASES = (
    (64, 1, 1, False), (64, 6, 129, True), (64, 3, 32768, False),
    (128, 2, 127, False), (128, 5, 8450, True), (128, 4, 1, True),
    (192, 3, 129, False), (192, 6, 8450, False), (192, 1, 32768, True),
    (256, 5, 32768, False), (256, 6, 127, True), (256, 1, 8450, False),
    (256, 2, 129, True),
)


def _fused_case(rng, cuda, film, H, n_mm, P, per_image, B=2, N=5):
    """(decoder, Z, D, hidden_layers) of a random decoder with n_mm H x H
    products (Cond-by-Concat L = n_mm hidden layers, FiLM T = n_mm + 1)."""
    L = n_mm + 1 if film else n_mm
    dec = _decoder(rng, "SO2", N, H, L, film, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D = torch.as_tensor(D / np.linalg.norm(D, axis=-1, keepdims=True), device=cuda)
    return dec, Z, D, L


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_fused_forward_matches_plain(cuda, film, fast_sine):
    """The fused kernel serves every bf16 width it takes at depths 1-6,
    ragged and tiny P, shared and per-image grids, on the bf16 bars."""
    rng = np.random.default_rng(70)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    for H, n_mm, P, per_image in FUSED_CASES:
        dec, Z, D, L = _fused_case(rng, cuda, film, H, n_mm, P, per_image)
        assert tk.fwd_route("bfloat16", H, n_mm) == "fused"
        n0, f0, t0 = wrap.launches, tk.fused_fwd_launches, tk.tile_fwd_launches
        with torch.no_grad():
            out = _run(wrap, dec, "SO2", 5, Z, D, film, L, H, "bfloat16", fast_sine)
            ref = _run(ref_fn, dec, "SO2", 5, Z, D, film, L, H, "bfloat16", fast_sine)
        torch.cuda.synchronize()
        assert (wrap.launches, tk.fused_fwd_launches, tk.tile_fwd_launches) == (n0 + 1, f0 + 1, t0)
        assert out.shape == (2, P, 3) and torch.isfinite(out).all()
        _assert_close(out, ref, "bfloat16", fast_sine, (H, n_mm, P, per_image))


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_fused_forward_bits_do_not_depend_on_the_schedule(cuda, film, monkeypatch):
    """Two calls give the same bits, and so do persistent grids of 1, 2, 3
    and 8 CTAs, the card's own, and the lock-step schedule."""
    rng = np.random.default_rng(71)
    for H, n_mm, P in ((256, 5, 1000), (128, 2, 300)):
        dec, Z, D, _ = _fused_case(rng, cuda, film, H, n_mm, P, True, B=3)
        ops = _pack(dec, "SO2", 5, Z, D, film, H)
        fn = tk.film_trunk_cuda if film else tk.siren_trunk_cuda
        kw = dict(trunk="bfloat16", fast_sine=True)
        if not film:
            kw.update(omega0=30.0, omega_h=30.0)
        first = fn(*ops, **kw)
        assert torch.equal(first, fn(*ops, **kw))
        assert torch.equal(first, fn(*ops, sched=tk.SCHED_LOCKSTEP, **kw))
        for sms in (1, 2, 3, 8):
            monkeypatch.setattr(tk, "_sm_count", lambda device, sms=sms: sms)
            assert torch.equal(first, fn(*ops, **kw)), sms
        monkeypatch.undo()
        torch.cuda.synchronize()


def test_fused_layout_and_grid_match_the_library(cuda):
    """fused_layout / fused_grid against the library's exports: the shared
    memory and ring of every width and depth the route takes, and the
    persistent grid on this card."""
    lib = tk._kernel("reni_siren_fwd_fused")[1]
    for sym in ("reni_fused_fwd_smem_bytes", "reni_fused_fwd_stages"):
        getattr(lib, sym).argtypes = [ctypes.c_int] * 3
    lib.reni_fused_fwd_grid.argtypes = [ctypes.c_int] * 2
    for film in (False, True):
        for H in tk.FUSED_WIDTHS:
            for n_mm in range(1, tk.MAX_FUSED_MM + 1):
                stages, total = tk.fused_layout(H, n_mm, film)
                assert lib.reni_fused_fwd_stages(H, n_mm, int(film)) == stages
                assert lib.reni_fused_fwd_smem_bytes(H, n_mm, int(film)) == total
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for batch, P in ((1, 1), (1, 8450), (21, 32768), (100, 8192), (3, 129)):
        assert lib.reni_fused_fwd_grid(batch, P) == tk.fused_grid(batch, P, sms)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_forward_route_counters(cuda, film):
    """The serving configuration (bf16, 5 x 256) takes the fused kernel; the
    float32 trunk and bf16 H = 1,024 take the row-tile kernel."""
    rng = np.random.default_rng(72)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    for trunk, H, n_mm, route in (("bfloat16", 256, 5 - film, "fused"),
                                  ("float32", 256, 5 - film, "tile"),
                                  ("bfloat16", 1024, 1, "tile")):
        dec, Z, D, L = _fused_case(rng, cuda, film, H, n_mm, 640, False)
        f0, t0 = tk.fused_fwd_launches, tk.tile_fwd_launches
        with torch.inference_mode():
            _run(wrap, dec, "SO2", 5, Z, D, film, L, H, trunk, True)
        assert tk.fused_fwd_launches == f0 + (route == "fused"), (trunk, H)
        assert tk.tile_fwd_launches == t0 + (route == "tile"), (trunk, H)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_fused_forward_sees_an_in_place_weight_update(cuda, film):
    """Decode, update the hidden weights in place (as Adam does), decode
    again: the packed slabs are not stale."""
    rng = np.random.default_rng(73)
    dec, Z, D, L = _fused_case(rng, cuda, film, 256, 4, 1000, False)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    with torch.inference_mode():
        before = _run(wrap, dec, "SO2", 5, Z, D, film, L, 256, "bfloat16", True)
        assert torch.equal(before, _run(wrap, dec, "SO2", 5, Z, D, film, L, 256, "bfloat16", True))
    with torch.no_grad():
        dec["layers"][2]["w"].mul_(-1.5)
    with torch.inference_mode():
        out = _run(wrap, dec, "SO2", 5, Z, D, film, L, 256, "bfloat16", True)
        ref = _run(ref_fn, dec, "SO2", 5, Z, D, film, L, 256, "bfloat16", True)
    torch.cuda.synchronize()
    assert not torch.equal(out, before)
    _assert_close(out, ref, "bfloat16", True, "after the update")


# ---------------------------------------------------------------------------
# the renderer and FIT_INVERSE's decode at a batch of one (render/, the
# backward passes at B = 1)
# ---------------------------------------------------------------------------


def _teapot_scene(device):
    """The teapot's float32 pixel geometry and camera at a 32 x 32 render,
    made once on the CPU and moved to ``device``."""
    import os

    from reni_tpu_torch.render import mesh, rasterizer, shading

    m = mesh.load_obj(os.path.join(os.path.dirname(__file__), "..", "data", "3D_Models",
                                   "teapot.obj"))
    frags, eye = rasterizer.rasterize_world(m, 32)
    vn = mesh.vertex_normals(m)
    pos, nrm = shading.pixel_geometry(frags, m.face_verts, vn[m.faces], "cpu")
    return nrm.to(device), pos.to(device), torch.tensor(eye, device=device)


def _teapot_render(device, dtype, kd, width=64):
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.render import shading

    nrm, pos, cam = _teapot_scene(device)
    rng = np.random.default_rng(81)
    env = torch.tensor(rng.gamma(2.0, 1.0, size=(2, width * width // 2, 3)), dtype=dtype,
                       device=device)
    colors = env * sphere.get_sineweight(width, device=device).to(dtype)
    dirs = sphere.get_directions(width, device=device)[0]
    return shading.blinn_phong_env_shading(nrm, pos, cam, dirs, colors, kd=kd, ks=1.0 - kd)


def test_render_on_the_card_matches_the_cpu(cuda):
    """The float64 render on the card equals the CPU's on the same float32
    geometry to 1e-10 x max (the light sums' order differs; kd 0.5, the
    specular term on). The geometry is made once: a last-bit difference of
    a float32 normal would come back 500-fold through the specular power."""
    got = _teapot_render(cuda, torch.float64, 0.5).cpu()
    ref = _teapot_render(torch.device("cpu"), torch.float64, 0.5)
    assert (got - ref).abs().max() <= 1e-10 * ref.abs().max()


def test_render_float32_against_float64_on_the_card(cuda):
    """The TF32 guard: sum |f32 - f64| / sum |f64| <= 1e-4 with a specular
    term (dots on TF32-rounded inputs put more than 1e-2 there:
    tests/test_torch_render.py::test_tf32_guard_sees_a_tf32_dot)."""
    r32 = _teapot_render(cuda, torch.float32, 0.5).double()
    r64 = _teapot_render(cuda, torch.float64, 0.5)
    assert torch.isfinite(r32).all()
    assert ((r32 - r64).abs().sum() / r64.abs().sum()).item() <= 1e-4


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_batch_of_one_decode_takes_the_passes(cuda, film):
    """A differentiable decode of one latent at 8,192 directions (a
    FIT_INVERSE step's) runs as the fwd passes and the cotangent backward
    from their scratch: its latent gradient against the plain decoder's at
    the backward bars."""
    import os

    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.models import reni as reni_mod
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt

    name = "film" if film else "cbc"
    path = os.path.join(os.path.dirname(__file__), "..", "data", "Zoo",
                        f"latent_dim_49_net_5_256_vad_{name}_tanh_hdr", "checkpoint")
    cfg = ckpt.load_model_config(path, fixed_decoder=True)
    model = RENIModel(cfg)
    params = ckpt.load_decoder_only(path, model, 1, torch.Generator().manual_seed(0), cuda)
    params["latents"]["mu"].normal_(generator=torch.Generator(device=cuda).manual_seed(3))
    D = sphere.get_directions(128, device=cuda)
    bwd = tb.film_trunk_bwd_cuda if film else tb.siren_trunk_bwd_cuda
    before = (ts.passes_forward.launches, bwd.launches, tk.fused_fwd_launches)

    def grad(plain):
        mu = params["latents"]["mu"].detach().clone().requires_grad_()
        saved = reni_mod.fused_apply, reni_mod.fused_film_apply
        if plain:
            reni_mod.fused_apply = tk.fused_apply_reference
            reni_mod.fused_film_apply = tk.fused_film_apply_reference
        try:
            out = model.apply({**params, "latents": {**params["latents"], "mu": mu}}, mu, D)
            (out * torch.linspace(-1, 1, out.numel(), device=cuda).view_as(out)).sum().backward()
        finally:
            reni_mod.fused_apply, reni_mod.fused_film_apply = saved
        return mu.grad

    got = grad(False)
    after = (ts.passes_forward.launches, bwd.launches, tk.fused_fwd_launches)
    ref = grad(True)
    assert after == (before[0] + 1, before[1] + 1, before[2])
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


def test_sharded_step_kernel_plan_on_the_card(cuda, tmp_path):
    """The sharded kernel plan on the card: two ranks on the one card (gloo;
    NCCL takes one rank a card) on a 1 x 2 data x pixel mesh each launch the
    train-step kernel of either conditioning on their half of a 100 x 8,192
    batch; ``chip_smoke.mesh_step_check`` holds the loss (1e-4 relative) and
    every gradient (the bf16 step bar) against the single-device kernel
    step, two calls to the same bits and the ranks to each other's bits."""
    import chip_smoke

    batch = np.random.default_rng(0).uniform(-1, 1, (100, 8192, 3)).astype(np.float32)
    launches, grads, outs, _ = chip_smoke.mesh_step_check(cuda, str(tmp_path), batch, 1, 2)
    assert launches == {"cbc": 4, "film": 4}
    assert "decoder/final/w" in grads and [r["coords"] for r, _ in outs] == [[0, 0, 0], [0, 1, 0]]


def _wide_ops(film, B, P, H, n_mm, seed, device):
    """Random trunk operands of width H (SIREN-scaled, numpy-seeded), an
    output cotangent and the loss operands (a masked last image)."""
    rng = np.random.default_rng(seed)
    u = lambda *s, b=1.0: torch.as_tensor(_uniform(rng, s, b), device=device)
    d = torch.zeros(1, P, 8, device=device)
    d[..., :4] = u(1, P, 4)
    a = torch.zeros(B, 8, H, device=device)
    a[:, :4] = u(B, 4, H, b=0.5)
    ws = u(n_mm, H, H, b=math.sqrt(6 / H) / 30)
    wf = torch.zeros(H, 8, device=device)
    wf[:, :3] = u(H, 3, b=math.sqrt(6 / H) / 30)
    bf = torch.zeros(1, 8, device=device)
    g = torch.as_tensor(rng.normal(size=(B, P, 8)).astype(np.float32), device=device)
    tgt, sw = torch.zeros(B, P, 8, device=device), torch.zeros(1, P, 8, device=device)
    tgt[..., :3], sw[..., :3] = u(B, P, 3, b=0.5), u(1, P, 3).abs()
    bm = torch.ones(B, 1, 8, device=device)
    bm[-1] = 0.0
    if film:
        T = n_mm + 1
        ops = (d, a, ws, u(T, H, b=0.05), wf, bf, 30 + 5 * u(B, 1, T * H), u(B, 1, T * H))
    else:
        ops = (d, a, u(B, 1, H, b=0.1), ws, u(n_mm, H, b=0.05), wf, bf)
    return ops, g, (tgt, sw, bm)


def _held(got, ref, bar):
    for x, r in zip(got, ref):
        assert (x is None) == (r is None)
        if r is None or not r.numel():
            continue
        assert torch.isfinite(x).all()
        assert (x - r).abs().max().item() <= bar * r.abs().max().item()


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_batches_past_65535_images(cuda, trunk):
    """C-8: 65,536 images x 64 directions at H = 64 (the grids put images on
    x): the forward (the fused kernel in bf16, the row-tile kernel in
    float32), the backward with and without weight gradients and the step
    (the wgmma passes in bf16, the tiled passes in float32) against their
    plain versions at the file's bars, two calls the same bits."""
    B, P, H, n_mm = 65536, 64, 64, 2
    ops, g, loss_ops = _wide_ops(False, B, P, H, n_mm, 41, cuda)
    kw = dict(omega0=30.0, omega_h=30.0, trunk=trunk, fast_sine=trunk == "bfloat16")
    assert tk.fwd_route(trunk, H, n_mm) == ("fused" if trunk == "bfloat16" else "tile")
    bar = 1e-2 if trunk == "bfloat16" else 1e-4
    with torch.no_grad():
        out = tk.siren_trunk_cuda(*ops, **kw)
        assert torch.equal(out, tk.siren_trunk_cuda(*ops, **kw))
        _assert_close(out, tk.siren_trunk_reference(*ops, **kw), trunk, kw["fast_sine"], "fwd")
        for wgrad in (False, True):
            got = tb.siren_trunk_bwd_cuda(*ops, g, **kw, weight_grads=wgrad)
            again = tb.siren_trunk_bwd_cuda(*ops, g, **kw, weight_grads=wgrad)
            assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))
            _held(got, tb.siren_trunk_bwd_reference(*ops, g, **kw, weight_grads=wgrad), bar)
        skw = dict(kw, out_act="tanh", gscale=1.0 / (3 * P))
        got = ts.siren_step_cuda(*ops, *loss_ops, **skw)
        ref = ts.siren_step_reference(*ops, *loss_ops, **skw)
        assert abs(got[0].sum().item() / ref[0].sum().item() - 1) <= 1e-4
        _held(got[1:], ref[1:], bar)


@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_mm", [(1152, 3), (2048, 2)])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_tiled_routes_past_1024(cuda, film, H, n_mm, trunk):
    """C-3: widths past 1,024 on both tiled routes at 3 x 300 (a ragged
    tile): the step, the backward with and without weight gradients, the
    differentiable forward's hand-off and the plain forward (at float32 H =
    2,048 the passes' output mode) against their plain versions, two step
    calls the same bits."""
    B, P = 3, 300
    ops, g, loss_ops = _wide_ops(film, B, P, H, n_mm, H + n_mm, cuda)
    kw = dict(trunk=trunk, fast_sine=True, **({} if film else dict(omega0=30.0, omega_h=30.0)))
    assert ts.pass_design(trunk, H, n_mm) == "tiled"
    bar = 1e-2 if trunk == "bfloat16" else 1e-4
    step_k, step_r = ((ts.film_step_cuda, ts.film_step_reference) if film
                      else (ts.siren_step_cuda, ts.siren_step_reference))
    bwd_k, bwd_r = ((tb.film_trunk_bwd_cuda, tb.film_trunk_bwd_reference) if film
                    else (tb.siren_trunk_bwd_cuda, tb.siren_trunk_bwd_reference))
    fwd_k, fwd_r = ((tk.film_trunk_cuda, tk.film_trunk_reference) if film
                    else (tk.siren_trunk_cuda, tk.siren_trunk_reference))
    with torch.no_grad():
        skw = dict(kw, out_act="tanh", gscale=1.0 / (3 * P))
        got = step_k(*ops, *loss_ops, **skw)
        assert all(torch.equal(x, y) for x, y in zip(got, step_k(*ops, *loss_ops, **skw)))
        ref = step_r(*ops, *loss_ops, **skw)
        assert abs(got[0].sum().item() / ref[0].sum().item() - 1) <= 1e-4
        _held(got[1:], ref[1:], bar)
        for wgrad in (False, True):
            ref = bwd_r(*ops, g, **kw, weight_grads=wgrad)
            _held(bwd_k(*ops, g, **kw, weight_grads=wgrad), ref, bar)
            out, handed = ts.passes_forward(film, ops, kw, wgrad)
            _assert_close(out, fwd_r(*ops, **kw), trunk, True, "hand-off forward")
            _held(ts.passes_bwd_handoff(handed, g), ref, bar)
        before = ts.passes_output.launches
        _assert_close(fwd_k(*ops, **kw), fwd_r(*ops, **kw), trunk, True, "forward")
        passes = tk.fwd_route(trunk, H, n_mm) == "passes"
        assert ts.passes_output.launches == before + passes
        assert passes is (trunk == "float32" and H == 2048)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_passes_output_in_groups(cuda, film):
    """The plain forward past the row tile (float32 H = 2,048, the passes'
    output mode) under a device-memory budget that forces groups: each image
    runs in a group of its own over one group-sized scratch, into its own
    rows of the output, and the output equals one call's bit for bit and
    holds the float32 forward bar against the plain forward."""
    B, P, H, n_mm = 3, 300, 2048, 2
    ops, _, _ = _wide_ops(film, B, P, H, n_mm, 43, cuda)
    kw = dict(trunk="float32", fast_sine=True,
              **({} if film else dict(omega0=30.0, omega_h=30.0)))
    plan = ts.step_plan_cuda(film, (*ops, None), cuda, bwd=True, weight_grads=False,
                             trunk="float32")
    budget = plan.scratch_bytes - plan.rows * plan.row_bytes + plan.npix * plan.row_bytes
    assert len(plan.groups(budget)) == B
    plain = tk.film_trunk_reference if film else tk.siren_trunk_reference
    with torch.no_grad():
        before = ts.passes_output.launches
        grouped = ts.passes_output(film, ops, kw, budget=budget)
        whole = ts.passes_output(film, ops, kw)
        assert ts.passes_output.launches == before + 2
        assert torch.equal(grouped, whole)
        _assert_close(grouped, plain(*ops, **kw), "float32", True, "grouped forward")


@pytest.mark.parametrize("B", [1024, 65535, 65536])
def test_weight_slot_sums_hold_the_float32_loss_bar(cuda, B):
    """The float32 step's loss sums one weight slot a CTA (B slots at 64
    directions): in one sequential sum up to 1,024 slots and 256 at a time
    past that (``launch_reduce``). Either way the loss holds the float32
    step's bar against the plain step, 1e-6 relative, and the gradients
    1e-4 of their largest entry."""
    P, H, n_mm = 64, 64, 2
    ops, _, loss_ops = _wide_ops(False, B, P, H, n_mm, 47, cuda)
    kw = dict(omega0=30.0, omega_h=30.0, trunk="float32", fast_sine=False, out_act="tanh",
              gscale=1.0 / (3 * P))
    with torch.no_grad():
        got = ts.siren_step_cuda(*ops, *loss_ops, **kw)
        ref = ts.siren_step_reference(*ops, *loss_ops, **kw)
        assert abs(got[0].sum().item() / ref[0].sum().item() - 1) <= 1e-6
        _held(got[1:], ref[1:], 1e-4)
