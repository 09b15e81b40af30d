"""The CUDA kernels of reni_tpu_torch.kernels.siren_fwd and siren_bwd against
their plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU and
skips without one; this file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from reni_tpu_torch.core import encodings
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk

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
    """Three tiles per CTA, 17 tiles per image (the last CTA has two): the
    per-image sums are the same as with one tile per CTA, to float32
    rounding, and bitwise the same from run to run."""
    rng = np.random.default_rng(21)
    N, B, H, L, P = 5, 3, 128, 2, 264
    dec = _decoder(rng, "SO2", N, H, L, film, cuda)
    Z = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
    ops = _pack(dec, "SO2", N, Z, D, film, H)
    g = torch.randn(B, P, 8, device=cuda)
    kernel, plain = _bwd_pair(film)
    kw = dict(trunk="bfloat16", fast_sine=True, weight_grads=False)
    if not film:
        kw.update(omega0=30.0, omega_h=30.0)
    one = kernel(*ops, g, **kw)
    monkeypatch.setattr(tb, "launch_grid", lambda npix, b, t, dev: (3, math.ceil(npix / 16 / 3)))
    three = kernel(*ops, g, **kw)
    again = kernel(*ops, g, **kw)
    ref = plain(*ops, g, **kw)
    torch.cuda.synchronize()
    _assert_grads_close(three, ref, "bfloat16", "3 tiles per CTA")
    for x, y, z in zip(one, three, again):
        if x is not None:
            assert torch.equal(y, z)
            assert (x - y).abs().max().item() <= 1e-5 * x.abs().max().item()


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_fused_apply_backward_launches_both_kernels(cuda, film):
    """One autograd backward through fused_apply on the card launches the
    forward and the backward kernel once each, and its gradients (latents
    and every decoder weight) match the plain Function's."""
    rng = np.random.default_rng(22)
    N, B, H, L, P = 5, 3, 128, 2, 200
    dec = _decoder(rng, "SO2", N, H, L, film, cuda)
    Z0 = torch.as_tensor(rng.normal(size=(B, N, 3)).astype(np.float32), device=cuda)
    D = torch.nn.functional.normalize(torch.randn(1, P, 3, device=cuda), dim=-1)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref_fn = tk.fused_film_apply_reference if film else tk.fused_apply_reference
    kernel = _bwd_pair(film)[0]
    leaves = [dec["final"]["w"], dec["layers"][-1]["w"], dec["layers"][0]["b"]]

    def grads(fn):
        Z = Z0.clone().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        out = _run(fn, dec, "SO2", N, Z, D, film, L, H, "bfloat16", True)
        (out ** 2).sum().backward()
        got = [Z.grad] + [t.grad for t in leaves]
        for t in leaves:
            t.grad = None
        return got

    n_fwd, n_bwd = wrap.launches, kernel.launches
    got = grads(wrap)
    torch.cuda.synchronize()
    assert (wrap.launches, kernel.launches) == (n_fwd + 1, n_bwd + 1)
    ref = grads(ref_fn)
    assert (wrap.launches, kernel.launches) == (n_fwd + 1, n_bwd + 1)
    _assert_grads_close(got, ref, "bfloat16", "fused_apply backward")


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_model_apply_with_grad_outside_bwd_limit_raises(cuda, film):
    """H = 512 with 5 layers: the forward kernel takes it, the backward
    kernel's shared memory does not. With a latent that requires grad
    RENIModel.apply raises on the card instead of training with plain
    PyTorch; without one it decodes."""
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel

    rng = np.random.default_rng(23)
    cfg = RENIConfig(conditioning="FiLM" if film else "Cond-by-Concat", latent_dim=5,
                     hidden_layers=5, hidden_features=512, mapping_layers=1,
                     mapping_features=64, use_pallas=True, fast_sine=True)
    dec = _decoder(rng, "SO2", 5, 512, 5, film, cuda)
    D = torch.nn.functional.normalize(torch.randn(1, 64, 3, device=cuda), dim=-1)
    Z = torch.zeros(2, 5, 3, device=cuda)
    model = RENIModel(cfg)
    assert model.apply({"decoder": dec}, Z, D).shape == (2, 64, 3)
    with pytest.raises(ValueError, match="shared memory"):
        model.apply({"decoder": dec}, Z.requires_grad_(), D)


def test_bwd_smem_formula_matches_kernel(cuda):
    lib = tb.library()
    for film in (False, True):
        for trunk in tk.TRUNKS:
            for H, n_mm in ((128, 2), (256, 5), (256, 4), (512, 1), (64, 0)):
                got = lib.reni_bwd_smem_bytes(int(film), int(trunk == "bfloat16"), H, n_mm)
                assert got == tb.bwd_smem_bytes(film, trunk, H, n_mm)


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
