"""The fused decoder forward (reni_tpu_torch.kernels.siren_fwd) held against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas.py runs them. On the CPU the wrappers take their plain
PyTorch trunks; the CUDA kernels themselves are checked on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.kernels import siren_pallas as jk
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu_torch import params as tparams
from reni_tpu_torch.kernels import siren_fwd as tk

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(equiv="SO2", N=9, L=3, H=128, act="tanh", film=False, per_image=False,
           B=3, P=256, seed=0):
    cfg = JConfig(
        model_type="AutoDecoder", equivariance=equiv, latent_dim=N,
        hidden_layers=L, hidden_features=H, output_activation=act,
        conditioning="FiLM" if film else "Cond-by-Concat",
        mapping_layers=2, mapping_features=64,
    )
    jp = JModel(cfg).init(jax.random.PRNGKey(seed), dataset_size=B)
    rng = np.random.default_rng(seed + 1)
    Z = rng.normal(size=(B, N, 3)).astype(np.float32)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    tp = tparams.from_numpy(jax.device_get(jp["decoder"]), "cpu")
    return cfg, jp["decoder"], tp, Z, D


def _run(cfg, jp, tp, Z, D, trunk, fast_sine=False, port=None):
    """(JAX interpret-mode Pallas output, port output) on the same inputs."""
    port = port or (tk.fused_film_apply_reference if cfg.is_film else tk.fused_apply_reference)
    common = dict(hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
                  out_features=cfg.out_features, output_activation=cfg.output_activation,
                  trunk=trunk, fast_sine=fast_sine)
    if cfg.is_film:
        ref = jk.fused_film_apply(jp, cfg.equivariance, jnp.asarray(Z), jnp.asarray(D),
                                  interpret=True, **common)
        out = port(tp, cfg.equivariance, torch.from_numpy(Z), torch.from_numpy(D), **common)
    else:
        omegas = dict(first_omega_0=cfg.first_omega_0, hidden_omega_0=cfg.hidden_omega_0)
        ref = jk.fused_apply(jp, cfg.equivariance, cfg.latent_dim, jnp.asarray(Z),
                             jnp.asarray(D), interpret=True, **common, **omegas)
        out = port(tp, cfg.equivariance, cfg.latent_dim, torch.from_numpy(Z),
                   torch.from_numpy(D), **common, **omegas)
    return _np(ref), _np(out)


@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per_image"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
@pytest.mark.parametrize("equiv", ["SO3", "SO2", "None"])
def test_reference_matches_pallas_f32(equiv, film, per_image):
    """The plain trunk vs the f32 Pallas kernel (test_fused_forward_matches_jnp bar)."""
    cfg, jp, tp, Z, D = _setup(equiv=equiv, film=film, per_image=per_image)
    ref, out = _run(cfg, jp, tp, Z, D, "float32")
    assert out.shape == ref.shape == (3, 256, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_reference_matches_pallas_fast_sine(film):
    """test_fused_apply_fast_sine_matches_fast_jnp bar."""
    cfg, jp, tp, Z, D = _setup(film=film, seed=4)
    ref, out = _run(cfg, jp, tp, Z, D, "float32", fast_sine=True)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("fast_sine", [False, True])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_reference_matches_pallas_bf16(film, fast_sine):
    """bf16 trunk: both sides round the same operands to bf16 and sum in
    f32, so only the summation order differs; a flipped bf16 rounding of
    an activation then propagates. Measured on these inputs: max 2.1e-4,
    mean 1.1e-6 (FiLM, fast sine); the bar is about 5x that."""
    cfg, jp, tp, Z, D = _setup(film=film, seed=6)
    ref, out = _run(cfg, jp, tp, Z, D, "bfloat16", fast_sine=fast_sine)
    err = np.abs(out - ref)
    print(f"bf16 plain vs Pallas: max {err.max():.3g}, mean {err.mean():.3g}")
    assert err.max() < 1e-3 and err.mean() < 5e-6, (err.max(), err.mean())


def test_film_single_trunk_layer():
    """hidden_layers=1: the FiLM Ws stack is empty."""
    cfg, jp, tp, Z, D = _setup(film=True, L=1, seed=8)
    ref, out = _run(cfg, jp, tp, Z, D, "float32")
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_wrapper_on_cpu_takes_plain_trunk(film):
    """On CPU tensors the public wrapper is the plain version and launches
    nothing; a stride-0 (B, P) grid reads as one shared grid."""
    cfg, jp, tp, Z, D = _setup(film=film, seed=10)
    before = (tk.fused_apply.launches, tk.fused_film_apply.launches)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    ref, out = _run(cfg, jp, tp, Z, D, "bfloat16", port=wrap)
    _, out_ref = _run(cfg, jp, tp, Z, D, "bfloat16")
    np.testing.assert_array_equal(out, out_ref)
    assert (tk.fused_apply.launches, tk.fused_film_apply.launches) == before
    Db = torch.from_numpy(D).expand(3, *D.shape[1:])
    assert Db.stride(0) == 0
    common = dict(hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
                  out_features=3, output_activation="tanh", trunk="bfloat16")
    if film:
        out_b = wrap(tp, cfg.equivariance, torch.from_numpy(Z), Db, **common)
    else:
        out_b = wrap(tp, cfg.equivariance, cfg.latent_dim, torch.from_numpy(Z), Db,
                     first_omega_0=30.0, hidden_omega_0=30.0, **common)
    np.testing.assert_array_equal(_np(out_b), out)


@pytest.mark.parametrize(
    "npix,hidden,batch", [(256, 128, 3), (800, 256, None), (260, 128, 2), (256, 96, 1), (4, 128, 1)]
)
def test_dispatch_guard_matches_jax(npix, hidden, batch):
    """Every shape the Pallas kernel takes, the CUDA kernel takes too; the
    TPU tile rules (H % 128, P % 8) are not its limits, so it also takes
    these shapes the Pallas kernel declines."""
    if jk.unsupported_reason(npix, hidden, batch=batch) is None:
        assert tk.unsupported_reason(npix, hidden, batch=batch) is None
    for trunk in tk.TRUNKS:
        assert tk.unsupported_reason(npix, hidden, batch=batch, trunk=trunk) is None


def test_wrapper_rejects_unsupported_shapes():
    cfg, jp, tp, Z, D = _setup(H=120)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.fused_apply(
            tp, cfg.equivariance, cfg.latent_dim, torch.from_numpy(Z),
            torch.from_numpy(D), hidden_layers=cfg.hidden_layers, hidden_features=120,
            out_features=3, output_activation="tanh", first_omega_0=30.0,
            hidden_omega_0=30.0, trunk="float32",
        )
    # a wide trunk takes a smaller row tile; past the 16-row tile the passes'
    # output mode takes the widths the passes take, and other widths decline
    assert tk.unsupported_reason(256, 512, trunk="float32") is None
    assert tk.unsupported_reason(256, 2048, trunk="float32") is None
    reason = tk.unsupported_reason(256, 3600, trunk="bfloat16")
    assert "shared memory" in reason and "16 rows" in reason
    assert tk.unsupported_reason(256, 512, trunk="bfloat16") is None
    assert tk.unsupported_reason(256, 256, batch=70000) is None  # any batch: images on x


def test_wrapper_takes_ragged_pixel_count():
    """P = 100 (not a multiple of 8, which the Pallas kernel declines): the
    wrapper takes it, and its plain f32 trunk holds to the JAX decomposed
    decoder at the test_fused_forward_matches_jnp bar."""
    cfg, jp, tp, Z, D = _setup(P=100, seed=12)
    out = tk.fused_apply(
        tp, cfg.equivariance, cfg.latent_dim, torch.from_numpy(Z), torch.from_numpy(D),
        hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
        out_features=3, output_activation="tanh", first_omega_0=30.0,
        hidden_omega_0=30.0, trunk="float32",
    )
    ref = JModel(cfg).apply({"decoder": jp}, jnp.asarray(Z), jnp.asarray(D))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# backward: the plain version of siren_bwd against the Pallas backward kernels
# ---------------------------------------------------------------------------

from reni_tpu_torch.kernels import siren_bwd as tb  # noqa: E402
from reni_tpu_torch.train import checkpoint as tck  # noqa: E402


def _bwd_both(equiv="SO2", film=False, trunk="float32", fast_sine=False, L=3, seed=30,
              tile=128):
    """(Pallas bwd kernel in interpret mode, port plain bwd) gradients on the
    same packed operands and cotangent; P = 256 in two 128-row tiles."""
    cfg, jp, tp, Z, D = _setup(equiv=equiv, film=film, L=L, seed=seed)
    H, B = cfg.hidden_features, Z.shape[0]
    d_feats = tk.encodings.d_features(equiv, torch.from_numpy(D))
    g = np.random.default_rng(seed + 2).normal(size=(B, D.shape[1], 8)).astype(np.float32)
    dtype = {"bfloat16": jnp.bfloat16, "float32": None}[trunk]
    with torch.no_grad():
        if film:
            ops = tk.pack_film_inputs(tp, equiv, torch.from_numpy(Z), d_feats, H)
            bwd = jk._film_calls(cfg.hidden_layers, H, tile=tile, trunk_dtype=dtype,
                                 interpret=True, fast_sine=fast_sine)[1]
            port = tb.film_trunk_bwd_reference(*ops, torch.from_numpy(g), trunk=trunk,
                                               fast_sine=fast_sine)
        else:
            ops = tk.pack_inputs(tp, equiv, cfg.latent_dim, torch.from_numpy(Z), d_feats)
            bwd = jk._siren_calls(cfg.hidden_layers, H, cfg.first_omega_0, cfg.hidden_omega_0,
                                  tile=tile, trunk_dtype=dtype, interpret=True,
                                  fast_sine=fast_sine)[1]
            port = tb.siren_trunk_bwd_reference(*ops, torch.from_numpy(g), omega0=30.0,
                                                omega_h=30.0, trunk=trunk, fast_sine=fast_sine)
    ref = bwd(*(jnp.asarray(_np(t)) for t in ops), jnp.asarray(g))
    return [_np(r) for r in ref], [_np(p) for p in port]


def _close(ref, port, rtol, atol):
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r.shape == p.shape, (i, r.shape, p.shape)
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=f"gradient {i}")


# test_fused_gradients_match_jnp bars; FiLM's dfreqs sum sin'(30 x) * pre
BWD_F32 = {False: (5e-5, 2e-5), True: (1e-4, 5e-5)}


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
@pytest.mark.parametrize("equiv", ["SO3", "SO2", "None"])
def test_plain_bwd_matches_pallas_f32(equiv, film):
    ref, port = _bwd_both(equiv=equiv, film=film)
    _close(ref, port, *BWD_F32[film])


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_plain_bwd_matches_pallas_fast_sine(film):
    ref, port = _bwd_both(film=film, fast_sine=True, seed=32)
    _close(ref, port, *BWD_F32[film])


def test_plain_bwd_matches_pallas_film_single_layer():
    """hidden_layers = 1: FiLM's Ws and dWs are empty."""
    ref, port = _bwd_both(film=True, L=1, seed=34)
    assert ref[1].shape == port[1].shape == (0, 128, 128)
    _close(ref, port, *BWD_F32[True])


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_plain_bwd_matches_pallas_bf16(film):
    """bf16 trunk: both sides round the same operands (cotangents included)
    and sum in float32 in another order; a flipped bf16 rounding of an
    activation or a dz then moves a gradient by a bf16 ulp of one term.
    Measured on these inputs, as max |diff| / max |Pallas| of the worst
    gradient: cbc 3.6e-4, FiLM 4.8e-4; the bar is about 5x that."""
    ref, port = _bwd_both(film=film, trunk="bfloat16", fast_sine=True, seed=36)
    worst = 0.0
    for r, p in zip(ref, port):
        if r.size:
            worst = max(worst, float(np.abs(p - r).max() / np.abs(r).max()))
    print(f"bf16 plain bwd vs Pallas: worst max|diff|/max|ref| {worst:.3g}")
    assert worst < 2.5e-3, worst


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_model_grads_match_jax_fused(film):
    """jax.grad of sum(out^2) w.r.t. (decoder, Z) through JAX fused_apply
    (Pallas, interpret mode) against autograd through the port's
    fused_apply on the CPU (the plain forward and backward Functions)."""
    cfg, jp, tp, Z, D = _setup(film=film, seed=38)
    common = dict(hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
                  out_features=3, output_activation="tanh", trunk="float32")
    omegas = {} if film else dict(first_omega_0=30.0, hidden_omega_0=30.0)

    def jloss(dec, z):
        if film:
            out = jk.fused_film_apply(dec, cfg.equivariance, z, jnp.asarray(D),
                                      interpret=True, **common)
        else:
            out = jk.fused_apply(dec, cfg.equivariance, cfg.latent_dim, z, jnp.asarray(D),
                                 interpret=True, **common, **omegas)
        return jnp.sum(out ** 2)

    jd, jz = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(Z))
    tz = torch.from_numpy(Z).requires_grad_()
    tparams.map_tree(lambda t: t.requires_grad_(), tp)
    wrap = tk.fused_film_apply if film else tk.fused_apply
    args = (tp, cfg.equivariance, tz) if film else (tp, cfg.equivariance, cfg.latent_dim, tz)
    (wrap(*args, torch.from_numpy(D), **common, **omegas) ** 2).sum().backward()
    np.testing.assert_allclose(_np(tz.grad), _np(jz), rtol=5e-5, atol=2e-5)
    flat_t = tck._flatten(tparams.map_tree(lambda t: _np(t.grad), tp))
    flat_j = tck._flatten(jax.device_get(jd))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=5e-5, atol=2e-5, err_msg=k)
