"""The port's model modules, parameter carrier and checkpoint files held
against the JAX package on the CPU, from small random models up to the six
Zoo checkpoints."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.core import encodings as jenc
from reni_tpu.core import sphere as jsph
from reni_tpu.models import film as jfilm
from reni_tpu.models import siren as jsiren
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import checkpoint as jck
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import encodings as tenc
from reni_tpu_torch.core import sphere as tsph
from reni_tpu_torch.models import film as tfilm
from reni_tpu_torch.models import siren as tsiren
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import checkpoint as tck

ZOO = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "data", "Zoo", "*", "")))
# bf16-trunk bars of test_fused_bf16_trunk_close
BF16_MAX, BF16_MEAN = 0.05, 0.01


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _model(seed=0, **kw):
    cfg = dict(model_type="AutoDecoder", latent_dim=5, hidden_layers=2,
               hidden_features=32, output_activation="tanh")
    cfg.update(kw)
    jm = JModel(JConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(seed), dataset_size=3)
    return jm, jp, tparams.from_numpy(jax.device_get(jp), "cpu")


def _zd(B=3, N=5, P=64, seed=1, per_image=False):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(B, N, 3)).astype(np.float32)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return Z, D


EQUIVS = ["SO3", "SO2", "None"]


@pytest.mark.parametrize("fast_sine", [False, True])
@pytest.mark.parametrize("equiv", EQUIVS)
def test_siren_decomposed_and_concat_match_jax(equiv, fast_sine):
    jm, jp, tp = _model(equivariance=equiv, fast_sine=fast_sine)
    cfg = jm.config
    Z, D = _zd(per_image=True)
    kw = dict(last_layer_linear=True, output_activation="tanh",
              first_omega_0=cfg.first_omega_0, hidden_omega_0=cfg.hidden_omega_0)
    ref = jsiren.apply_siren_decomposed(
        jp["decoder"], equiv, 5, jnp.asarray(Z), jnp.asarray(D), fast_sine=fast_sine, **kw)
    out = tsiren.apply_siren_decomposed(
        tp["decoder"], equiv, 5, torch.from_numpy(Z), torch.from_numpy(D),
        fast_sine=fast_sine, **kw)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    if not fast_sine:
        x_j = jenc.invariant_representation(equiv, jnp.asarray(Z), jnp.asarray(D))
        x_t = tenc.invariant_representation(equiv, torch.from_numpy(Z), torch.from_numpy(D))
        ref_c = jsiren.apply_siren_concat(jp["decoder"], x_j, **kw)
        out_c = tsiren.apply_siren_concat(tp["decoder"], x_t, **kw)
        np.testing.assert_allclose(_np(out_c), _np(ref_c), atol=1e-5)
        np.testing.assert_allclose(_np(out_c), _np(out), atol=1e-5)


@pytest.mark.parametrize("equiv", EQUIVS)
def test_film_decomposed_and_concat_match_jax(equiv):
    jm, jp, tp = _model(seed=3, equivariance=equiv, conditioning="FiLM",
                        mapping_layers=2, mapping_features=16)
    Z, D = _zd(per_image=True, seed=4)
    kw = dict(hidden_features=32, output_activation="tanh")
    ref = jfilm.apply_film_decomposed(jp["decoder"], equiv, jnp.asarray(Z), jnp.asarray(D), **kw)
    out = tfilm.apply_film_decomposed(
        tp["decoder"], equiv, torch.from_numpy(Z), torch.from_numpy(D), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    sj, mj = jenc.film_inputs(equiv, jnp.asarray(Z), jnp.asarray(D))
    st, mt = tenc.film_inputs(equiv, torch.from_numpy(Z), torch.from_numpy(D))
    ref_c = jfilm.apply_film_concat(jp["decoder"], sj, mj, **kw)
    out_c = tfilm.apply_film_concat(tp["decoder"], st, mt, **kw)
    np.testing.assert_allclose(_np(out_c), _np(ref_c), atol=1e-5)
    fj = jfilm.apply_mapping_network(jp["decoder"]["mapping"], mj)
    ft = tfilm.apply_mapping_network(tp["decoder"]["mapping"], mt)
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)


def test_first_layer_split_matches_jax():
    jm, jp, tp = _model(equivariance="SO2")
    w = jp["decoder"]["layers"][0]["w"]
    ref = jsiren.split_first_layer(w, "SO2", 5)
    out = tsiren.split_first_layer(tp["decoder"]["layers"][0]["w"], "SO2", 5)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_model_apply_plain_path_matches_jax(conditioning):
    """use_pallas on, with a hidden width both fused kernels decline (not a
    multiple of 16): on the CPU the plain decoder path, with a shared
    (1, P) grid broadcast over the batch."""
    jm, jp, tp = _model(seed=5, model_type="VariationalAutoDecoder",
                        conditioning=conditioning, mapping_layers=1,
                        mapping_features=16, use_pallas=True, hidden_features=24)
    tm = RENIModel(RENIConfig(**jm.config.__dict__))
    D = jsph.get_directions(16)
    ref = jm.apply_idx(jp, [0, 2], D)
    out = tm.apply_idx(tp, [0, 2], tsph.get_directions(16, device="cpu"))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    np.testing.assert_array_equal(_np(tm.latents(tp, 1)), _np(jm.latents(jp, 1)))


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_model_apply_fused_path_where_pallas_declines(conditioning):
    """H = 32 and width 6 (P = 18): the Pallas guard declines both, the
    CUDA kernel's limits do not, so the port takes the fused wrapper (its
    plain trunk on the CPU), not the decomposed decoder."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    jm, jp, tp = _model(seed=9, conditioning=conditioning, mapping_layers=1,
                        mapping_features=16, use_pallas=True, hidden_features=32)
    cfg = RENIConfig(**jm.config.__dict__)
    D = tsph.get_directions(6, device="cpu")
    model = RENIModel(cfg)
    Z = model.latents(tp, [0, 2])
    out = model.apply(tp, Z, D)
    kw = dict(hidden_layers=cfg.hidden_layers, hidden_features=32, out_features=3,
              output_activation="tanh", trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine)
    if cfg.is_film:
        ref = tk.fused_film_apply_reference(tp["decoder"], cfg.equivariance, Z, D, **kw)
    else:
        ref = tk.fused_apply_reference(tp["decoder"], cfg.equivariance, cfg.latent_dim, Z, D,
                                       first_omega_0=30.0, hidden_omega_0=30.0, **kw)
    assert out.shape == (2, 18, 3)
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("entry", ZOO, ids=lambda p: os.path.basename(p.rstrip("/")))
def test_zoo_decode_matches_jax(entry):
    """Every Zoo entry (use_pallas, bf16 trunk, fast sine) loaded by the
    port's checkpoint module decodes 2 test latents at width 32 within the
    bf16 bars of JAX RENIModel.apply (interpret-mode Pallas kernel)."""
    path = os.path.join(entry, "latents_test")
    jp, _ = jck.load_checkpoint(path)
    jm = JModel(jck.load_model_config(path))
    tp, _ = tck.load_checkpoint(path)
    tm = RENIModel(tck.load_model_config(path))
    assert tm.config == RENIConfig(**jm.config.__dict__) and tm.config.use_pallas
    tp = tparams.from_numpy(tp, "cpu")
    ref = _np(jm.apply_idx(jp, [0, 1], jsph.get_directions(32)))
    out = _np(tm.apply_idx(tp, [0, 1], tsph.get_directions(32, device="cpu")))
    assert out.shape == ref.shape == (2, 512, 3)
    err = np.abs(out - ref)
    print(f"{os.path.basename(entry.rstrip('/'))}: max {err.max():.3g}, mean {err.mean():.3g}")
    # both sides round the same bf16 operands: measured max 3.8e-3 (exp
    # entry), mean <= 2.4e-5
    assert err.max() < BF16_MAX and err.mean() < BF16_MEAN, (err.max(), err.mean())


def test_params_round_trip_exact():
    _, jp, _ = _model(seed=6, conditioning="FiLM", mapping_layers=1, mapping_features=16)
    tree = jax.device_get(jp)
    back = tparams.to_numpy(tparams.from_numpy(tree, "cpu"))
    flat_a, flat_b = tck._flatten(tree), tck._flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


@pytest.mark.parametrize("entry", ZOO[:1] + ZOO[-1:], ids=["cbc", "film"])
def test_zoo_checkpoint_loads_identically(entry):
    path = os.path.join(entry, "checkpoint")
    jp, jmeta = jck.load_checkpoint(path)
    tp, tmeta = tck.load_checkpoint(path)
    assert jmeta == tmeta
    fj, ft = tck._flatten(jax.device_get(jp)), tck._flatten(tp)
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k])


def test_port_checkpoint_read_by_jax(tmp_path):
    """A checkpoint written by the port reads back exactly in the JAX
    package, config included."""
    jm, jp, tp = _model(seed=7, model_type="VariationalAutoDecoder")
    cfg = RENIConfig(**jm.config.__dict__)
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, tp, model_config=cfg, metadata={"epoch": 3})
    back, meta = jck.load_checkpoint(path)
    assert meta["epoch"] == 3
    assert jck.load_model_config(path) == jm.config
    fj, ft = tck._flatten(jax.device_get(back)), tck._flatten(tparams.to_numpy(tp))
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(fj[k], ft[k])
    assert tck.load_model_config(path) == cfg


# ---------------------------------------------------------------------------
# init and latent sampling (the FIT_DECODER slice)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ["VariationalAutoDecoder", "AutoDecoder"])
def test_sample_latent_matches_jax_with_the_same_noise(model_type):
    """Z = mu + eps * exp(log_var / 2) with the noise JAX drew fed in: Z, mu
    and log_var to rtol 1e-6; an AD returns (Z, Z, zeros)."""
    jm, jp, tp = _model(seed=3, model_type=model_type)
    model = RENIModel(RENIConfig(**jm.config.__dict__))
    idx = [2, 0]
    key = jax.random.PRNGKey(5)
    ref = jm.sample_latent(jp, idx, key)
    noise = _np(jax.random.normal(key, (2, 5, 3), jnp.float32))
    got = model.sample_latent(tp, idx, noise=torch.from_numpy(noise.copy()))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-6, atol=1e-7)
    if model_type == "AutoDecoder":
        assert got[2].abs().max() == 0.0 and torch.equal(got[0], got[1])
    else:
        # from the generator: reproducible, N(0, 1) noise scaled by the std
        a = model.sample_latent(tp, idx, torch.Generator().manual_seed(1))[0]
        b = model.sample_latent(tp, idx, torch.Generator().manual_seed(1))[0]
        c = model.sample_latent(tp, idx, torch.Generator().manual_seed(2))[0]
        assert torch.equal(a, b) and not torch.equal(a, c)
        eps = (a - got[1]) / torch.exp(0.5 * got[2])
        assert eps.abs().max() < 6.0 and 0.5 < eps.std() < 1.5


def test_apply_idx_samples_with_a_generator():
    """A VAD with a trainable decoder decodes a sample when given a
    generator, and mu without one (RENIModel.apply_idx of the JAX package)."""
    jm, jp, tp = _model(seed=4, model_type="VariationalAutoDecoder")
    model = RENIModel(RENIConfig(**jm.config.__dict__))
    D = torch.from_numpy(_zd()[1])
    det = model.apply_idx(tp, [0, 1], D)
    assert torch.equal(det, model.apply(tp, tp["latents"]["mu"][[0, 1]], D))
    gen = torch.Generator().manual_seed(3)
    Z = model.sample_latent(tp, [0, 1], torch.Generator().manual_seed(3))[0]
    assert torch.equal(model.apply_idx(tp, [0, 1], D, gen), model.apply(tp, Z, D))


@pytest.mark.parametrize("equiv", EQUIVS)
def test_init_matches_jax_tree_and_bounds(equiv):
    """model.init: the JAX tree (keys, shapes, dtypes), every leaf inside its
    uniform bound and, where it has 32 values or more, filling most of it (first layer scale / in, hidden and
    final sqrt(6 / H) / omega, biases 1 / sqrt(in)), latents N(0, 1) and
    N(-5, 1); reproducible from the generator's seed."""
    cfg = dict(model_type="VariationalAutoDecoder", equivariance=equiv, latent_dim=6,
               hidden_layers=3, hidden_features=64, first_layer_init_scale=2.0)
    jp = jax.device_get(JModel(JConfig(**cfg)).init(jax.random.PRNGKey(0), dataset_size=50))
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(0), 50, device="cpu")
    flat_j, flat_t = tck._flatten(jp), tck._flatten(tparams.to_numpy(tp))
    assert flat_j.keys() == flat_t.keys()
    n_in = tenc.concat_in_features(equiv, 6)
    hidden = np.sqrt(6.0 / 64) / 30.0
    for k, v in flat_t.items():
        assert v.shape == flat_j[k].shape and v.dtype == flat_j[k].dtype, k
        if not k.startswith("decoder"):
            continue
        first = k.startswith("decoder/layers/0/")
        if k.endswith("/w"):
            bound = 2.0 / n_in if first else hidden
        else:
            bound = 1.0 / np.sqrt(n_in if first else 64)
        assert np.abs(v).max() <= bound, (k, bound)
        assert v.size < 32 or np.abs(v).max() > 0.9 * bound, (k, bound)
        assert np.abs(flat_j[k]).max() <= bound, k
    assert abs(flat_t["latents/mu"].std() - 1.0) < 0.1
    assert abs(flat_t["latents/log_var"].mean() + 5.0) < 0.1
    again = tck._flatten(tparams.to_numpy(
        model.init(torch.Generator().manual_seed(0), 50, device="cpu")))
    other = tck._flatten(tparams.to_numpy(
        model.init(torch.Generator().manual_seed(1), 50, device="cpu")))
    for k in flat_t:
        np.testing.assert_array_equal(again[k], flat_t[k])
        assert not np.array_equal(other[k], flat_t[k]), k


def test_port_initialised_tree_loads_into_jax(tmp_path):
    """A tree from the port's init, saved by the port, loads into the JAX
    model, which decodes it as the port does (atol 1e-5, the serving bar)."""
    cfg = dict(model_type="VariationalAutoDecoder", latent_dim=5, hidden_layers=2,
               hidden_features=32, output_activation="tanh")
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(2), 4, device="cpu")
    path = str(tmp_path / "fresh")
    tck.save_checkpoint(path, tp, model_config=model.config)
    jparams, meta = jck.load_checkpoint(path)
    jm = JModel(JConfig(**meta["model_config"]))
    Z, D = _zd(B=4)
    ref = jm.apply(jparams, jparams["latents"]["mu"], jnp.asarray(D))
    out = model.apply(tp, tp["latents"]["mu"], torch.from_numpy(D))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


def test_film_init_waits_for_its_slice():
    """A FiLM model initialises (it raised NotImplementedError until FiLM
    training was ported), in the JAX layout, and build_model is RENIModel."""
    from reni_tpu_torch.models.reni import build_model

    model = build_model(RENIConfig(conditioning="FiLM", latent_dim=5, hidden_layers=2,
                                   hidden_features=32, mapping_layers=1, mapping_features=16))
    assert isinstance(model, RENIModel)
    dec = model.init_decoder(torch.Generator().manual_seed(0), device="cpu")
    assert set(dec) == {"layers", "final", "mapping"} and len(dec["layers"]) == 2
    assert tuple(dec["mapping"]["last"]["w"].shape) == (16, 2 * 2 * 32)


@pytest.mark.parametrize("equiv", EQUIVS)
def test_film_init_matches_jax_tree_and_bounds(equiv):
    """FiLM model.init: the JAX tree (keys, shapes, dtypes; for None the
    consistent widths (N, 3N)); every uniform leaf inside its bound and, with
    32 values or more, filling most of it (first layer scale / in, trunk and
    final sqrt(6 / H) / 25, biases 1 / sqrt(in)); the kaiming leaves' std
    within 10% of gain / sqrt(in), the last mapping weight's a quarter of
    that; reproducible from the generator's seed."""
    cfg = dict(model_type="VariationalAutoDecoder", conditioning="FiLM", equivariance=equiv,
               latent_dim=6, hidden_layers=3, hidden_features=64, mapping_layers=2,
               mapping_features=48, first_layer_init_scale=2.0)
    jp = jax.device_get(JModel(JConfig(**cfg)).init(jax.random.PRNGKey(0), dataset_size=50))
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(0), 50, device="cpu")
    flat_j, flat_t = tck._flatten(jp), tck._flatten(tparams.to_numpy(tp))
    assert flat_j.keys() == flat_t.keys()
    s_in, m_in = tenc.film_in_features(equiv, 6)
    assert (s_in, m_in) == jenc.film_in_features(equiv, 6)
    assert flat_t["decoder/layers/0/w"].shape == (s_in, 64)
    assert flat_t["decoder/mapping/layers/0/w"].shape == (m_in, 48)
    assert flat_t["decoder/mapping/last/w"].shape == (48, 2 * 3 * 64)
    trunk = np.sqrt(6.0 / 64) / 25.0
    gain = np.sqrt(2.0 / (1.0 + 0.2 ** 2))
    for k, v in flat_t.items():
        assert v.shape == flat_j[k].shape and v.dtype == flat_j[k].dtype, k
        if not k.startswith("decoder"):
            continue
        fan_in = flat_t[k[:-1] + "w"].shape[0]
        if k.startswith("decoder/mapping") and k.endswith("/w"):
            std = gain / np.sqrt(fan_in) * (0.25 if "/last/" in k else 1.0)
            assert abs(v.std() / std - 1.0) < 0.1, (k, v.std(), std)
            assert abs(flat_j[k].std() / std - 1.0) < 0.1, k
            assert abs(v.mean()) < 0.1 * std, k
            continue
        if k.endswith("/w"):
            bound = 2.0 / s_in if k == "decoder/layers/0/w" else trunk
        else:
            bound = 1.0 / np.sqrt(fan_in)
        assert np.abs(v).max() <= bound, (k, bound)
        assert v.size < 32 or np.abs(v).max() > 0.9 * bound, (k, bound)
        assert np.abs(flat_j[k]).max() <= bound, k
    last, first = flat_t["decoder/mapping/last/w"], flat_t["decoder/mapping/layers/1/w"]
    assert abs(last.std() / first.std() - 0.25) < 0.03  # both have fan-in 48
    assert abs(flat_t["latents/mu"].std() - 1.0) < 0.1
    again = tck._flatten(tparams.to_numpy(
        model.init(torch.Generator().manual_seed(0), 50, device="cpu")))
    other = tck._flatten(tparams.to_numpy(
        model.init(torch.Generator().manual_seed(1), 50, device="cpu")))
    for k in flat_t:
        np.testing.assert_array_equal(again[k], flat_t[k])
        assert not np.array_equal(other[k], flat_t[k]), k


@pytest.mark.parametrize("equiv", EQUIVS)
@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_apply_concat_matches_apply_and_jax(conditioning, equiv):
    """RENIModel.apply_concat (the concat encoding built in full) equals apply
    on a fresh tree of the port's init (atol 1e-5), with a shared (1, P) grid
    broadcast over the batch, and equals JAX apply_concat on the same tree."""
    cfg = dict(model_type="AutoDecoder", conditioning=conditioning, equivariance=equiv,
               latent_dim=5, hidden_layers=2, hidden_features=32, mapping_layers=2,
               mapping_features=16, output_activation="tanh")
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(3), 3, device="cpu")
    Z, D = _zd(seed=8)
    out = model.apply_concat(tp, torch.from_numpy(Z), torch.from_numpy(D))
    assert out.shape == (3, 64, 3)
    np.testing.assert_allclose(_np(out), _np(model.apply(tp, torch.from_numpy(Z),
                                                         torch.from_numpy(D))), atol=1e-5)
    jp = jax.tree.map(jnp.asarray, tparams.to_numpy(tp))
    ref = JModel(JConfig(**cfg)).apply_concat(jp, jnp.asarray(Z), jnp.asarray(D))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


@pytest.mark.parametrize("equiv", EQUIVS)
def test_port_initialised_film_tree_loads_into_jax(equiv, tmp_path):
    """A FiLM tree from the port's init, saved by the port, loads into the JAX
    model, which decodes it as the port does (atol 1e-5, the serving bar)."""
    cfg = dict(model_type="VariationalAutoDecoder", conditioning="FiLM", equivariance=equiv,
               latent_dim=5, hidden_layers=2, hidden_features=32, mapping_layers=2,
               mapping_features=16, output_activation="tanh")
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(2), 4, device="cpu")
    path = str(tmp_path / "fresh_film")
    tck.save_checkpoint(path, tp, model_config=model.config)
    jparams, meta = jck.load_checkpoint(path)
    jm = JModel(JConfig(**meta["model_config"]))
    assert jm.config.is_film and set(jparams["decoder"]) == {"layers", "final", "mapping"}
    Z, D = _zd(B=4)
    ref = jm.apply(jparams, jparams["latents"]["mu"], jnp.asarray(D))
    out = model.apply(tp, tp["latents"]["mu"], torch.from_numpy(D))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
