"""The fused train steps (reni_tpu_torch.kernels.siren_step) held against the
JAX package's Pallas _step_kernel and _film_step_kernel, run in interpret
mode on the CPU as tests/test_pallas.py runs them. On the CPU a wrapper takes
its plain PyTorch version; the CUDA kernels themselves are checked on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.kernels import siren_pallas as jk
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import encodings as tenc
from reni_tpu_torch.kernels import siren_bwd as tb
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.kernels import siren_step as ts
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import losses as tlosses


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(equiv="SO2", act="tanh", per_image=False, N=5, L=2, H=128, B=3, P=128, seed=0):
    """A JAX-initialised decoder carried into the port, and numpy inputs: Z,
    D (shared or per-image), targets, pixel weights and a batch mask whose
    last row is zero (the ragged tail)."""
    cfg = JConfig(model_type="AutoDecoder", equivariance=equiv, latent_dim=N, hidden_layers=L,
                  hidden_features=H, output_activation=act)
    jp = JModel(cfg).init(jax.random.PRNGKey(seed), dataset_size=B)["decoder"]
    rng = np.random.default_rng(seed + 1)
    # exp is kept well-conditioned, as tests/test_pallas.py does
    Z = rng.normal(size=(B, N, 3)).astype(np.float32) * (0.02 if act == "exp" else 1.0)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    tgt = rng.normal(size=(B, P, 3)).astype(np.float32)
    sw = np.abs(rng.normal(size=(1, P, 3))).astype(np.float32)
    bm = np.ones((B,), np.float32)
    bm[-1] = 0.0
    return cfg, jp, tparams.from_numpy(jax.device_get(jp), "cpu"), (Z, D, tgt, sw, bm)


def _kw(cfg, trunk, fast_sine=False):
    return dict(hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
                out_features=cfg.out_features, first_omega_0=cfg.first_omega_0,
                hidden_omega_0=cfg.hidden_omega_0, output_activation=cfg.output_activation,
                trunk=trunk, fast_sine=fast_sine)


def _both(cfg, jp, tp, inputs, trunk, fast_sine=False, port=ts.fused_step_mse, scale=1.0):
    """(value, d/dZ, flat d/d decoder) of scale * fused_step_mse, from JAX
    (Pallas, interpret mode) and from the port."""
    Z, D, tgt, sw, bm = inputs
    kw = _kw(cfg, trunk, fast_sine)

    def jloss(dec, z):
        return scale * jk.fused_step_mse(
            dec, cfg.equivariance, cfg.latent_dim, z, jnp.asarray(D), jnp.asarray(tgt),
            jnp.asarray(sw), jnp.asarray(bm), interpret=True, **kw)

    jl, (jd, jz) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(Z))
    tz = torch.from_numpy(Z).requires_grad_()
    tp = tparams.map_tree(lambda t: t.detach().clone().requires_grad_(), tp)
    tl = scale * port(tp, cfg.equivariance, cfg.latent_dim, tz, torch.from_numpy(D),
                      torch.from_numpy(tgt), torch.from_numpy(sw), torch.from_numpy(bm), **kw)
    tl.backward()
    flat_t = tck._flatten(tparams.map_tree(lambda t: _np(t.grad), tp))
    flat_j = tck._flatten(jax.device_get(jd))
    assert flat_t.keys() == flat_j.keys()
    return (float(jl), _np(jz), flat_j), (tl.item(), _np(tz.grad), flat_t)


@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per_image"])
@pytest.mark.parametrize("act", ["tanh", "exp", None])
@pytest.mark.parametrize("equiv", ["SO2", "SO3"])
def test_step_matches_pallas_f32(equiv, act, per_image):
    """Float32 trunk, a zero-masked row: value rtol 2e-6; gradients w.r.t. Z
    and every decoder leaf rtol 1e-4, atol 2e-6 (the bars of
    test_fused_step_loss_and_grads_match_reference)."""
    cfg, jp, tp, inputs = _setup(equiv=equiv, act=act, per_image=per_image)
    (jl, jz, jd), (tl, tz, td) = _both(cfg, jp, tp, inputs, "float32")
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    np.testing.assert_allclose(tz, jz, rtol=1e-4, atol=2e-6)
    assert np.abs(tz[-1]).max() == 0.0  # the masked row gets no gradient
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=2e-6, err_msg=k)


def test_step_matches_pallas_fast_sine():
    """The polynomial sincos on both sides, same bars."""
    cfg, jp, tp, inputs = _setup(seed=4)
    (jl, jz, jd), (tl, tz, td) = _both(cfg, jp, tp, inputs, "float32", fast_sine=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    np.testing.assert_allclose(tz, jz, rtol=1e-4, atol=2e-6)
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("act", ["tanh", None])
def test_step_matches_pallas_bf16(act):
    """bf16 trunk: both sides round the same operands (g, dz and d too) and
    sum in float32 in another order; a flipped bf16 rounding of an activation
    then propagates. The output behind the loss holds the bars of
    test_fused_bf16_trunk_close (max 0.05, mean 0.01), so the loss agrees
    well inside 1e-3 relative; each gradient is held to 2.5e-3 of its
    largest entry, the bar of test_plain_bwd_matches_pallas_bf16. Measured on
    these inputs: loss 1.7e-7, worst gradient 5.4e-4."""
    cfg, jp, tp, inputs = _setup(act=act, seed=6)
    (jl, jz, jd), (tl, tz, td) = _both(cfg, jp, tp, inputs, "bfloat16", fast_sine=True)
    worst = float(np.abs(tz - jz).max() / np.abs(jz).max())
    for k in jd:
        worst = max(worst, float(np.abs(td[k] - jd[k]).max() / np.abs(jd[k]).max()))
    print(f"bf16 plain step vs Pallas: loss rel {abs(tl - jl) / abs(jl):.3g}, "
          f"worst max|diff|/max|ref| {worst:.3g}")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert worst < 2.5e-3, worst


def test_step_cotangent_scaling():
    """The backward scales the saved gradients by the incoming cotangent
    (test_fused_step_cotangent_scaling: rtol 1e-5 on d/dZ; the decoder leaves
    also get atol 1e-8, as the first-layer weight sums scaled terms that
    cancel), and 3 * loss matches JAX."""
    cfg, jp, tp, inputs = _setup(seed=8)
    _, (t1, z1, d1) = _both(cfg, jp, tp, inputs, "float32")
    (j3, jz3, _), (t3, z3, d3) = _both(cfg, jp, tp, inputs, "float32", scale=3.0)
    np.testing.assert_allclose(z3, 3.0 * z1, rtol=1e-5)
    for k in d1:
        np.testing.assert_allclose(d3[k], 3.0 * d1[k], rtol=1e-5, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(t3, j3, rtol=2e-6)
    np.testing.assert_allclose(z3, jz3, rtol=1e-4, atol=6e-6)


@pytest.mark.parametrize("act", ["tanh", "exp", None])
def test_step_is_weighted_mse_of_apply(act):
    """fused_step_mse == losses.weighted_mse(apply(...), tgt, sw * bmask), value
    (rtol 2e-6) and gradients (rtol 1e-4, atol 2e-6), at a width the Pallas
    kernel declines (H = 32, P = 100)."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup(act=act, H=32, P=100, seed=10)
    model = RENIModel(RENIConfig(**dataclasses.asdict(cfg)))

    def run(fused):
        z = torch.from_numpy(Z).requires_grad_()
        p = tparams.map_tree(lambda t: t.detach().clone().requires_grad_(), tp)
        args = [torch.from_numpy(x) for x in (D, tgt, sw, bm)]
        if fused:
            loss = ts.fused_step_mse(p, cfg.equivariance, cfg.latent_dim, z, *args,
                                     **_kw(cfg, "float32"))
        else:
            out = model.apply({"decoder": p}, z, args[0])
            loss = tlosses.weighted_mse(out, args[1], args[2] * args[3][:, None, None])
        loss.backward()
        return loss.item(), _np(z.grad), tck._flatten(tparams.map_tree(lambda t: _np(t.grad), p))

    (lf, zf, df), (lr, zr, dr) = run(True), run(False)
    np.testing.assert_allclose(lf, lr, rtol=2e-6)
    np.testing.assert_allclose(zf, zr, rtol=1e-4, atol=2e-6)
    for k in dr:
        np.testing.assert_allclose(df[k], dr[k], rtol=1e-4, atol=2e-6, err_msg=k)


def test_step_wrapper_on_cpu_takes_plain_version():
    """On CPU tensors fused_step_mse is fused_step_mse_reference and launches
    nothing; a stride-0 (B, P) grid reads as one shared grid; the operands
    that are not trained get no gradient."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup(seed=12, H=32, P=40)
    args = [torch.from_numpy(x) for x in (Z, D, tgt, sw, bm)]
    kw = _kw(cfg, "bfloat16")
    before = (ts.siren_step_cuda.launches, tk.fused_apply.launches,
              tb.siren_trunk_bwd_cuda.launches)
    a = ts.fused_step_mse(tp, cfg.equivariance, cfg.latent_dim, *args, **kw)
    b = ts.fused_step_mse_reference(tp, cfg.equivariance, cfg.latent_dim, *args, **kw)
    args[1] = args[1].expand(3, *D.shape[1:])
    c = ts.fused_step_mse(tp, cfg.equivariance, cfg.latent_dim, *args, **kw)
    assert a.item() == b.item() == c.item()
    assert before == (ts.siren_step_cuda.launches, tk.fused_apply.launches,
                      tb.siren_trunk_bwd_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        d_feats = tenc.d_features(cfg.equivariance, torch.from_numpy(D))
        ops = tk.pack_inputs(tp, cfg.equivariance, cfg.latent_dim, args[0], d_feats)
        ts.siren_step_cuda(*ops, torch.zeros(3, 40, 8), torch.zeros(1, 40, 8),
                           torch.ones(3, 1, 8), omega0=30.0, omega_h=30.0, out_act="tanh",
                           gscale=1.0)


def test_step_reference_operands_and_results():
    """siren_step_reference on packed operands: the result shapes of
    _step_call_builder, zero loss partials in the padded lanes, and the
    backward chain of siren_trunk_bwd_reference for its own cotangent."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup(seed=14, H=32, P=40, L=3)
    d_feats = tenc.d_features(cfg.equivariance, torch.from_numpy(D))
    with torch.no_grad():
        ops = tk.pack_inputs(tp, cfg.equivariance, cfg.latent_dim, torch.from_numpy(Z), d_feats)
        t8 = tk._pad_last(torch.from_numpy(tgt), 8)
        s8 = tk._pad_last(torch.from_numpy(sw), 8)
        b8 = torch.from_numpy(bm)[:, None, None].expand(3, 1, 8)
        kw = dict(omega0=30.0, omega_h=30.0, trunk="bfloat16", fast_sine=True)
        gscale = 1.0 / (40 * 3)
        mse, *grads = ts.siren_step_reference(*ops, t8, s8, b8, out_act="tanh", gscale=gscale,
                                              **kw)
        out = torch.tanh(tk.siren_trunk_reference(*ops, **kw))
        r = out - t8
        g = (2.0 * gscale) * (r * (s8 * b8)) * (1.0 - out * out)
        ref = tb.siren_trunk_bwd_reference(*ops, g, **kw)
    assert mse.shape == (1, 8) and mse[0, 3:].abs().max() == 0.0
    assert [tuple(x.shape) for x in grads] == [(3, 8, 32), (3, 1, 32), (3, 32, 32), (3, 32),
                                               (32, 8), (1, 8)]
    for x, y in zip(grads, ref):
        assert torch.equal(x, y)
    want = tlosses.weighted_mse(out[..., :3], torch.from_numpy(tgt),
                                torch.from_numpy(sw) * torch.from_numpy(bm)[:, None, None])
    np.testing.assert_allclose((mse.sum() * gscale).item(), want.item(), rtol=2e-6)


@pytest.mark.parametrize(
    "cfg,shape,match",
    [
        (dict(use_pallas=False), (4, 128, 1), "use_pallas off"),
        (dict(conditioning="FiLM", hidden_layers=0), (4, 128, 1), "needs a trunk layer"),
        (dict(last_layer_linear=False), (4, 128, 1), "last_layer_linear"),
        (dict(), (4, 128, 3), "direction grid batch 3"),
        (dict(hidden_features=120), (4, 128, 1), "multiple of 16"),
        (dict(), (70000, 128, 1), "grid limit"),
        (dict(), (4, 0, 1), "no pixels"),
        (dict(hidden_features=512), (4, 128, 1), "shared memory"),
        (dict(hidden_layers=0), (4, 128, 1), "needs a hidden layer"),
        (dict(pallas_trunk="float32", hidden_layers=12), (4, 128, 1), "shared memory"),
    ],
    ids=["off", "film", "sine_final", "grid_batch", "width", "batch", "npix", "smem_wide",
         "no_hidden", "smem_deep"],
)
def test_fused_step_reason_guards(cfg, shape, match):
    """Every guard of RENIModel.apply plus the step kernel's own limits."""
    model = RENIModel(RENIConfig(**{**dict(use_pallas=True), **cfg}))
    assert match in model.fused_step_reason(*shape)


def test_fused_step_reason_accepts_the_published_shapes():
    """The flagship trunk (5 x 256, bf16) at the three curriculum stages, with
    a shared or a per-image grid; and every shape JAX's fused_step_reason
    accepts for it."""
    model = RENIModel(RENIConfig(use_pallas=True))
    jm = JModel(JConfig(use_pallas=True))
    for npix in (512, 2048, 8192):
        assert jm.fused_step_reason(100, npix) is None
        assert model.fused_step_reason(100, npix) is None
        assert model.fused_step_reason(100, npix, 100) is None
    assert model.fused_step_reason(100, 8450) is None  # ragged: not a multiple of 128
    # the passes keep one layer's weights and one 128-row tile: no depth in it
    assert ts.step_smem_bytes("bfloat16", 256, 5) == ts.pass_smem_bytes(256) == 226432
    assert ts.step_smem_bytes("bfloat16", 256, 12) == 226432 <= 227 * 1024
    deep = RENIModel(RENIConfig(use_pallas=True, hidden_layers=12))
    assert deep.fused_step_reason(100, 8192) is None
    # the chain kernel (float32, and bf16 widths not a multiple of 64) keeps
    # every layer of a tile: more than the backward kernel
    assert ts.step_smem_bytes("float32", 256, 5) > tb.bwd_smem_bytes(False, "float32", 256, 5)
    assert ts.step_smem_bytes("bfloat16", 96, 5) > tb.bwd_smem_bytes(False, "bfloat16", 96, 5)


# ---------------------------------------------------------------------------
# the FiLM train step
# ---------------------------------------------------------------------------


def _setup_film(equiv="SO2", act="tanh", per_image=False, N=5, T=3, H=128, B=3, P=128, seed=0):
    """A JAX-initialised FiLM decoder carried into the port, and numpy inputs
    as in _setup (the batch mask's last row is zero)."""
    cfg = JConfig(model_type="AutoDecoder", conditioning="FiLM", equivariance=equiv,
                  latent_dim=N, hidden_layers=T, hidden_features=H, mapping_layers=2,
                  mapping_features=64, output_activation=act)
    jp = JModel(cfg).init(jax.random.PRNGKey(seed), dataset_size=B)["decoder"]
    rng = np.random.default_rng(seed + 1)
    Z = rng.normal(size=(B, N, 3)).astype(np.float32) * (0.02 if act == "exp" else 1.0)
    D = rng.normal(size=(B if per_image else 1, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    tgt = rng.normal(size=(B, P, 3)).astype(np.float32)
    sw = np.abs(rng.normal(size=(1, P, 3))).astype(np.float32)
    bm = np.ones((B,), np.float32)
    bm[-1] = 0.0
    return cfg, jp, tparams.from_numpy(jax.device_get(jp), "cpu"), (Z, D, tgt, sw, bm)


def _film_kw(cfg, trunk, fast_sine=False):
    return dict(hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
                out_features=cfg.out_features, output_activation=cfg.output_activation,
                trunk=trunk, fast_sine=fast_sine)


def _film_both(cfg, jp, tp, inputs, trunk, fast_sine=False, scale=1.0):
    """(value, d/dZ, flat d/d decoder) of scale * fused_film_step_mse, from JAX
    (Pallas, interpret mode) and from the port."""
    Z, D, tgt, sw, bm = inputs
    kw = _film_kw(cfg, trunk, fast_sine)

    def jloss(dec, z):
        return scale * jk.fused_film_step_mse(
            dec, cfg.equivariance, z, jnp.asarray(D), jnp.asarray(tgt), jnp.asarray(sw),
            jnp.asarray(bm), interpret=True, **kw)

    jl, (jd, jz) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(Z))
    tz = torch.from_numpy(Z).requires_grad_()
    tp = tparams.map_tree(lambda t: t.detach().clone().requires_grad_(), tp)
    tl = scale * ts.fused_film_step_mse(
        tp, cfg.equivariance, tz, torch.from_numpy(D), torch.from_numpy(tgt),
        torch.from_numpy(sw), torch.from_numpy(bm), **kw)
    tl.backward()
    flat_t = tck._flatten(tparams.map_tree(lambda t: _np(t.grad), tp))
    flat_j = tck._flatten(jax.device_get(jd))
    assert flat_t.keys() == flat_j.keys()
    return (float(jl), _np(jz), flat_j), (tl.item(), _np(tz.grad), flat_t)


def _assert_film_f32(jax_side, port_side):
    """The bars of test_fused_film_step_loss_and_grads_match_reference."""
    (jl, jz, jd), (tl, tz, td) = jax_side, port_side
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    np.testing.assert_allclose(tz, jz, rtol=1e-4, atol=3e-6)
    assert np.abs(tz[-1]).max() == 0.0  # the masked row gets no gradient
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=3e-6, err_msg=k)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("equiv", ["SO2", "SO3", "None"])
def test_film_step_matches_pallas_f32(equiv, layers):
    """Float32 trunk, a zero-masked row, 1 trunk layer (no H x H product) and
    3: value rtol 2e-6; gradients w.r.t. Z and every decoder leaf (the
    mapping network's through dfreqs and dphases) rtol 1e-4, atol 3e-6."""
    cfg, jp, tp, inputs = _setup_film(equiv=equiv, T=layers)
    _assert_film_f32(*_film_both(cfg, jp, tp, inputs, "float32"))


@pytest.mark.parametrize("per_image", [False, True], ids=["shared", "per_image"])
@pytest.mark.parametrize("act", ["exp", None])
def test_film_step_matches_pallas_f32_activations_and_grids(act, per_image):
    """exp and no output activation, shared and per-image direction grids."""
    cfg, jp, tp, inputs = _setup_film(act=act, per_image=per_image, seed=2)
    _assert_film_f32(*_film_both(cfg, jp, tp, inputs, "float32"))


def test_film_step_matches_pallas_fast_sine():
    """The polynomial sincos on both sides, per-image grids, same bars."""
    cfg, jp, tp, inputs = _setup_film(per_image=True, seed=4)
    _assert_film_f32(*_film_both(cfg, jp, tp, inputs, "float32", fast_sine=True))


@pytest.mark.parametrize("act", ["tanh", None])
def test_film_step_matches_pallas_bf16(act):
    """bf16 trunk, the bars of test_step_matches_pallas_bf16: loss 1e-3
    relative, each gradient 2.5e-3 of its largest entry (a flipped bf16
    rounding of an activation propagates; the frequencies near 30 amplify it
    as omega does). Measured on these inputs: loss 1.7e-7, worst gradient
    7.7e-4."""
    cfg, jp, tp, inputs = _setup_film(act=act, seed=6)
    (jl, jz, jd), (tl, tz, td) = _film_both(cfg, jp, tp, inputs, "bfloat16", fast_sine=True)
    worst = float(np.abs(tz - jz).max() / np.abs(jz).max())
    for k in jd:
        worst = max(worst, float(np.abs(td[k] - jd[k]).max() / np.abs(jd[k]).max()))
    print(f"bf16 plain FiLM step vs Pallas: loss rel {abs(tl - jl) / abs(jl):.3g}, "
          f"worst max|diff|/max|ref| {worst:.3g}")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert worst < 2.5e-3, worst


def test_film_step_cotangent_scaling():
    """The backward scales the saved gradients by the incoming cotangent, and
    3 * loss matches JAX (the bars of test_step_cotangent_scaling; d/dZ also
    gets atol 1e-7: it sums the paths through A0 and through the mapping
    network, scaled terms that cancel)."""
    cfg, jp, tp, inputs = _setup_film(seed=8)
    _, (t1, z1, d1) = _film_both(cfg, jp, tp, inputs, "float32")
    (j3, jz3, _), (t3, z3, d3) = _film_both(cfg, jp, tp, inputs, "float32", scale=3.0)
    np.testing.assert_allclose(z3, 3.0 * z1, rtol=1e-5, atol=1e-7)
    for k in d1:
        np.testing.assert_allclose(d3[k], 3.0 * d1[k], rtol=1e-5, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(t3, j3, rtol=2e-6)
    np.testing.assert_allclose(z3, jz3, rtol=1e-4, atol=9e-6)


@pytest.mark.parametrize("equiv", ["SO2", "SO3", "None"])
def test_film_step_is_weighted_mse_of_apply(equiv):
    """fused_film_step_mse == losses.weighted_mse(apply(...), tgt, sw * bmask):
    value (rtol 2e-6) and gradients to the mapping network, w0 and Z (rtol
    1e-4, atol 3e-6), at a width the Pallas kernel declines (H = 32, P = 100)."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup_film(equiv=equiv, H=32, P=100, seed=10)
    model = RENIModel(RENIConfig(**dataclasses.asdict(cfg)))

    def run(fused):
        z = torch.from_numpy(Z).requires_grad_()
        p = tparams.map_tree(lambda t: t.detach().clone().requires_grad_(), tp)
        args = [torch.from_numpy(x) for x in (D, tgt, sw, bm)]
        if fused:
            loss = ts.fused_film_step_mse(p, cfg.equivariance, z, *args,
                                          **_film_kw(cfg, "float32"))
        else:
            out = model.apply({"decoder": p}, z, args[0])
            loss = tlosses.weighted_mse(out, args[1], args[2] * args[3][:, None, None])
        loss.backward()
        return loss.item(), _np(z.grad), tck._flatten(tparams.map_tree(lambda t: _np(t.grad), p))

    (lf, zf, df), (lr, zr, dr) = run(True), run(False)
    np.testing.assert_allclose(lf, lr, rtol=2e-6)
    np.testing.assert_allclose(zf, zr, rtol=1e-4, atol=3e-6)
    assert any(k.startswith("mapping/") for k in dr) and "layers/0/w" in dr
    for k in dr:
        np.testing.assert_allclose(df[k], dr[k], rtol=1e-4, atol=3e-6, err_msg=k)
        assert np.abs(dr[k]).max() > 0.0, k


def test_film_step_wrapper_on_cpu_takes_plain_version():
    """On CPU tensors fused_film_step_mse is fused_film_step_mse_reference and
    launches nothing; a stride-0 (B, P) grid reads as one shared grid; the
    kernel wrapper refuses CPU tensors."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup_film(seed=12, H=32, P=40)
    args = [torch.from_numpy(x) for x in (Z, D, tgt, sw, bm)]
    kw = _film_kw(cfg, "bfloat16")
    counts = lambda: (ts.film_step_cuda.launches, ts.siren_step_cuda.launches,
                      tk.fused_film_apply.launches, tb.film_trunk_bwd_cuda.launches)
    before = counts()
    a = ts.fused_film_step_mse(tp, cfg.equivariance, *args, **kw)
    b = ts.fused_film_step_mse_reference(tp, cfg.equivariance, *args, **kw)
    args[1] = args[1].expand(3, *D.shape[1:])
    c = ts.fused_film_step_mse(tp, cfg.equivariance, *args, **kw)
    assert a.item() == b.item() == c.item()
    assert before == counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        d_feats = tenc.d_features(cfg.equivariance, torch.from_numpy(D))
        ops = tk.pack_film_inputs(tp, cfg.equivariance, args[0], d_feats, 32)
        ts.film_step_cuda(*ops, torch.zeros(3, 40, 8), torch.zeros(1, 40, 8),
                          torch.ones(3, 1, 8), out_act="tanh", gscale=1.0)


def test_film_step_reference_operands_and_results():
    """film_step_reference on packed operands: the result shapes of the Pallas
    FiLM step call (dbs has T rows, dWs T - 1), zero loss partials in
    the padded lanes, and the backward chain of film_trunk_bwd_reference for
    its own cotangent, bit for bit; one trunk layer gives an empty dWs."""
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup_film(seed=14, H=32, P=40, T=3)
    d_feats = tenc.d_features(cfg.equivariance, torch.from_numpy(D))
    with torch.no_grad():
        ops = tk.pack_film_inputs(tp, cfg.equivariance, torch.from_numpy(Z), d_feats, 32)
        t8 = tk._pad_last(torch.from_numpy(tgt), 8)
        s8 = tk._pad_last(torch.from_numpy(sw), 8)
        b8 = torch.from_numpy(bm)[:, None, None].expand(3, 1, 8)
        kw = dict(trunk="bfloat16", fast_sine=True)
        gscale = 1.0 / (40 * 3)
        mse, *grads = ts.film_step_reference(*ops, t8, s8, b8, out_act="tanh", gscale=gscale,
                                             **kw)
        out = torch.tanh(tk.film_trunk_reference(*ops, **kw))
        r = out - t8
        g = (2.0 * gscale) * (r * (s8 * b8)) * (1.0 - out * out)
        ref = tb.film_trunk_bwd_reference(*ops, g, **kw)
    assert mse.shape == (1, 8) and mse[0, 3:].abs().max() == 0.0
    assert [tuple(x.shape) for x in grads] == [(3, 8, 32), (2, 32, 32), (3, 32), (32, 8),
                                               (1, 8), (3, 1, 96), (3, 1, 96)]
    for x, y in zip(grads, ref):
        assert torch.equal(x, y)
    want = tlosses.weighted_mse(out[..., :3], torch.from_numpy(tgt),
                                torch.from_numpy(sw) * torch.from_numpy(bm)[:, None, None])
    np.testing.assert_allclose((mse.sum() * gscale).item(), want.item(), rtol=2e-6)
    cfg, jp, tp, (Z, D, tgt, sw, bm) = _setup_film(seed=15, H=32, P=40, T=1)
    with torch.no_grad():
        ops = tk.pack_film_inputs(tp, cfg.equivariance, torch.from_numpy(Z), d_feats, 32)
        grads = ts.film_step_reference(*ops, t8, s8, b8, out_act=None, gscale=gscale, **kw)
    assert tuple(grads[2].shape) == (0, 32, 32) and tuple(grads[3].shape) == (1, 32)


@pytest.mark.parametrize(
    "cfg,shape,match",
    [
        (dict(use_pallas=False), (4, 128, 1), "use_pallas off"),
        (dict(), (4, 128, 3), "direction grid batch 3"),
        (dict(hidden_features=120), (4, 128, 1), "multiple of 16"),
        (dict(), (70000, 128, 1), "grid limit"),
        (dict(), (4, 0, 1), "no pixels"),
        (dict(hidden_features=512), (4, 128, 1), "shared memory"),
        (dict(hidden_layers=0), (4, 128, 1), "needs a trunk layer"),
        (dict(hidden_layers=7, hidden_features=320), (4, 128, 1), "FiLM train step of a 7 x 320"),
        (dict(pallas_trunk="float32", hidden_layers=12), (4, 128, 1), "shared memory"),
    ],
    ids=["off", "grid_batch", "width", "batch", "npix", "smem_wide", "no_layer", "smem_deep",
         "smem_deep_f32"],
)
def test_fused_step_reason_film_guards(cfg, shape, match):
    """Every guard of fused_step_reason for a FiLM model: those of
    RENIModel.apply, then the FiLM step kernel's own limits."""
    model = RENIModel(RENIConfig(**{**dict(use_pallas=True, conditioning="FiLM"), **cfg}))
    assert match in model.fused_step_reason(*shape)


def test_fused_step_reason_accepts_the_published_film_shapes():
    """The FiLM Zoo trunk (5 x 256, bf16) at the three curriculum stages with a
    shared or a per-image grid, and every shape JAX's fused_step_reason
    accepts for it; last_layer_linear matters only for Cond-by-Concat (JAX's
    rule); one trunk layer is taken; the shared-memory mirror of
    csrc/siren_step.cuh."""
    model = RENIModel(RENIConfig(use_pallas=True, conditioning="FiLM"))
    jm = JModel(JConfig(use_pallas=True, conditioning="FiLM"))
    for npix in (512, 2048, 8192):
        assert jm.fused_step_reason(100, npix) is None
        assert model.fused_step_reason(100, npix) is None
        assert model.fused_step_reason(100, npix, 100) is None
    assert model.fused_step_reason(100, 8450) is None  # ragged: not a multiple of 128
    sine_final = dict(use_pallas=True, conditioning="FiLM", last_layer_linear=False)
    assert JModel(JConfig(**sine_final)).fused_step_reason(100, 8192) is None
    assert RENIModel(RENIConfig(**sine_final)).fused_step_reason(100, 8192) is None
    one = RENIModel(RENIConfig(use_pallas=True, conditioning="FiLM", hidden_layers=1))
    assert one.fused_step_reason(100, 8192) is None
    # the passes: the Cond-by-Concat layout, no depth in it
    assert ts.film_step_smem_bytes("bfloat16", 256, 4) == ts.step_smem_bytes(
        "bfloat16", 256, 4, film=True) == ts.pass_smem_bytes(256)
    # the chain kernel (one trunk layer; bf16 widths not a multiple of 64):
    # what it keeps beyond the FiLM backward kernel is a target, a
    # pixel-weight and a loss tile (the 8 loss partials fit the sums' padding)
    assert not ts.pass_route("bfloat16", 256, 0)
    assert ts.film_step_smem_bytes("bfloat16", 96, 4) - tb.bwd_smem_bytes(
        True, "bfloat16", 96, 4) == 3 * 512
    deep = RENIModel(RENIConfig(use_pallas=True, conditioning="FiLM", hidden_layers=12))
    assert deep.fused_step_reason(100, 8192) is None  # past the chain kernel's 6 layers
    assert ts.film_step_smem_bytes("float32", 256, 4) < 227 * 1024


# ---------------------------------------------------------------------------
# the layer-major passes (csrc/step_passes.cuh): plan, routing and the plain
# passes chained
# ---------------------------------------------------------------------------


def _pass_operands(film, B, P, H, n_mm, per_image, act, seed):
    """Packed step operands from a seeded numpy generator: SIREN-scaled
    weights, frequencies near 30 (FiLM), a masked last row."""
    rng = np.random.default_rng(seed)
    u = lambda *s, b=1.0: torch.from_numpy(rng.uniform(-b, b, size=s).astype(np.float32))
    d = torch.zeros(B if per_image else 1, P, 8)
    d[..., :4] = u(d.shape[0], P, 4)
    a = torch.zeros(B, 8, H)
    a[:, :4] = u(B, 4, H, b=0.5 if act != "exp" else 0.02)
    ws = u(n_mm, H, H, b=np.sqrt(6 / H) / 30)
    wf = torch.zeros(H, 8)
    wf[:, :3] = u(H, 3, b=np.sqrt(6 / H) / 30)
    bf = torch.zeros(1, 8)
    bf[0, :3] = u(3, b=0.1)
    tgt, sw = torch.zeros(B, P, 8), torch.zeros(1, P, 8)
    tgt[..., :3], sw[..., :3] = u(B, P, 3), u(1, P, 3).abs()
    bm = torch.ones(B, 1, 8)
    bm[-1] = 0.0
    kw = dict(out_act=act, gscale=1.0 / (3 * P), fast_sine=True)
    if film:
        T = n_mm + 1
        ops = (d, a, ws, u(T, H, b=0.05), wf, bf, 30 + 5 * u(B, 1, T * H), u(B, 1, T * H))
        return (*ops, tgt, sw, bm), kw
    kw.update(omega0=30.0, omega_h=30.0)
    return (d, a, u(B, 1, H, b=0.1), ws, u(n_mm, H, b=0.05), wf, bf, tgt, sw, bm), kw


PASS_CASES = [  # (film, B, P, H, n_mm, per-image grids, output activation)
    (False, 3, 300, 64, 2, False, "tanh"),  # P = 2 x 128 + 44: a ragged tail tile
    (False, 3, 200, 64, 3, True, "exp"),
    (False, 2, 130, 64, 9, False, None),  # deeper than any chain-kernel ceiling at H = 64
    (False, 2, 130, 256, 7, False, "tanh"),  # the chain kernel's ceiling at H = 256 is 5
    (True, 3, 300, 64, 2, False, "tanh"),
    (True, 3, 200, 64, 3, True, "exp"),
    (True, 2, 130, 64, 9, False, None),
    (True, 2, 130, 256, 7, False, "tanh"),  # 8 trunk layers; the chain kernel's ceiling is 6
]


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PASS_CASES,
                         ids=[f"{'film' if c[0] else 'cbc'}-H{c[3]}-mm{c[4]}-P{c[2]}"
                              for c in PASS_CASES])
def test_plain_passes_match_step_reference(case, trunk):
    """The plain passes chained (scratch, per-CTA slots of a 2-SM card, slot
    sums, dWs over the scratch) equal the whole-step plain version. Bars:
    float32 rtol 1e-6 with atol 1e-6 x max |reference| (the slots sum in
    another order); bf16 the step bars of tests/test_torch_cuda.py (loss 1e-4
    relative, each gradient 1e-2 x max |reference|)."""
    film, B, P, H, n_mm, per_image, act = case
    ops, kw = _pass_operands(film, B, P, H, n_mm, per_image, act, seed=20)
    kw["trunk"] = trunk
    ref = (ts.film_step_reference if film else ts.siren_step_reference)(*ops, **kw)
    got = ts.step_passes_reference(film, ops, kw, sms=2)
    assert ts.step_plan(film, B, P, H, n_mm, 2).chunks > 1  # several CTAs per image
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in ref]
    for i, (x, y) in enumerate(zip(got, ref)):
        scale = float(y.abs().max()) if y.numel() else 0.0
        if trunk == "float32":
            np.testing.assert_allclose(_np(x), _np(y), rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=str(i))
        elif i == 0:
            np.testing.assert_allclose(float(x.sum()), float(y.sum()), rtol=1e-4)
        else:
            assert float((x - y).abs().max()) <= 1e-2 * scale, i
    assert float(got[1][-1].abs().max()) == 0.0  # the masked row: dA = 0


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_plain_passes_match_pallas(film, trunk, monkeypatch):
    """The plain passes chained, behind fused_step_mse / fused_film_step_mse,
    against the Pallas _step_kernel / _film_step_kernel in interpret mode
    (a ragged P = 200, a masked row), at the bars of
    test_step_matches_pallas_f32 / _bf16 and their FiLM counterparts."""
    steps = {f: (lambda *ops, _f=f, **kw: ts.step_passes_reference(_f, ops, kw, sms=2),) * 2
             for f in (False, True)}
    monkeypatch.setattr(ts.StepMSE, "steps", steps)
    if film:
        cfg, jp, tp, inputs = _setup_film(P=200, seed=22)
        fast = trunk == "bfloat16"
        jside, tside = _film_both(cfg, jp, tp, inputs, trunk, fast_sine=fast)
    else:
        cfg, jp, tp, inputs = _setup(P=200, seed=22)
        fast = trunk == "bfloat16"
        jside, tside = _both(cfg, jp, tp, inputs, trunk, fast_sine=fast)
    if trunk == "float32":
        if film:
            _assert_film_f32(jside, tside)
        else:
            (jl, jz, jd), (tl, tz, td) = jside, tside
            np.testing.assert_allclose(tl, jl, rtol=2e-6)
            np.testing.assert_allclose(tz, jz, rtol=1e-4, atol=2e-6)
            for k in jd:
                np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=2e-6, err_msg=k)
        return
    (jl, jz, jd), (tl, tz, td) = jside, tside
    worst = float(np.abs(tz - jz).max() / np.abs(jz).max())
    for k in jd:
        worst = max(worst, float(np.abs(td[k] - jd[k]).max() / np.abs(jd[k]).max()))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert worst < 2.5e-3, worst


def test_step_plan_grid_slots_and_scratch():
    """The pass plan at the flagship shape (100 x 8,192, 5 x 256) on a
    132-SM card: 64 tiles per image in 6 CTAs of 12 tiles, 10 passes, the
    slot and scratch shapes the kernels index, and about 23 KB of scratch
    traffic per row."""
    plan = ts.step_plan(False, 100, 8192, 256, 5, 132)
    assert (plan.tiles_per_cta, plan.chunks) == (12, 6)
    assert plan.passes == (("fwd", 0), ("fwd", 1), ("fwd", 2), ("fwd", 3), ("last", 4),
                           ("bwd", 4), ("bwd", 3), ("bwd", 2), ("bwd", 1), ("bwd", 0))
    assert plan.scratch_shapes() == {
        "sc_h": (5, 819200, 256), "sc_keep": (4, 819200, 256), "sc_dz": (5, 819200, 256),
        "part_img": (100, 6, 9 * 256), "part_w": (600, 8 + 5 * 256 + 8 * 256 + 8)}
    per_row = (sum(plan.pass_cost(k)[1] for k in range(10)) + plan.wgrad_cost()[1]) / plan.rows
    assert 22_000 < per_row < 24_000, per_row
    flops = sum(plan.pass_cost(k)[0] for k in range(10)) + plan.wgrad_cost()[0]
    assert 15 * 2 * 256 * 256 * plan.rows <= flops < 1.02 * 15 * 2 * 256 * 256 * plan.rows
    film = ts.step_plan(True, 100, 8192, 256, 4, 132)
    assert len(film.passes) == 8 and film.n_keep == 3
    assert film.n_img == (8 + 2 * 5) * 256 and film.n_w == 8 + 5 * 256 + 8 * 256 + 8
    # a ragged image: the last CTA walks fewer tiles; every tile lies in one image
    small = ts.step_plan(False, 3, 300, 64, 2, 2)
    assert small.tiles_per_cta * small.chunks * ts.PASS_ROWS >= 300
    assert (small.chunks - 1) * small.tiles_per_cta * ts.PASS_ROWS < 300


@pytest.mark.parametrize("film", [False, True], ids=["cbc", "film"])
def test_plain_passes_write_every_slot_once(film):
    """Each pass writes only its own outputs (pass_outputs), and together
    they fill the whole scratch and every slot: a work space filled with NaN
    has none left after the chain."""
    ops, kw = _pass_operands(film, 3, 300, 64, 3, False, "tanh", seed=24)
    kw["trunk"] = "bfloat16"
    plan = ts.step_plan(film, 3, 300, 64, 3, 2)
    work = ts.PassWork.for_plan(plan, "bfloat16", "cpu", sms=2)
    for t in (work.sc_h, work.sc_keep, work.sc_dz, work.part_img, work.part_w):
        t.fill_(float("nan"))
    for k in range(len(plan.passes)):
        before = work.clone()
        ts.step_pass_reference(plan, k, ops, kw, work)
        outs = ts.pass_outputs(plan, k, work)
        assert all(not torch.isnan(v).any() for v in outs.values()), plan.passes[k]
        for name in ("sc_h", "sc_keep", "sc_dz", "part_img", "part_w"):
            changed = ~torch.eq(getattr(before, name), getattr(work, name)) & ~(
                torch.isnan(getattr(before, name)) & torch.isnan(getattr(work, name)))
            covered = torch.zeros_like(changed)
            for v in outs.values():
                base = getattr(work, name)
                if v.untyped_storage().data_ptr() == base.untyped_storage().data_ptr():
                    mark = torch.zeros_like(base, dtype=torch.bool)
                    mark.as_strided(v.shape, v.stride(), v.storage_offset()).fill_(True)
                    covered |= mark
            assert not (changed & ~covered).any(), (plan.passes[k], name)
    for t in (work.sc_h, work.sc_keep, work.sc_dz, work.part_img, work.part_w):
        assert not torch.isnan(t).any()


@pytest.mark.parametrize(
    "trunk,hidden,n_mm,passes",
    [("bfloat16", 256, 5, True), ("bfloat16", 64, 1, True), ("bfloat16", 192, 3, True),
     ("bfloat16", 96, 2, False), ("bfloat16", 32, 2, False), ("float32", 256, 5, False),
     ("bfloat16", 256, 0, False)],
    ids=["zoo", "narrow", "192", "96", "32", "float32", "film_one_layer"],
)
def test_step_route_rule(trunk, hidden, n_mm, passes):
    """The routing rule: the passes take bf16 widths that are a multiple of
    64 with an H x H product; the chain kernel the float32 trunk, other bf16
    widths and a FiLM trunk of one layer. The shared-memory figure and the
    limit follow the route."""
    assert ts.pass_route(trunk, hidden, n_mm) is passes
    smem = ts.step_smem_bytes(trunk, hidden, n_mm)
    assert smem == (ts.pass_smem_bytes(hidden) if passes
                    else ts.chain_smem_bytes(trunk, hidden, n_mm))
    if passes:
        assert ts.step_smem_bytes(trunk, hidden, n_mm + 20) == smem  # no depth limit
