"""The port's FIT_LATENT and FIT_DECODER slices held against the JAX package
on the CPU: losses, the optimizers and their schedule, in-painting masks,
latent tables, the steps and the task loop (fit_task) at float64 and at float32
through the fused paths, and checkpoints that the JAX package reads back."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from reni_tpu.core import sphere as jsph
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.models.reni import replace_latents as j_replace_latents
from reni_tpu.train import checkpoint as jck
from reni_tpu.train import losses as jlosses
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import sphere as tsph
from reni_tpu_torch.models.reni import RENIConfig, RENIModel, replace_latents
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import losses as tlosses
from reni_tpu_torch.train import optim as toptim
from reni_tpu_torch.train import tasks as ttasks

ROOT = os.path.join(os.path.dirname(__file__), "..")
MASKS = ["Mask-1", "Mask-2", "Mask-3", "Mask-Left", "Mask-Right"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed=0, B=3, P=40):
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(B, P, 3)).astype(np.float32)
    gt = rng.normal(size=(B, P, 3)).astype(np.float32)
    sw = rng.uniform(0.1, 1.0, size=(1, P, 3)).astype(np.float32)
    sw = np.broadcast_to(sw, (B, P, 3)).copy()
    Z = rng.normal(size=(B, 5, 3)).astype(np.float32)
    mu, lv = rng.normal(size=(2, B, 5, 3)).astype(np.float32)
    bmask = np.array([1.0, 1.0, 0.0], np.float32)
    return out, gt, sw, Z, mu, lv, bmask


@pytest.mark.parametrize(
    "name",
    ["weighted_mse", "kld", "weighted_cosine_similarity", "cosine_similarity",
     "reni_vad_train_loss", "reni_test_loss", "reni_test_loss_inverse",
     "reni_test_loss_masked", "reni_test_loss_inverse_masked", "psnr"],
)
def test_loss_matches_jax(name):
    out, gt, sw, Z, mu, lv, bmask = _loss_inputs()
    kw = dict(alpha=1e-3, beta=0.5)
    imgs = (out.reshape(3, 5, 8, 3), gt.reshape(3, 5, 8, 3))
    calls = {
        "weighted_mse": ((out, gt, sw), {}),
        "kld": ((mu, lv, 15), {}),
        "weighted_cosine_similarity": ((out, gt, sw), {}),
        "cosine_similarity": ((out, gt), {}),
        "reni_vad_train_loss": ((out, gt, sw, mu, lv), dict(beta=1e-4, z_dims=15)),
        "reni_test_loss": ((out, gt, sw, Z), kw),
        "reni_test_loss_inverse": ((*imgs, Z), kw),
        "reni_test_loss_masked": ((out, gt, sw * bmask[:, None, None], Z, bmask), kw),
        # an all-ones mask: a zero-masked render row makes 0/0 in JAX on the
        # CPU (XLA flushes the float32 denormal 1e-20**2 to zero), where the
        # port's cosine is 0 (ROADMAP.md Queue C)
        "reni_test_loss_inverse_masked": ((*imgs, Z, np.ones(3, np.float32)), kw),
        "psnr": ((np.tanh(out), np.tanh(gt)), {}),
    }
    args, kwargs = calls[name]
    ref = getattr(jlosses, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                   for a in args), **kwargs)
    got = getattr(tlosses, name)(*(_t(a) if isinstance(a, np.ndarray) else a
                                   for a in args), **kwargs)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), _np(r), rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sched", [dict(), dict(scheduler_type="step", scheduler_step_size=2, scheduler_gamma=0.5),
              dict(scheduler_type="none")],
    ids=["exponential", "step", "constant"],
)
def test_schedule_matches_optax(sched):
    """The LR at every step of 3 epochs x 4 steps (staircase per epoch), bit
    for bit: optax's values are float32 and the port's follow them."""
    cfg = dict(lr_start=1e-2, lr_end=1e-4, epochs=3, steps_per_epoch=4, **sched)
    jsched = joptim.build_schedule(joptim.OptimConfig(**cfg))
    tsched = toptim.build_schedule(toptim.OptimConfig(**cfg))
    for t in range(3 * 4 + 1):
        assert tsched(t) == float(jsched(jnp.asarray(t, jnp.int32))), t


@pytest.mark.parametrize(
    "opt", [dict(optimizer="adam", beta1=0.0, beta2=0.9), dict(optimizer="adam", beta1=0.5),
            dict(optimizer="sgd"), dict(optimizer="sgd", beta1=0.9), dict(optimizer="adagrad")],
    ids=["adam", "adam_b1", "sgd", "sgd_momentum", "adagrad"],
)
def test_optimizer_updates_match_optax_f64(opt):
    """Five updates at float64 with a decaying LR, to 1e-12."""
    cfg = dict(lr_start=1e-2, lr_end=1e-3, epochs=5, steps_per_epoch=1, **opt)
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 3))
    grads = rng.normal(size=(5, 4, 3))
    with jax.enable_x64():
        jopt = joptim.build_optimizer(joptim.OptimConfig(**cfg))
        jp = {"w": jnp.asarray(p0)}
        state = jopt.init(jp)
        jtraj = []
        for g in grads:
            upd, state = jopt.update({"w": jnp.asarray(g)}, state, jp)
            jp = optax.apply_updates(jp, upd)
            jtraj.append(np.asarray(jp["w"]))
    tp = torch.tensor(p0, requires_grad=True)
    topt = toptim.build_optimizer(toptim.OptimConfig(**cfg), [tp])
    for g, ref in zip(grads, jtraj):
        tp.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(_np(tp), ref, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# masks and latent tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", MASKS)
def test_get_mask_matches_jax(mask):
    path = os.path.join(ROOT, "data", "Masks", f"{mask}.png")
    for width in (32, 64, 128, 256):
        ref = np.asarray(jsph.get_mask(width, path))
        got = _np(tsph.get_mask(width, path, device="cpu"))
        assert got.dtype == ref.dtype and got.shape == ref.shape == (1, width * width // 2, 3)
        np.testing.assert_array_equal(got, ref)


def _model(fixed=False, **kw):
    cfg = dict(latent_dim=5, hidden_layers=2, hidden_features=32, fixed_decoder=fixed)
    cfg.update(kw)
    return RENIModel(RENIConfig(**cfg))


def test_fixed_decoder_latents_zero_and_mask():
    model = _model(fixed=True)
    lat = model.init_latents(torch.Generator().manual_seed(6), 7, device="cpu")
    assert lat["mu"].shape == (7, 5, 3) and lat["mu"].abs().max() == 0.0
    assert abs(lat["log_var"].mean().item() + 5.0) < 0.5
    params = {"decoder": {"layers": [{"w": 0, "b": 0}], "final": {"w": 0, "b": 0}},
              "latents": lat}
    mask = model.trainable_mask(params)
    assert mask["latents"] == {"mu": True, "log_var": False}
    assert not any(tck._flatten(mask["decoder"]).values())
    ad = _model(fixed=True, model_type="AutoDecoder")
    assert ad.trainable_mask({"latents": {"Z": 0}}) == {"latents": {"Z": True}}
    free = _model()
    assert all(tck._flatten(free.trainable_mask(params)).values())
    z = free.init_latents(torch.Generator().manual_seed(6), 7, device="cpu")["mu"]
    assert 0.5 < z.std().item() < 1.5


def test_init_latents_follows_generator():
    model = _model(model_type="AutoDecoder")
    a = model.init_latents(torch.Generator().manual_seed(3), 4, device="cpu")["Z"]
    b = model.init_latents(torch.Generator().manual_seed(3), 4, device="cpu")["Z"]
    c = model.init_latents(torch.Generator().manual_seed(4), 4, device="cpu")["Z"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_apply_idx_fixed_uses_mu():
    model = _model(fixed=True, output_activation="tanh")
    jm = JModel(JConfig(**dataclasses.asdict(model.config)))
    jp = jm.init(jax.random.PRNGKey(7), dataset_size=4)
    tp = tparams.from_numpy(jax.device_get(jp), "cpu")
    tp["latents"]["mu"] = torch.randn(4, 5, 3)
    D = tsph.get_directions(8, device="cpu")
    out1 = model.apply_idx(tp, [0, 1], D)
    out2 = model.apply(tp, tp["latents"]["mu"][[0, 1]], D)
    assert torch.equal(out1, out2)


def test_replace_latents_keeps_decoder():
    jm = JModel(JConfig(latent_dim=5, hidden_layers=2, hidden_features=32))
    jp = jm.init(jax.random.PRNGKey(8), dataset_size=4)
    tp = tparams.from_numpy(jax.device_get(jp), "cpu")
    new = replace_latents(_model(fixed=True), tp, torch.Generator().manual_seed(9), 11,
                          device="cpu")
    jnew = j_replace_latents(JModel(JConfig(latent_dim=5, hidden_layers=2, hidden_features=32,
                                            fixed_decoder=True)),
                             jp, jax.random.PRNGKey(9), dataset_size=11)
    assert new["latents"]["mu"].shape == tuple(jnew["latents"]["mu"].shape) == (11, 5, 3)
    assert new["latents"]["mu"].abs().max() == 0.0
    assert new["decoder"] is tp["decoder"]


# ---------------------------------------------------------------------------
# the task driver
# ---------------------------------------------------------------------------


def _targets(width, n, seed, dtype=np.float64):
    """Smooth band-limited maps in [-1, 1], (n, H*W, 3), from the float32
    direction grid (as fit_task builds it)."""
    d = np.asarray(jsph.get_directions(width))[0].astype(np.float64)
    rng = np.random.default_rng(seed)
    return np.stack([np.tanh(d @ rng.normal(size=(3, 3))) for _ in range(n)]).astype(dtype)


def _tiny_vad(seed, **kw):
    cfg = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
               hidden_layers=2, hidden_features=16, output_activation="tanh",
               fixed_decoder=True)
    cfg.update(kw)
    jm = JModel(JConfig(**cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(seed), dataset_size=5))
    rng = np.random.default_rng(seed)
    jp["latents"]["mu"] = 0.3 * rng.normal(size=jp["latents"]["mu"].shape).astype(np.float32)
    return cfg, jm, jp


def _latent_task(**kw):
    cfg = dict(task="FIT_LATENT",
               optim=joptim.OptimConfig(lr_start=1e-2, lr_end=1e-4, beta1=0.0, beta2=0.9),
               batch_size=2, epochs=6, multi_res_training=True, initial_resolution=(4, 8),
               final_resolution=(8, 16), curriculum=(3,), cosine_similarity_weight=1e-4,
               prior_loss_weight=1e-7)
    cfg.update(kw)
    return cfg


def test_fit_task_matches_jax_f64():
    """FIT_LATENT, 5 maps in batches of 2 (a ragged last batch), a 2-stage
    curriculum, at float64 on both sides with the plain decoder: epoch 0's
    four metrics to 1e-12 relative, every epoch to 1e-6, the final mu to
    1e-6 (sin(30x) under Adam(b1 = 0) amplifies rounding differences from
    step to step)."""
    cfg, jm, jp = _tiny_vad(11)
    task = _latent_task()
    imgs = {(4, 8): _targets(8, 5, 12), (8, 16): _targets(16, 5, 13)}
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        jparams, jmet = jtasks.fit_task(
            jm, jp64, jtasks.TaskConfig(**task), lambda res: jnp.asarray(imgs[res]),
            jax.random.PRNGKey(0),
        )
        jmu = np.asarray(jparams["latents"]["mu"])
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    ttask = dict(task, optim=toptim.OptimConfig(**dataclasses.asdict(task["optim"])))
    tparams_out, tmet = ttasks.fit_task(
        RENIModel(RENIConfig(**cfg)), tp, ttasks.TaskConfig(**ttask),
        lambda res: torch.from_numpy(imgs[res]), torch.Generator().manual_seed(0),
    )
    assert tmet.keys() == jmet.keys() == {
        "fit_latent_loss", "fit_latent_mse_loss", "fit_latent_prior_loss",
        "fit_latent_cosine_loss"}
    for k in jmet:
        assert tmet[k].shape == (6,)
        np.testing.assert_allclose(tmet[k][0], jmet[k][0], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(tparams_out["latents"]["mu"]), jmu, rtol=1e-6, atol=1e-9)
    # the decoder and log_var are frozen and come back unchanged
    np.testing.assert_array_equal(_np(tparams_out["latents"]["log_var"]),
                                  np.asarray(jp["latents"]["log_var"], np.float64))


def test_fit_latent_step_fused_f32_matches_jax():
    """At float32 through the fused path (JAX: Pallas in interpret mode;
    port: the plain forward and backward Functions), the first step's loss
    and d loss / d mu agree to 5e-5."""
    cfg, jm, jp = _tiny_vad(14, hidden_features=128, use_pallas=True, pallas_trunk="float32")
    jm = JModel(JConfig(**cfg))
    width = 16  # 8 x 16 = 128 pixels: the Pallas kernel's tile rules hold
    D, SW = jsph.get_directions(width), jsph.get_sineweight(width)
    imgs = _targets(width, 5, 15, np.float32)[:3]
    idx, bmask = np.array([0, 1, 2]), np.array([1.0, 1.0, 0.0], np.float32)
    sw = SW * bmask[:, None, None]

    def jloss(mu):
        params = {"decoder": jp["decoder"], "latents": {"mu": mu, "log_var": jp["latents"]["log_var"]}}
        Z = mu[idx] * bmask[:, None, None]
        out = jm.apply(params, Z, D)
        return jlosses.reni_test_loss_masked(out, imgs, sw, Z, bmask, alpha=1e-7, beta=1e-4)[0]

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(jp["latents"]["mu"]))
    tp = tparams.from_numpy(jp, "cpu")
    mu = tp["latents"]["mu"].requires_grad_()
    Z = mu[torch.from_numpy(idx)] * _t(bmask)[:, None, None]
    out = RENIModel(RENIConfig(**cfg)).apply(tp, Z, _t(D))
    tl = tlosses.reni_test_loss_masked(out, _t(imgs), _t(sw), Z, _t(bmask),
                                       alpha=1e-7, beta=1e-4)[0]
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=5e-5)
    np.testing.assert_allclose(_np(mu.grad), np.asarray(jg), rtol=5e-5, atol=1e-7)


def test_fit_latent_only_updates_mu():
    cfg, jm, jp = _tiny_vad(4, latent_dim=5, hidden_layers=1, hidden_features=32,
                            output_activation=None)
    tp = tparams.from_numpy(jp, "cpu")
    tp["latents"]["mu"].zero_()
    images = torch.from_numpy(_targets(16, 2, 7, np.float32))
    task = ttasks.TaskConfig(
        task="FIT_LATENT", optim=toptim.OptimConfig(lr_start=1e-1, lr_end=1e-2),
        batch_size=2, epochs=60, multi_res_training=False, final_resolution=(8, 16),
        prior_loss_weight=1e-7, cosine_similarity_weight=1e-4,
    )
    before = tparams.to_numpy(tp)
    new, metrics = ttasks.fit_task(RENIModel(RENIConfig(**cfg)), tp, task,
                                   lambda res: images[:2], torch.Generator().manual_seed(5))
    # decoder and log_var untouched, and so is the caller's tree
    for k, v in tck._flatten(tparams.to_numpy(new["decoder"])).items():
        np.testing.assert_array_equal(v, tck._flatten(before["decoder"])[k])
    np.testing.assert_array_equal(_np(new["latents"]["log_var"]), before["latents"]["log_var"])
    assert tp["latents"]["mu"].abs().max() == 0.0
    assert not np.allclose(_np(new["latents"]["mu"][:2]), 0.0)
    hist = metrics["fit_latent_loss"]
    assert hist.shape == (60,) and hist[-1] < hist[0]


def test_fit_latent_masked_region_ignored():
    """A zeroed sineweight region gives no gradient signal: training with a
    mask matches training on targets corrupted inside the mask."""
    model = RENIModel(RENIConfig(model_type="AutoDecoder", equivariance="SO2", latent_dim=4,
                                 hidden_layers=1, hidden_features=16, output_activation=None,
                                 fixed_decoder=True))
    jm = JModel(JConfig(**dataclasses.asdict(model.config)))
    params = tparams.from_numpy(jax.device_get(jm.init(jax.random.PRNGKey(6), dataset_size=1)),
                                "cpu")
    width = 16
    images = torch.from_numpy(_targets(width, 1, 9, np.float32))
    garbage = images.clone()
    garbage[:, :40, :] = 99.0
    sw = tsph.get_sineweight(width, device="cpu")
    mask = torch.ones_like(sw)
    mask[:, :40, :] = 0.0
    d = tsph.get_directions(width, device="cpu")
    cfg = toptim.OptimConfig(lr_start=1e-1, lr_end=1e-1, epochs=10, steps_per_epoch=1)

    def run(target):
        step = ttasks.make_fit_latent_step(model, d, sw * mask, alpha=0.0, beta=0.0)
        state = ttasks.init_train_state(model, params, cfg, torch.Generator().manual_seed(7))
        batch = (target, torch.tensor([0]), torch.tensor([1.0]))
        for _ in range(5):
            state, _ = step(state, batch)
        return _np(state.params["latents"]["Z"])

    np.testing.assert_allclose(run(images), run(garbage), atol=1e-6)


@pytest.mark.parametrize("name, value", [
    ("mesh", object()), ("shard_latents", True), ("stream", True), ("stream_chunk", 2),
    ("stream_dtype", "bfloat16"), ("precompile", True)])
def test_fit_task_rejects_later_slices(name, value):
    """The arguments of slices still to come (ROADMAP Queue A-9, A-11, A-13)
    raise, naming the queue item; the callbacks, resume and re-staging of
    A-4 are held in tests/test_torch_resume.py."""
    assert sorted(ttasks._LATER) == sorted(
        ["mesh", "shard_latents", "stream", "stream_chunk", "stream_dtype", "precompile"])
    cfg, jm, jp = _tiny_vad(3)
    tp = tparams.from_numpy(jp, "cpu")
    task = ttasks.TaskConfig(**dict(_latent_task(), optim=toptim.OptimConfig()))
    model = RENIModel(RENIConfig(**cfg))
    with pytest.raises(NotImplementedError, match=r"Queue A-(9|11|13)"):
        ttasks.fit_task(model, tp, task, lambda res: None, torch.Generator(), **{name: value})


def test_fit_task_needs_a_step_builder_for_fit_inverse():
    """FIT_INVERSE runs (render/inverse.py::fit_inverse passes the step
    builder); without a step builder it raises as JAX's fit_task does."""
    cfg, jm, jp = _tiny_vad(3)
    tp = tparams.from_numpy(jp, "cpu")
    task = ttasks.TaskConfig(**dict(_latent_task(), optim=toptim.OptimConfig()))
    model = RENIModel(RENIConfig(**cfg))
    with pytest.raises(ValueError, match="FIT_INVERSE"):
        ttasks.fit_task(model, tp, dataclasses.replace(task, task="FIT_INVERSE"),
                        lambda res: None, torch.Generator())


def test_make_batches_and_stages_match_jax():
    for n, b in ((6, 3), (7, 3), (21, 21), (5, 2)):
        for x, y in zip(ttasks.make_batches(n, b), jtasks.make_batches(n, b)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    for kw in (dict(), dict(curriculum=()), dict(multi_res_training=False),
               dict(epochs=300, curriculum=(100, 200))):
        t = ttasks.TaskConfig(**kw)
        j = jtasks.TaskConfig(**kw)
        assert t.resolution_stages() == j.resolution_stages()
        assert t.effective_curriculum() == j.effective_curriculum()


def test_fit_latent_checkpoint_loads_in_jax(tmp_path):
    """A port-written FIT_LATENT result loads in JAX load_checkpoint, and JAX
    RENIModel.apply of it matches the port's decode."""
    cfg, jm, jp = _tiny_vad(16)
    model = RENIModel(RENIConfig(**cfg))
    path = str(tmp_path / "fit_latent_final")
    tp = tparams.from_numpy(jp, "cpu")
    images = torch.from_numpy(_targets(8, 5, 17, np.float32))
    task = ttasks.TaskConfig(**dict(_latent_task(epochs=2, multi_res_training=False,
                                                 final_resolution=(4, 8)),
                                    optim=toptim.OptimConfig(lr_start=1e-2, lr_end=1e-3)))
    new, metrics = ttasks.fit_task(model, tp, task, lambda res: images,
                                   torch.Generator().manual_seed(1))
    tck.save_fit_result(path, new, model_config=model.config, task="FIT_LATENT",
                        metrics=metrics)
    jparams, meta = jck.load_checkpoint(path)
    assert meta["task"] == "FIT_LATENT" and meta["epoch"] == 2
    assert meta["loss"] == pytest.approx(float(metrics["fit_latent_loss"][-1]))
    assert JConfig(**meta["model_config"]) == JConfig(**cfg)
    D = tsph.get_directions(8, device="cpu")
    ref = jm.apply(jparams, jparams["latents"]["mu"], jnp.asarray(_np(D)))
    out = model.apply(new, new["latents"]["mu"], D)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


def test_load_decoder_only_zoo_entry():
    entry = os.path.join(ROOT, "data", "Zoo", "latent_dim_49_net_5_256_vad_cbc_tanh_hdr")
    ckpt = os.path.join(entry, "checkpoint")
    cfg = tck.load_model_config(ckpt, fixed_decoder=True)
    model = RENIModel(cfg)
    params = tck.load_decoder_only(ckpt, model, 21, torch.Generator().manual_seed(0),
                                   device="cpu")
    jparams = jck.load_decoder_only(ckpt, JModel(JConfig(**dataclasses.asdict(cfg))), 21,
                                    jax.random.PRNGKey(0))
    for k, v in tck._flatten(jax.device_get(jparams["decoder"])).items():
        np.testing.assert_array_equal(tck._flatten(tparams.to_numpy(params["decoder"]))[k], v)
    assert params["latents"]["mu"].shape == (21, 49, 3)
    assert params["latents"]["mu"].abs().max() == 0.0


# ---------------------------------------------------------------------------
# FIT_DECODER
# ---------------------------------------------------------------------------

MODEL_TYPES = ["VariationalAutoDecoder", "AutoDecoder"]


def _tiny_trainable(seed, model_type, **kw):
    """A JAX-initialised model whose decoder trains (fixed_decoder False)."""
    cfg = dict(model_type=model_type, equivariance="SO2", latent_dim=4, hidden_layers=2,
               hidden_features=16, output_activation="tanh")
    cfg.update(kw)
    jm = JModel(JConfig(**cfg))
    return cfg, jm, jax.device_get(jm.init(jax.random.PRNGKey(seed), dataset_size=5))


def _jax_noise(key, shape, dtype):
    """(next key, the noise) of one JAX FIT_DECODER step from ``key``: the
    step splits its key and samples from the second half."""
    key, sample_key = jax.random.split(key)
    return key, np.asarray(jax.random.normal(sample_key, shape, dtype))


def _flat(tree):
    return tck._flatten(tparams.to_numpy(tree) if isinstance(tree, dict) else tree)


FILM = dict(conditioning="FiLM", mapping_layers=2, mapping_features=16)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_decoder_step_matches_jax_f64(model_type):
    _check_fit_decoder_step_f64(model_type)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_decoder_step_film_matches_jax_f64(model_type):
    """The same for a FiLM decoder: the mapping network, the trunk and the
    latents train as in JAX."""
    _check_fit_decoder_step_f64(model_type, **FILM)


def _check_fit_decoder_step_f64(model_type, **model_kw):
    """One FIT_DECODER step and then eight at float64 against JAX
    make_fit_decoder_step, a batch of 4 whose last row is a masked pad, the
    latent noise JAX drew fed in: step 0's metrics to 1e-12 relative; every
    step's metrics and the trained leaves after eight steps to 1e-6
    (sin(30x) under Adam(b1 = 0) amplifies rounding differences from step
    to step)."""
    cfg, jm, jp = _tiny_trainable(21, model_type, **model_kw)
    width = 8
    imgs = _targets(width, 5, 22)[[0, 1, 2, 0]]
    idx, bmask = np.array([0, 1, 2, 0], np.int32), np.array([1.0, 1.0, 1.0, 0.0])
    optim = dict(lr_start=1e-4, lr_end=1e-5, beta1=0.0, beta2=0.9, epochs=8, steps_per_epoch=1)
    noises, jmets = [], []
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        jopt = joptim.build_optimizer(joptim.OptimConfig(**optim))
        jstep = jax.jit(jtasks.make_fit_decoder_step(
            jm, jopt, jsph.get_directions(width), jsph.get_sineweight(width), kld_weighting=1e-4))
        state = jtasks.init_train_state(jm, jp64, jopt, jax.random.PRNGKey(1))
        batch = (jnp.asarray(imgs), jnp.asarray(idx), jnp.asarray(bmask))
        for _ in range(8):
            noises.append(_jax_noise(state.key, (4, 4, 3), jnp.float64)[1])
            state, m = jstep(state, batch)
            jmets.append({k: float(v) for k, v in m.items()})
        jfinal = _flat(jax.device_get(state.trainable))
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    feed = iter(noises)
    tstep = ttasks.make_fit_decoder_step(
        model, tsph.get_directions(width, device="cpu"),
        tsph.get_sineweight(width, device="cpu").double(), kld_weighting=1e-4,
        latent_noise=lambda shape: torch.tensor(next(feed)))
    tstate = ttasks.init_train_state(model, tp, toptim.OptimConfig(**optim),
                                     torch.Generator().manual_seed(1))
    tbatch = (torch.from_numpy(imgs), torch.from_numpy(idx).long(), torch.from_numpy(bmask))
    keys = {"loss", "mse_loss", "kld_loss"} if model_type == MODEL_TYPES[0] else {"loss"}
    for i in range(8):
        tstate, m = tstep(tstate, tbatch)
        assert m.keys() == jmets[i].keys() == keys
        for k in m:
            np.testing.assert_allclose(m[k].item(), jmets[i][k], rtol=1e-12 if i == 0 else 1e-6,
                                       err_msg=f"step {i} {k}")
    tfinal = _flat(tstate.trainable)
    assert tfinal.keys() == jfinal.keys()
    for k in jfinal:
        np.testing.assert_allclose(tfinal[k], jfinal[k], rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_decoder_step_fused_matches_apply_path(model_type):
    _check_fused_matches_apply_path(model_type)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_decoder_step_fused_film_matches_apply_path(model_type):
    """The same on a FiLM model, which dispatches to the FiLM train step (the
    port's twin of test_fit_decoder_step_fused_film_matches_xla_path)."""
    _check_fused_matches_apply_path(model_type, **FILM)


def _check_fused_matches_apply_path(model_type, **model_kw):
    """make_fit_decoder_step gives the same losses and updated leaves whether
    the train-step route serves the MSE (use_pallas; on the CPU its plain
    version) or RENIModel.apply and autograd do, with a masked pad row: metrics
    rtol 5e-5, leaves rtol 2e-4, atol 1e-6 (the bars of
    test_fit_decoder_step_fused_matches_xla_path)."""
    cfg, jm, jp = _tiny_trainable(23, model_type, latent_dim=5, hidden_features=32,
                                  use_pallas=True, pallas_trunk="float32", **model_kw)
    width = 32
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.normal(size=(4, width * width // 2, 3)).astype(np.float32)),
             torch.tensor([0, 1, 2, 0]), torch.tensor([1.0, 1.0, 1.0, 0.0]))
    optim = toptim.OptimConfig(lr_start=1e-4, lr_end=1e-5, epochs=4, steps_per_epoch=1)
    out = []
    for use_pallas in (True, False):
        model = RENIModel(RENIConfig(**dict(cfg, use_pallas=use_pallas)))
        assert (model.fused_step_reason(4, width * width // 2) is None) == use_pallas
        step = ttasks.make_fit_decoder_step(
            model, tsph.get_directions(width, device="cpu"),
            tsph.get_sineweight(width, device="cpu"), kld_weighting=1e-4)
        state = ttasks.init_train_state(model, tparams.from_numpy(jp, "cpu"), optim,
                                        torch.Generator().manual_seed(1))
        state, m = step(state, batch)
        out.append((m, _flat(state.trainable)))
    (mf, pf), (mx, px) = out
    for k in mx:
        np.testing.assert_allclose(mf[k].item(), mx[k].item(), rtol=5e-5, err_msg=k)
    for k in px:
        np.testing.assert_allclose(pf[k], px[k], rtol=2e-4, atol=1e-6, err_msg=k)
        assert not np.array_equal(px[k], _flat(jp)[k]), k  # every leaf trains


def _decoder_task(**kw):
    cfg = dict(task="FIT_DECODER",
               optim=joptim.OptimConfig(lr_start=1e-4, lr_end=1e-6, beta1=0.0, beta2=0.9),
               batch_size=2, epochs=4, multi_res_training=True, initial_resolution=(4, 8),
               final_resolution=(8, 16), curriculum=(2,), kld_weighting=1e-4)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_task_fit_decoder_matches_jax_f64(model_type, tmp_path):
    _check_fit_task_fit_decoder_f64(model_type, tmp_path)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_fit_task_fit_decoder_film_matches_jax_f64(model_type, tmp_path):
    """The same for a FiLM decoder."""
    _check_fit_task_fit_decoder_f64(model_type, tmp_path, **FILM)


def _check_fit_task_fit_decoder_f64(model_type, tmp_path, **model_kw):
    """fit_task FIT_DECODER, 5 maps in batches of 2 (a ragged last batch), a
    2-stage curriculum, float64 on both sides with the plain decoder and the
    latent noise JAX drew fed in: epoch 0's metrics to 1e-12 relative, every
    epoch and the trained leaves to 1e-6. The result, saved by the port,
    loads into the JAX package and decodes to the same map (atol 1e-5, the
    serving bar)."""
    cfg, jm, jp = _tiny_trainable(25, model_type, **model_kw)
    task = _decoder_task()
    imgs = {(4, 8): _targets(8, 5, 26), (8, 16): _targets(16, 5, 27)}
    noises = []
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        key = jax.random.PRNGKey(0)
        for _ in range(4 * 3):
            key, eps = _jax_noise(key, (2, 4, 3), jnp.float64)
            noises.append(eps)
        jparams, jmet = jtasks.fit_task(
            jm, jp64, jtasks.TaskConfig(**task), lambda res: jnp.asarray(imgs[res]),
            jax.random.PRNGKey(0))
        jfinal = _flat(jax.device_get(jparams))
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    feed = iter(noises)
    ttask = ttasks.TaskConfig(**dict(task, optim=toptim.OptimConfig(
        **dataclasses.asdict(task["optim"]))))
    new, tmet = ttasks.fit_task(
        model, tp, ttask, lambda res: torch.from_numpy(imgs[res]),
        torch.Generator().manual_seed(0),
        latent_noise=lambda shape: torch.tensor(next(feed)))
    names = ("loss", "mse_loss", "kld_loss") if model_type == MODEL_TYPES[0] else ("loss",)
    assert tmet.keys() == jmet.keys() == {f"fit_decoder_{n}" for n in names}
    for k in jmet:
        assert tmet[k].shape == (4,)
        np.testing.assert_allclose(tmet[k][0], jmet[k][0], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-6, err_msg=k)
    tfinal = _flat(new)
    assert tfinal.keys() == jfinal.keys()
    for k in jfinal:
        np.testing.assert_allclose(tfinal[k], jfinal[k], rtol=1e-6, atol=1e-9, err_msg=k)
    # the caller's tree is not trained in place
    np.testing.assert_array_equal(_flat(tp)["decoder/final/w"],
                                  np.asarray(jp["decoder"]["final"]["w"], np.float64))

    path = str(tmp_path / "fit_decoder_final")
    tck.save_fit_result(path, new, model_config=model.config, task="FIT_DECODER", metrics=tmet)
    jloaded, meta = jck.load_checkpoint(path)
    assert meta["task"] == "FIT_DECODER" and meta["epoch"] == 4
    assert JConfig(**meta["model_config"]) == JConfig(**cfg)
    table = "mu" if model_type == MODEL_TYPES[0] else "Z"
    D = tsph.get_directions(16, device="cpu")
    with jax.enable_x64():
        ref = np.asarray(jm.apply(jloaded, jnp.asarray(jloaded["latents"][table]),
                                  jnp.asarray(_np(D))))
    out = model.apply(new, new["latents"][table], D)
    np.testing.assert_allclose(_np(out), ref, atol=1e-5)
    back, _ = tck.load_checkpoint(path)
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, tfinal[k])


def test_fit_task_fit_decoder_trains_through_the_step_route():
    _check_trains_through_the_step_route()


def test_fit_task_fit_decoder_film_trains_through_the_step_route():
    """The same for a FiLM model (the FiLM train step's plain version on the
    CPU): the mapping network trains too."""
    from reni_tpu_torch.kernels import siren_step as ts

    calls = []
    plain = ts.StepMSE.steps[True]
    ts.StepMSE.steps[True] = (lambda *a, **k: calls.append(1) or plain[0](*a, **k), plain[1])
    try:
        _check_trains_through_the_step_route(**FILM)
    finally:
        ts.StepMSE.steps[True] = plain
    assert len(calls) == 2 * 12 * 3  # two runs x 12 epochs x 3 batches, one call per step


def _check_trains_through_the_step_route(**model_kw):
    """float32, use_pallas (on the CPU the step's plain version), the noise
    from the task's generator: the loss falls, every leaf of the decoder and
    the latent rows move, and two runs from the same seeds agree bit for bit."""
    cfg, jm, jp = _tiny_trainable(28, "VariationalAutoDecoder", hidden_features=32,
                                  use_pallas=True, pallas_trunk="float32", **model_kw)
    model = RENIModel(RENIConfig(**cfg))
    images = {(4, 8): torch.from_numpy(_targets(8, 5, 29, np.float32)),
              (8, 16): torch.from_numpy(_targets(16, 5, 30, np.float32))}
    task = ttasks.TaskConfig(**dict(_decoder_task(epochs=12, curriculum=(6,)),
                                    optim=toptim.OptimConfig(lr_start=1e-3, lr_end=1e-4)))

    def run():
        return ttasks.fit_task(model, tparams.from_numpy(jp, "cpu"), task,
                               lambda res: images[res], torch.Generator().manual_seed(2))

    (new, met), (again, _) = run(), run()
    loss = met["fit_decoder_loss"]
    assert loss.shape == (12,) and loss[5] < loss[0] and loss[-1] < loss[6]
    for k, v in _flat(new).items():
        np.testing.assert_array_equal(v, _flat(again)[k])
        assert not np.array_equal(v, _flat(jp)[k]), k
