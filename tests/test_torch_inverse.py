"""The port's FIT_INVERSE (reni_tpu_torch.train.tasks.make_fit_inverse_step,
reni_tpu_torch.render.inverse.fit_inverse) and TaskConfig.from_config held
against the JAX package on the CPU, with the tiny decoder of
tests/test_render.py (latent_dim 4, 1 x 32, render 16).

At float64 both packages render in float64 from the same float32 pixel
geometry and light directions: the port promotes them to the colors' dtype,
and the JAX scene is given them promoted (its shading keeps float32
geometry under x64, whose float32 rounding the specular power 500 would
carry far past 1e-12; tests/test_torch_render.py holds the float32 renders).
"""

import dataclasses
import glob
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.core import sphere as jsph
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.render import inverse as jinv
from reni_tpu.render import mesh as jmesh
from reni_tpu.render import shading as jshading
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu.utils.config import get_cfg_defaults as j_cfg_defaults
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import sphere as tsph
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.render import inverse as tinv
from reni_tpu_torch.render import mesh as tmesh
from reni_tpu_torch.train import optim as toptim
from reni_tpu_torch.train import tasks as ttasks
from reni_tpu_torch.train.checkpoint import _flatten
from reni_tpu_torch.utils.config import get_cfg_defaults as t_cfg_defaults

ROOT = os.path.join(os.path.dirname(__file__), "..")
WIDTH = 16  # 8 x 16 = 128 lights


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tiny(seed=0, S=2, **kw):
    """The decoder of tests/test_render.py::test_fit_inverse_end_to_end (JAX
    init), its fresh latents (mu = 0) and (S, P, 3) target maps."""
    cfg = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
               hidden_layers=1, hidden_features=32, output_activation=None,
               fixed_decoder=True)
    cfg.update(kw)
    jp = jax.device_get(JModel(JConfig(**cfg)).init(jax.random.PRNGKey(seed), dataset_size=S))
    d = np.asarray(jsph.get_directions(WIDTH))[0]
    rng = np.random.default_rng(seed + 1)
    images = np.stack([np.tanh(d @ rng.normal(size=(3, 3))) * 0.5 for _ in range(S)])
    return cfg, jp, images.astype(np.float32)


def _task(**kw):
    cfg = dict(task="FIT_INVERSE", optim=dict(lr_start=5e-2, lr_end=1e-2), batch_size=2,
               epochs=4, multi_res_training=False, final_resolution=(8, 16),
               prior_loss_weight=1e-7, cosine_similarity_weight=1e-3)
    cfg.update(kw)
    return cfg


def _configs(task):
    jt = jtasks.TaskConfig(**dict(task, optim=joptim.OptimConfig(**task["optim"])))
    tt = ttasks.TaskConfig(**dict(task, optim=toptim.OptimConfig(**task["optim"])))
    return jt, tt


def _float64_jax_scene(monkeypatch):
    """The JAX scene's pixel geometry and light directions promoted to
    float64 (their float32 values unchanged)."""
    pixel_geometry = jshading.pixel_geometry
    monkeypatch.setattr(jshading, "pixel_geometry", lambda *a: tuple(
        x.astype(jnp.float64) for x in pixel_geometry(*a)))
    monkeypatch.setattr(jinv, "sphere", types.SimpleNamespace(
        get_directions=lambda w: jsph.get_directions(w).astype(jnp.float64),
        get_sineweight=jsph.get_sineweight))


def _run_both(monkeypatch, task, S=2, views=None, kd=0.5, seed=0):
    cfg, jp, images = _tiny(seed, S)
    jt, tt = _configs(task)
    scene = dict(render_resolution=16, kd=kd, light_chunk=64)
    if views:
        scene.update(azimuths=views[0], elevations=views[1])
    mesh = tmesh.make_uv_sphere(8, 16)
    with jax.enable_x64():
        _float64_jax_scene(monkeypatch)
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        jsetup = jinv.InverseRenderSetup(jmesh.make_uv_sphere(8, 16), **scene)
        jparams, jmet = jinv.fit_inverse(
            JModel(JConfig(**cfg)), jp64, jt, lambda res: jnp.asarray(images, jnp.float64),
            lambda x: x, jax.random.PRNGKey(2), setup=jsetup,
        )
        jparams = jax.tree.map(np.asarray, jparams)
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    tsetup = tinv.InverseRenderSetup(mesh, device="cpu", **scene)
    tparams_out, tmet = tinv.fit_inverse(
        RENIModel(RENIConfig(**cfg)), tp, tt, lambda res: torch.from_numpy(images).double(),
        lambda x: x, torch.Generator().manual_seed(2), setup=tsetup,
    )
    return jp, jparams, jmet, tparams_out, tmet


def _check_metrics(tmet, jmet, epochs):
    assert tmet.keys() == jmet.keys() == {
        "fit_inverse_loss", "fit_inverse_mse_loss", "fit_inverse_prior_loss",
        "fit_inverse_cosine_loss"}
    for k in jmet:
        assert tmet[k].shape == (epochs,)
        np.testing.assert_allclose(tmet[k][0], jmet[k][0], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-6, err_msg=k)


def test_fit_inverse_matches_jax_f64(monkeypatch):
    """fit_inverse, 2 maps in one batch, 4 epochs at float64: epoch 0's four
    metrics to 1e-12 relative, every epoch to 1e-6 and the fitted mu to 1e-6
    (sin(30x) under Adam(b1 = 0) amplifies rounding from step to step, as in
    tests/test_torch_train.py)."""
    jp, jparams, jmet, tout, tmet = _run_both(monkeypatch, _task())
    _check_metrics(tmet, jmet, 4)
    np.testing.assert_allclose(_np(tout["latents"]["mu"]), jparams["latents"]["mu"],
                               rtol=1e-6, atol=1e-9)


def test_fit_inverse_multi_view_matches_jax_f64(monkeypatch):
    """Three views stacked on the height axis, 3 maps in one batch, at the
    same bars (a batch that pads a row is C-5's case, held apart below: JAX
    gives NaN for it on the CPU)."""
    task = _task(batch_size=3, epochs=3)
    jp, jparams, jmet, tout, tmet = _run_both(
        monkeypatch, task, S=3, views=((0.0, 120.0, 240.0), (0.0, 30.0, -30.0)))
    _check_metrics(tmet, jmet, 3)


def test_fit_inverse_step_f64_matches_jax(monkeypatch):
    """make_fit_inverse_step alone: one update's metrics and new mu."""
    cfg, jp, images = _tiny(3, S=2)
    jt, tt = _configs(_task())
    mesh = tmesh.make_uv_sphere(8, 16)
    scene = dict(render_resolution=16, kd=0.5, light_chunk=64)
    idx, bmask = np.array([0, 1]), np.ones(2)
    with jax.enable_x64():
        _float64_jax_scene(monkeypatch)
        jm = JModel(JConfig(**cfg))
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        jp64["latents"]["mu"] = jnp.asarray(np.random.default_rng(4).normal(size=(2, 4, 3)) * .3)
        jsetup = jinv.InverseRenderSetup(jmesh.make_uv_sphere(8, 16), **scene)
        gt = jsetup.generate_gt_renders(jnp.asarray(images, jnp.float64), lambda x: x, WIDTH)
        opt = joptim.build_optimizer(dataclasses.replace(jt.optim, epochs=1, steps_per_epoch=1))
        state = jtasks.init_train_state(jm, jp64, opt, jax.random.PRNGKey(0))
        step = jtasks.make_fit_inverse_step(
            jm, opt, jsph.get_directions(WIDTH), jsph.get_sineweight(WIDTH),
            jsetup.render_fn(WIDTH), lambda x: x, alpha=1e-7, beta=1e-3)
        state, jm_out = step(state, (gt, jnp.asarray(idx), jnp.asarray(bmask)))
        jmu = np.asarray(state.trainable["latents"]["mu"])
        gt = np.asarray(gt)
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp64), "cpu")
    tsetup = tinv.InverseRenderSetup(mesh, device="cpu", **scene)
    # the GT renders to 1e-12 x max |JAX render| (pointwise, a pixel whose
    # specular sum cancels can lose more digits to the power 500)
    tgt = _np(tsetup.generate_gt_renders(torch.from_numpy(images).double(), lambda x: x, WIDTH))
    assert np.abs(tgt - gt).max() <= 1e-12 * np.abs(gt).max()
    tstate = ttasks.init_train_state(
        model, tp, dataclasses.replace(tt.optim, epochs=1, steps_per_epoch=1),
        torch.Generator().manual_seed(0))
    tstep = ttasks.make_fit_inverse_step(
        model, tsph.get_directions(WIDTH, device="cpu"),
        tsph.get_sineweight(WIDTH, device="cpu").double(), tsetup.render_fn(WIDTH),
        lambda x: x, alpha=1e-7, beta=1e-3)
    tstate, tm_out = tstep(tstate, (torch.tensor(gt), torch.from_numpy(idx),
                                    torch.from_numpy(bmask)))
    for k in jm_out:
        np.testing.assert_allclose(_np(tm_out[k]), np.asarray(jm_out[k]), rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(_np(tstate.params["latents"]["mu"]), jmu, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("foreach", [False, True], ids=["single-tensor", "foreach"])
def test_fit_inverse_steps_with_the_capturable_adam_match_jax_f64(monkeypatch, foreach):
    """Five updates of make_fit_inverse_step with Adam's capturable form
    (``ScheduledOptimizer.make_capturable``: the form of FIT_INVERSE's
    graphed step on the card, its step count and bias corrections float32
    tensors, its LR a float32 tensor; ``foreach`` the card's multi-tensor
    kernels) against the JAX step's optax Adam at float64, beta1 0.5 and an
    LR that moves every update: each step's metrics and the new mu to
    1e-6 relative, the bar of the multi-step tests above (the first step's
    metrics, before any update, to 1e-12)."""
    from torch.optim import adam

    devices = adam._get_capturable_supported_devices  # torch allows it only on accelerators
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*devices(*a, **k), "cpu"])
    cfg, jp, images = _tiny(3, S=2)
    jt, tt = _configs(_task(optim=dict(lr_start=5e-2, lr_end=1e-2, beta1=0.5, beta2=0.9,
                                       epochs=5, steps_per_epoch=1)))
    mesh = tmesh.make_uv_sphere(8, 16)
    scene = dict(render_resolution=16, kd=0.5, light_chunk=64)
    idx, bmask = np.array([0, 1]), np.ones(2)
    mu0 = np.random.default_rng(4).normal(size=(2, 4, 3)) * .3
    with jax.enable_x64():
        _float64_jax_scene(monkeypatch)
        jm = JModel(JConfig(**cfg))
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        jp64["latents"]["mu"] = jnp.asarray(mu0)
        jsetup = jinv.InverseRenderSetup(jmesh.make_uv_sphere(8, 16), **scene)
        gt = jsetup.generate_gt_renders(jnp.asarray(images, jnp.float64), lambda x: x, WIDTH)
        opt = joptim.build_optimizer(jt.optim)
        state = jtasks.init_train_state(jm, jp64, opt, jax.random.PRNGKey(0))
        step = jtasks.make_fit_inverse_step(
            jm, opt, jsph.get_directions(WIDTH), jsph.get_sineweight(WIDTH),
            jsetup.render_fn(WIDTH), lambda x: x, alpha=1e-7, beta=1e-3)
        jout = []
        for _ in range(5):
            state, m = step(state, (gt, jnp.asarray(idx), jnp.asarray(bmask)))
            jout.append(({k: float(v) for k, v in m.items()},
                         np.asarray(state.trainable["latents"]["mu"])))
        gt = np.asarray(gt)
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp64), "cpu")
    tsetup = tinv.InverseRenderSetup(mesh, device="cpu", **scene)
    tstate = ttasks.init_train_state(model, tp, tt.optim, torch.Generator().manual_seed(0))
    tstate.optimizer.make_capturable(torch.device("cpu"))
    for group in tstate.optimizer.optimizer.param_groups:
        group["foreach"] = foreach
    tstep = ttasks.make_fit_inverse_step(
        model, tsph.get_directions(WIDTH, device="cpu"),
        tsph.get_sineweight(WIDTH, device="cpu").double(), tsetup.render_fn(WIDTH),
        lambda x: x, alpha=1e-7, beta=1e-3)
    batch = (torch.tensor(gt), torch.from_numpy(idx), torch.from_numpy(bmask))
    for i, (jm_out, jmu) in enumerate(jout):
        tstate, tm_out = tstep.eager(tstate, batch)
        for k in jm_out:
            np.testing.assert_allclose(_np(tm_out[k]), jm_out[k], rtol=1e-12 if i == 0 else 1e-6,
                                       err_msg=f"step {i} {k}")
        # to 1e-6 of the largest |mu| (a near-zero entry carries the float32
        # rounding of the step size, about 2**-24 of the LR)
        gap = np.abs(_np(tstate.params["latents"]["mu"]) - jmu).max()
        assert gap <= 1e-6 * np.abs(jmu).max(), (i, gap)
    st = tstate.optimizer.optimizer.state
    assert tstate.optimizer.capturable and all(
        v["step"].dtype == torch.float32 and v["step"].item() == 5.0 for v in st.values())


def test_fit_inverse_moves_only_mu():
    """Gradients reach mu alone: the decoder and log_var come back
    unchanged, the caller's tree is not updated, and the loss falls
    (tests/test_render.py::test_fit_inverse_end_to_end at 30 epochs)."""
    cfg, jp, images = _tiny(0, S=2)
    tp = tparams.from_numpy(jp, "cpu")
    before = tparams.to_numpy(tp)
    setup = tinv.InverseRenderSetup(tmesh.make_uv_sphere(8, 16), render_resolution=16, kd=0.5,
                                    light_chunk=64, device="cpu")
    _, tt = _configs(_task(epochs=30))
    new, metrics = tinv.fit_inverse(RENIModel(RENIConfig(**cfg)), tp, tt,
                                    lambda res: torch.from_numpy(images), lambda x: x,
                                    torch.Generator().manual_seed(2), setup=setup)
    hist = metrics["fit_inverse_loss"]
    assert hist.shape == (30,) and hist[-1] < hist[0]
    for k, v in _flatten(tparams.to_numpy(new["decoder"])).items():
        np.testing.assert_array_equal(v, _flatten(before["decoder"])[k])
    np.testing.assert_array_equal(_np(new["latents"]["log_var"]), before["latents"]["log_var"])
    assert tp["latents"]["mu"].abs().max() == 0.0
    assert not np.allclose(_np(new["latents"]["mu"]), 0.0)


def test_padded_batch_loss_is_finite_and_unpadded():
    """C-5: a batch with a zero-padded row. XLA on the CPU flushes the
    float32 denormal 1e-20**2 to zero, so JAX's reni_test_loss_inverse_masked
    is 0/0 = NaN for it; the port's cosine of an all-zero row is 0, and the
    padded batch's loss equals the loss of the same maps without the pad, at
    float32 and float64 (to 1e-6 / 1e-12 relative: the sums run over
    different shapes)."""
    from reni_tpu_torch.train import losses as tlosses

    rng = np.random.default_rng(5)
    pred = rng.uniform(0.1, 1.0, size=(3, 6, 5, 3))
    gt = rng.uniform(0.1, 1.0, size=(3, 6, 5, 3))
    Z = rng.normal(size=(3, 4, 3))
    for dtype, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
        bmask = t([1.0, 1.0, 0.0])
        # the trainer zeroes the padded row's latents and sineweight, so its
        # decode renders black
        padded_pred = t(pred) * bmask[:, None, None, None]
        padded = tlosses.reni_test_loss_inverse_masked(
            padded_pred, t(gt) * bmask[:, None, None, None], t(Z) * bmask[:, None, None],
            bmask, alpha=1e-3, beta=0.5)
        plain = tlosses.reni_test_loss_inverse(t(pred[:2]), t(gt[:2]), t(Z[:2]),
                                               alpha=1e-3, beta=0.5)
        for a, b in zip(padded, plain):
            assert torch.isfinite(a)
            np.testing.assert_allclose(a.item(), b.item(), rtol=rtol)
    with jax.default_device(jax.devices("cpu")[0]):
        from reni_tpu.train import losses as jlosses

        j = jlosses.reni_test_loss_inverse_masked(
            jnp.asarray(pred * [[[[1]]], [[[1]]], [[[0]]]], jnp.float32),
            jnp.asarray(gt * [[[[1]]], [[[1]]], [[[0]]]], jnp.float32),
            jnp.asarray(Z, jnp.float32), jnp.asarray([1.0, 1.0, 0.0], jnp.float32),
            alpha=1e-3, beta=0.5)
    # the JAX package's own value on the CPU (ROADMAP C-5), recorded here so
    # that a change of it shows
    assert not np.isfinite(float(j[0]))


def test_fit_task_needs_a_step_builder_for_fit_inverse():
    cfg, jp, images = _tiny(0)
    _, tt = _configs(_task())
    with pytest.raises(ValueError, match="step_builder"):
        ttasks.fit_task(RENIModel(RENIConfig(**cfg)), tparams.from_numpy(jp, "cpu"), tt,
                        lambda res: torch.from_numpy(images), torch.Generator())


ZOO_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "data", "Zoo", "*", "config.yaml")))


@pytest.mark.parametrize("path", ZOO_CONFIGS, ids=lambda p: p.split(os.sep)[-2])
def test_task_config_from_config_matches_jax(path):
    """TaskConfig.from_config on every Zoo entry's config.yaml, each of the
    three tasks, equal to JAX's field for field."""
    jcfg, tcfg = j_cfg_defaults(), t_cfg_defaults()
    jcfg.merge_from_file(path)
    tcfg.merge_from_file(path)
    for task in ("FIT_DECODER", "FIT_LATENT", "FIT_INVERSE"):
        j = jtasks.TaskConfig.from_config(jcfg, task)
        t = ttasks.TaskConfig.from_config(tcfg, task)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        jd["optim"] = dataclasses.asdict(j.optim)
        td["optim"] = dataclasses.asdict(t.optim)
        assert td == jd, task
    assert t.task == "FIT_INVERSE" and t.object_path == "data/3D_Models/teapot.obj"
    assert (t.render_resolution, t.kd_value, t.batch_size) == (64, 1.0, 1)


def test_task_config_from_config_views_and_json(tmp_path):
    """The multi-view keys route into TaskConfig from a JSON config file
    (read without PyYAML)."""
    import json

    tree = {"RENI": {"FIT_INVERSE": {"AZIMUTHS": [0.0, 120.0, 240.0],
                                     "ELEVATIONS": [0.0, 30.0, -30.0], "KD_VALUE": 0.5}}}
    (tmp_path / "c.json").write_text(json.dumps(tree))
    tcfg = t_cfg_defaults()
    tcfg.merge_from_file(str(tmp_path / "c.json"))
    t = ttasks.TaskConfig.from_config(tcfg, "FIT_INVERSE")
    assert t.azimuths == (0.0, 120.0, 240.0) and t.elevations == (0.0, 30.0, -30.0)
    assert t.kd_value == 0.5
