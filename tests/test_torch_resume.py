"""Exact resume in the port (``reni_tpu_torch/train/tasks.py::fit_task`` with
``start_epoch`` / ``initial_opt_state``, ``train/checkpoint.py``) and the
trainer's helpers, held against themselves and against the JAX package on
the CPU: a cut and resumed run is bit for bit the uncut run; checkpoints with
optimizer state pass between the packages both ways and continue at float64;
the callback schedule, best-2 retention, ``RENIConfig.from_reni_cfg``,
``make_grid``, the PNG writer and ``example_images`` match JAX's."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reni_tpu.cli import run as jrun
from reni_tpu.core import sphere as jsph
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import checkpoint as jck
from reni_tpu.train import logging_utils as jlog
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu.train import visualize as jvis
from reni_tpu.utils.config import get_cfg_defaults as jdefaults
from reni_tpu_torch import params as tparams
from reni_tpu_torch.cli import run as trun
from reni_tpu_torch.core import sphere as tsph
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import logging_utils as tlog
from reni_tpu_torch.train import optim as toptim
from reni_tpu_torch.train import tasks as ttasks
from reni_tpu_torch.train import visualize as tvis
from reni_tpu_torch.utils.config import get_cfg_defaults as tdefaults

FILM = dict(conditioning="FiLM", mapping_layers=2, mapping_features=16)
RES = ((4, 8), (8, 16))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _targets(width, n, seed, dtype=np.float64):
    """Smooth maps in [-1, 1], (n, H*W, 3), from the float32 direction grid."""
    d = np.asarray(jsph.get_directions(width))[0].astype(np.float64)
    rng = np.random.default_rng(seed)
    return np.stack([np.tanh(d @ rng.normal(size=(3, 3))) for _ in range(n)]).astype(dtype)


def _images(dtype=np.float64):
    return {res: _targets(res[1], 5, 40 + i, dtype) for i, res in enumerate(RES)}


def _task(task, epochs=10, curriculum=(5,)):
    """5 maps in batches of 2 (a ragged last batch, 3 steps an epoch), two
    resolution stages."""
    kw = dict(task=task, batch_size=2, epochs=epochs, multi_res_training=True,
              initial_resolution=RES[0], final_resolution=RES[1], curriculum=curriculum)
    if task == "FIT_DECODER":
        optim = dict(lr_start=1e-3, lr_end=1e-5, beta1=0.0, beta2=0.9)
        kw["kld_weighting"] = 1e-4
    else:
        optim = dict(lr_start=1e-2, lr_end=1e-4, beta1=0.0, beta2=0.9)
        kw.update(cosine_similarity_weight=1e-4, prior_loss_weight=1e-7)
    return kw, optim


def _ttask(task, **kw):
    cfg, optim = _task(task, **kw)
    return ttasks.TaskConfig(**cfg, optim=toptim.OptimConfig(**optim))


def _jtask(task, **kw):
    cfg, optim = _task(task, **kw)
    return jtasks.TaskConfig(**cfg, optim=joptim.OptimConfig(**optim))


def _model_cfg(task, **kw):
    cfg = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
               hidden_layers=2, hidden_features=16, output_activation="tanh",
               fixed_decoder=task != "FIT_DECODER")
    cfg.update(kw)
    return cfg


def _flat(tree):
    return tck._flatten(tparams.to_numpy(tree))


# ---------------------------------------------------------------------------
# a cut and resumed run is the uncut run, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [3, 5], ids=["mid_stage", "stage_end"])
@pytest.mark.parametrize("conditioning", ["cbc", "film"])
@pytest.mark.parametrize("task", ["FIT_DECODER", "FIT_LATENT"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cut_and_resumed_run_is_the_uncut_run(dtype, task, conditioning, cut, tmp_path):
    """fit_task for 10 epochs against the same task stopped by its callback
    at epoch ``cut``, saved (params, optimizer state, generator state) and
    resumed from the files with a generator seeded otherwise: every metric
    and every leaf bit for bit. FIT_DECODER's VAD draws its noise from the
    generator, so the generator state is part of what must come back."""
    model = RENIModel(RENIConfig(**_model_cfg(task, **(FILM if conditioning == "film" else {}))))
    params = model.init(torch.Generator().manual_seed(3), 5, device="cpu")
    params = tparams.map_tree(lambda t: t.to(dtype), params)
    imgs = {res: torch.from_numpy(a).to(dtype) for res, a in _images().items()}
    task_cfg = _ttask(task)

    full, full_m = ttasks.fit_task(model, params, task_cfg, lambda res: imgs[res],
                                   torch.Generator().manual_seed(7))

    path = str(tmp_path / "cut")

    def stop_at_cut(state, epoch, metrics, res):
        if epoch == cut:
            tck.save_checkpoint(path, state.params, model_config=model.config,
                                metadata={"task": task, "epoch": epoch},
                                opt_state=tck.opt_state_arrays(state.optimizer),
                                generator=state.generator)
            return True
        return False

    _, first = ttasks.fit_task(model, params, task_cfg, lambda res: imgs[res],
                               torch.Generator().manual_seed(7), callback_every=1,
                               callback=stop_at_cut)
    saved, meta = tck.load_checkpoint(path)
    assert meta["epoch"] == cut
    resumed, rest = ttasks.fit_task(
        model, tparams.from_numpy(saved, "cpu"), task_cfg, lambda res: imgs[res],
        torch.Generator().manual_seed(99), start_epoch=cut,
        initial_opt_state=functools.partial(tck.load_train_state, path))
    for k in full_m:
        np.testing.assert_array_equal(np.concatenate([first[k], rest[k]]), full_m[k], err_msg=k)
    got, want = _flat(resumed), _flat(full)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fit_inverse_cut_and_resumed_is_the_uncut_run(tmp_path):
    """render/inverse.py::fit_inverse passes the resume arguments through to
    fit_task: FIT_INVERSE stopped at epoch 3 (mid-task), saved and resumed
    ends at the uncut run's bits."""
    from reni_tpu_torch.render import inverse as tinv

    obj = _sphere_obj(tmp_path)
    model = RENIModel(RENIConfig(**_model_cfg("FIT_INVERSE")))
    params = model.init(torch.Generator().manual_seed(3), 3, device="cpu")
    maps = {res: torch.from_numpy(a[:3]).float() for res, a in _images().items()}
    task_cfg = ttasks.TaskConfig(
        task="FIT_INVERSE", optim=toptim.OptimConfig(lr_start=1e-2, lr_end=1e-3),
        batch_size=2, epochs=6, multi_res_training=False, final_resolution=RES[1],
        render_resolution=16, object_path=obj, kd_value=0.5)
    unnormalise = lambda x: x + 1.0  # noqa: E731
    setup = tinv.InverseRenderSetup(obj, render_resolution=16, kd=0.5, device="cpu")
    run = functools.partial(tinv.fit_inverse, model, setup=setup)
    full, full_m = run(params, task_cfg, lambda res: maps[res], unnormalise, torch.Generator())
    path = str(tmp_path / "cut")

    def stop(state, epoch, metrics, res):
        tck.save_checkpoint(path, state.params, metadata={"epoch": epoch},
                            opt_state=tck.opt_state_arrays(state.optimizer))
        return True

    _, first = run(params, task_cfg, lambda res: maps[res], unnormalise, torch.Generator(),
                   callback_every=3, callback=stop)
    saved, _ = tck.load_checkpoint(path)
    resumed, rest = run(tparams.from_numpy(saved, "cpu"), task_cfg, lambda res: maps[res],
                        unnormalise, torch.Generator(), start_epoch=3,
                        initial_opt_state=functools.partial(tck.load_train_state, path))
    for k in full_m:
        np.testing.assert_array_equal(np.concatenate([first[k], rest[k]]), full_m[k], err_msg=k)
    np.testing.assert_array_equal(_flat(resumed)["latents/mu"], _flat(full)["latents/mu"])


def test_resume_without_optimizer_state_differs(tmp_path):
    """The optimizer state is what makes the resumed run exact: the same
    resume with fresh Adam moments gives other bits."""
    task = "FIT_LATENT"
    model = RENIModel(RENIConfig(**_model_cfg(task)))
    params = model.init(torch.Generator().manual_seed(3), 5, device="cpu")
    imgs = {res: torch.from_numpy(a).float() for res, a in _images().items()}
    task_cfg = _ttask(task)
    full, _ = ttasks.fit_task(model, params, task_cfg, lambda res: imgs[res], torch.Generator())
    path = str(tmp_path / "cut")

    def stop(state, epoch, metrics, res):
        tck.save_checkpoint(path, state.params, opt_state=tck.opt_state_arrays(state.optimizer))
        return True

    ttasks.fit_task(model, params, task_cfg, lambda res: imgs[res], torch.Generator(),
                    callback_every=3, callback=stop)
    saved, _ = tck.load_checkpoint(path)
    fresh, _ = ttasks.fit_task(model, tparams.from_numpy(saved, "cpu"), task_cfg,
                               lambda res: imgs[res], torch.Generator(), start_epoch=3)
    assert not np.array_equal(_flat(fresh)["latents/mu"], _flat(full)["latents/mu"])


def test_nothing_to_train_raises():
    task = "FIT_LATENT"
    model = RENIModel(RENIConfig(**_model_cfg(task)))
    params = model.init(torch.Generator().manual_seed(3), 5, device="cpu")
    imgs = {res: torch.from_numpy(a).float() for res, a in _images().items()}
    with pytest.raises(ValueError, match="nothing to train"):
        ttasks.fit_task(model, params, _ttask(task), lambda res: imgs[res], torch.Generator(),
                        start_epoch=10)


# ---------------------------------------------------------------------------
# optimizer state: optax's layout, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed", [False, True], ids=["decoder", "latents"])
@pytest.mark.parametrize("conditioning", ["cbc", "film"])
@pytest.mark.parametrize("opt", [dict(optimizer="adam"), dict(optimizer="sgd", beta1=0.9),
                                 dict(optimizer="sgd"), dict(optimizer="adagrad")],
                         ids=["adam", "sgd_momentum", "sgd", "adagrad"])
def test_optimizer_state_keys_are_optax_flat_keys(opt, conditioning, fixed, tmp_path):
    """Before any step and after three, the port writes under ``__opt__/``
    the keys, shapes and values JAX's checkpoint holds for the same
    optimizer state (values at float64 to 1e-12), and each package's
    loader reads the other's file."""
    kw = dict(_model_cfg("FIT_LATENT" if fixed else "FIT_DECODER"),
              **(FILM if conditioning == "film" else {}))
    jm = JModel(JConfig(**kw))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0), 3))
    ocfg = dict(lr_start=1e-2, lr_end=1e-4, epochs=4, steps_per_epoch=1, **opt)
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        joptimizer = joptim.build_optimizer(joptim.OptimConfig(**ocfg))
        jstate = jtasks.init_train_state(jm, jp64, joptimizer, jax.random.PRNGKey(1))
        jstates = [jstate]
        for i in range(3):
            g = jax.tree.map(lambda x: jnp.sin(x * (i + 1.0)), jstate.trainable)
            upd, os_ = joptimizer.update(g, jstate.opt_state, jstate.trainable)
            tr = jax.tree.map(lambda p, u: p + u, jstate.trainable, upd)
            jstate = jstate._replace(trainable=tr, opt_state=os_)
        jstates.append(jstate)
        jflat = []
        for n, st in enumerate(jstates):
            jck.save_checkpoint(str(tmp_path / f"j{n}"), st.params, opt_state=st.opt_state)
            with np.load(str(tmp_path / f"j{n}.npz")) as z:
                jflat.append({k[len("__opt__/"):]: z[k] for k in z.files
                              if k.startswith("__opt__/")})

    model = RENIModel(RENIConfig(**kw))
    tstate = ttasks.init_train_state(model, tparams.from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float64), jp), "cpu"), toptim.OptimConfig(**ocfg),
        torch.Generator())
    tflat = [tck.opt_state_arrays(tstate.optimizer)]
    for i in range(3):
        tstate.optimizer.zero_grad()
        for name, p in zip(tstate.optimizer.names, (p for g in tstate.optimizer.optimizer
                                                      .param_groups for p in g["params"])):
            p.grad = torch.sin(p.detach() * (i + 1.0))
        tstate.optimizer.step()
    tflat.append(tck.opt_state_arrays(tstate.optimizer))
    for n, (t, j) in enumerate(zip(tflat, jflat)):
        assert sorted(t) == sorted(j), n
        for k in j:
            assert t[k].shape == j[k].shape, k
            if j[k].dtype.kind == "i":
                assert t[k].dtype == j[k].dtype and int(t[k]) == int(j[k]), k
            else:
                # the gradients are sines of the updated leaves: where a sine is
                # near 0, the leaves' last-bit differences show at 1e-16 absolute
                np.testing.assert_allclose(t[k], j[k], rtol=1e-12, atol=1e-16, err_msg=k)
    # the port's file into JAX's loader, JAX's file into the port's
    tck.save_checkpoint(str(tmp_path / "t"), tstate.params, opt_state=tflat[1])
    with jax.enable_x64():
        if sorted(jflat[1]) == ["1/0"]:
            # sgd without momentum: the only leaf is the schedule's count, and
            # JAX's loader cannot rebuild that tree from its own file either
            for name in ("t", "j1"):
                with pytest.raises(KeyError):
                    jck.load_opt_state(str(tmp_path / name), jstates[1].opt_state)
        else:
            back = jck.load_opt_state(str(tmp_path / "t"), jstates[1].opt_state)
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-16), back,
                jstates[1].opt_state)
    fresh = ttasks.init_train_state(model, tstate.params, toptim.OptimConfig(**ocfg),
                                    torch.Generator())
    assert tck.load_opt_state(str(tmp_path / "j1"), fresh.optimizer)
    for k, v in tck.opt_state_arrays(fresh.optimizer).items():
        np.testing.assert_array_equal(v, jflat[1][k].astype(v.dtype), err_msg=k)


def test_opt_state_leaf_count_is_checked(tmp_path):
    model = RENIModel(RENIConfig(**_model_cfg("FIT_DECODER")))
    params = model.init(torch.Generator(), 3, device="cpu")
    state = ttasks.init_train_state(model, params, toptim.OptimConfig(), torch.Generator())
    latent = ttasks.init_train_state(RENIModel(RENIConfig(**_model_cfg("FIT_LATENT"))), params,
                                     toptim.OptimConfig(), torch.Generator())
    tck.save_checkpoint(str(tmp_path / "c"), params,
                        opt_state=tck.opt_state_arrays(latent.optimizer))
    with pytest.raises(ValueError, match="checkpoint has 4 leaves"):
        tck.load_opt_state(str(tmp_path / "c"), state.optimizer)
    tck.save_checkpoint(str(tmp_path / "none"), params)
    assert tck.load_opt_state(str(tmp_path / "none"), state.optimizer) is False


def _jax_noises(n_steps):
    """The latent noise of JAX's first ``n_steps`` FIT_DECODER steps from
    PRNGKey(0), and the key after them."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_steps):
        key, sample_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sample_key, (2, 4, 3), jnp.float64)))
    return out, key


def _jax_uncut(task, jm, jp64, imgs, path):
    """JAX's fit_task over 10 epochs, saving its state at epoch 4."""
    def save_at_4(state, epoch, metrics, res):
        if epoch == 4:
            jck.save_checkpoint(path, state.params, opt_state=state.opt_state,
                                rng_key=state.key, metadata={"task": task, "epoch": 4})

    params, metrics = jtasks.fit_task(
        jm, jp64, _jtask(task), lambda res: jnp.asarray(imgs[res]), jax.random.PRNGKey(0),
        callback_every=4, callback=save_at_4)
    return _flat(jax.device_get(params)), metrics


def _assert_close(got_m, want_m, got_p, want_p, rtol):
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=rtol, err_msg=k)
    assert got_p.keys() == want_p.keys()
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=rtol, atol=1e-300, err_msg=k)


@pytest.mark.parametrize("task", ["FIT_DECODER", "FIT_LATENT"])
def test_jax_checkpoint_continued_by_the_port(task, tmp_path):
    """A JAX checkpoint written at epoch 4 with its optimizer state (and its
    PRNG key, which the port cannot continue: JAX's noise is fed in through
    ``latent_noise``) is continued by the port to epoch 10: its metrics and
    leaves match JAX's uncut run at float64 to 1e-12."""
    cfg = _model_cfg(task)
    jm = JModel(JConfig(**cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(5), 5))
    imgs = _images()
    path = str(tmp_path / "jax_epoch4")
    with jax.enable_x64():
        noises, _ = _jax_noises(10 * 3)
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        want_p, want_m = _jax_uncut(task, jm, jp64, imgs, path)
    saved, meta = tck.load_checkpoint(path)
    assert meta["epoch"] == 4 and "__rng__" not in tck._flatten(saved)
    feed = iter(noises[4 * 3:])
    model = RENIModel(RENIConfig(**cfg))
    params, metrics = ttasks.fit_task(
        model, tparams.from_numpy(saved, "cpu"), _ttask(task),
        lambda res: torch.from_numpy(imgs[res]), torch.Generator(), start_epoch=4,
        initial_opt_state=functools.partial(tck.load_train_state, path),
        latent_noise=lambda shape: torch.tensor(next(feed)))
    _assert_close(metrics, {k: np.asarray(v)[4:] for k, v in want_m.items()},
                  _flat(params), want_p, rtol=1e-12)


@pytest.mark.parametrize("task", ["FIT_DECODER", "FIT_LATENT"])
def test_port_checkpoint_continued_by_jax(task, tmp_path):
    """The port trains to epoch 4 (JAX's noise fed in) and saves with its
    optimizer and generator state; JAX's load_checkpoint finds exactly the
    model's leaves (no stray one: the generator state is in the JSON),
    load_opt_state reads the optimizer state, and JAX continues to epoch 10
    within 1e-12 of its uncut run at float64."""
    cfg = _model_cfg(task)
    jm = JModel(JConfig(**cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(5), 5))
    imgs = _images()
    with jax.enable_x64():
        noises, key4 = _jax_noises(4 * 3)
    model = RENIModel(RENIConfig(**cfg))
    path = str(tmp_path / "port_epoch4")
    feed = iter(noises)

    def save_at_4(state, epoch, metrics, res):
        tck.save_checkpoint(path, state.params, model_config=model.config,
                            metadata={"task": task, "epoch": epoch},
                            opt_state=tck.opt_state_arrays(state.optimizer),
                            generator=state.generator)
        return True

    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    ttasks.fit_task(model, tp, _ttask(task), lambda res: torch.from_numpy(imgs[res]),
                    torch.Generator(), callback_every=4, callback=save_at_4,
                    latent_noise=lambda shape: torch.tensor(next(feed)))
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        want_p, want_m = _jax_uncut(task, jm, jp64, imgs, str(tmp_path / "unused"))
        loaded, meta = jck.load_checkpoint(path)
        assert meta["epoch"] == 4 and "torch_generator_state" in meta
        assert sorted(jck._flatten(loaded)) == sorted(jck._flatten(jp))
        jtask = _jtask(task)
        optimizer = joptim.build_optimizer(dataclasses.replace(
            jtask.optim, epochs=jtask.epochs, steps_per_epoch=3))
        template = jtasks.init_train_state(jm, loaded, optimizer, key4).opt_state
        opt_state = jck.load_opt_state(path, template)
        params, metrics = jtasks.fit_task(
            jm, loaded, jtask, lambda res: jnp.asarray(imgs[res]), key4, start_epoch=4,
            initial_opt_state=opt_state)
        got_p = _flat(jax.device_get(params))
    _assert_close({k: np.asarray(v) for k, v in metrics.items()},
                  {k: np.asarray(v)[4:] for k, v in want_m.items()}, got_p, want_p, rtol=1e-12)


# ---------------------------------------------------------------------------
# the callback schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(callback_every=3), dict(callback_every=4, start_epoch=6),
    dict(callback_every=2, start_epoch=5), dict(callback_every=3, reaugment=True),
    dict(callback_every=5, start_epoch=2, reaugment=True)],
    ids=["every3", "every4_from6", "every2_from_stage_end", "reaugment", "reaugment_from2"])
def test_callback_epochs_and_resolutions_match_jax(case):
    """fit_task calls back at the (epoch, res) pairs JAX's does, with the
    segment's per-epoch metrics; with re-staging, images_at sees the
    (res, epoch) pairs JAX's sees."""
    task = "FIT_LATENT"
    cfg = _model_cfg(task)
    imgs = _images(np.float32)
    seen = {"jax": [], "torch": []}
    staged = {"jax": [], "torch": []}

    def recorder(side):
        def cb(state, epoch, metrics, res):
            seen[side].append((epoch, tuple(res), len(np.asarray(metrics["loss"]))))
        return cb

    def images_at(side, wrap):
        def at(res, epoch=None):
            staged[side].append((tuple(res), epoch))
            return wrap(imgs[tuple(res)])
        return at

    jm = JModel(JConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(0), 5)
    jtasks.fit_task(jm, jp, _jtask(task, epochs=12, curriculum=(5,)),
                    images_at("jax", jnp.asarray), jax.random.PRNGKey(0),
                    callback=recorder("jax"), **case)
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.device_get(jp), "cpu")
    ttasks.fit_task(model, tp, _ttask(task, epochs=12, curriculum=(5,)),
                    images_at("torch", torch.from_numpy), torch.Generator(),
                    callback=recorder("torch"), **case)
    assert seen["torch"] == seen["jax"] and seen["jax"]
    if case.get("reaugment"):
        assert [s for s in staged["torch"] if s[1] is not None] == [
            s for s in staged["jax"] if s[1] is not None]


def test_wall_target_segments_grow_by_powers_of_two(monkeypatch):
    """Under RENI_TPU_CKPT_WALL_S each stage starts with a one-epoch segment,
    then segments of a power of two up to callback_every."""
    monkeypatch.setenv("RENI_TPU_CKPT_WALL_S", "3.5")
    clock = [0.0]
    monkeypatch.setattr(ttasks.time, "monotonic", lambda: clock[0])
    task = "FIT_LATENT"
    model = RENIModel(RENIConfig(**_model_cfg(task)))
    params = model.init(torch.Generator(), 5, device="cpu")
    imgs = {res: torch.from_numpy(a).float() for res, a in _images().items()}
    real = ttasks.run_stage

    def one_second_an_epoch(step_fn, state, images, n_epochs, batch_size):
        clock[0] += n_epochs
        return real(step_fn, state, images, n_epochs, batch_size)

    monkeypatch.setattr(ttasks, "run_stage", one_second_an_epoch)
    epochs = []
    ttasks.fit_task(model, params, _ttask(task, epochs=16, curriculum=(9,)),
                    lambda res: imgs[res], torch.Generator(), callback_every=8,
                    callback=lambda st, e, m, r: epochs.append(e))
    # 1 s an epoch, target 3.5 s: segments of 2 after the first
    assert epochs == [1, 3, 5, 7, 9, 10, 12, 14, 16]


# ---------------------------------------------------------------------------
# the trainer's helpers against JAX's
# ---------------------------------------------------------------------------


def test_best_tracker_retention_matches_jax(tmp_path):
    """Best-2 by loss plus ``_latest`` (tests/test_checkpoint.py:101): with a
    non-monotonic loss the newest epoch survives as ``_latest`` only; the
    same files as JAX's tracker, find_latest resolves the run dir to it."""
    losses = ((4, 1.0), (8, 0.5), (12, 2.0), (16, 0.7), (20, 0.7))
    jm = JModel(JConfig(**_model_cfg("FIT_LATENT")))
    jp = jm.init(jax.random.PRNGKey(20), 2)
    jt = jrun._BestTracker(str(tmp_path / "jax"), "FIT_LATENT", jm.config, keep=2)
    model = RENIModel(RENIConfig(**_model_cfg("FIT_LATENT")))
    tp = tparams.from_numpy(jax.device_get(jp), "cpu")
    tt = trun._BestTracker(str(tmp_path / "torch"), "FIT_LATENT", model.config, keep=2)
    for epoch, loss in losses:
        jt.maybe_save(jp, epoch, loss)
        tt.maybe_save(tp, epoch, loss)
        assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert tt.best_path.endswith("epoch=0008") and jt.best_path.endswith("epoch=0008")
    assert [p for _, p in tt.saved] == [p.replace("jax", "torch") for _, p in jt.saved]
    latest = tck.find_latest(str(tmp_path / "torch"))
    assert latest.endswith("fit_latent_latest") and tck._meta_only(latest)[1]["epoch"] == 20
    assert tck.find_latest(tt.best_path) == tt.best_path
    # a relaunched tracker takes over the kept files, as the uncut one holds them
    again = trun._BestTracker(str(tmp_path / "torch"), "FIT_LATENT", model.config, keep=2)
    again.adopt(20)
    assert again.saved == tt.saved


@pytest.mark.parametrize("tpu", [0, 1, 2], ids=["no_tpu_block", "tpu_defaults", "tpu_knobs"])
@pytest.mark.parametrize("task", [None, "FIT_DECODER", "FIT_LATENT", "FIT_INVERSE"])
@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_from_reni_cfg_matches_jax(conditioning, task, tpu):
    tcfg, jcfg = tdefaults(), jdefaults()
    for c in (tcfg, jcfg):
        c.RENI.CONDITIONING = conditioning
        c.RENI.FIRST_LAYER_INIT_SCALE = 1.5 if tpu == 2 else 1.0
        if tpu == 2:
            c.TPU.USE_PALLAS, c.TPU.PRECISION, c.TPU.FAST_SINE = False, "float32", False
    tblock = None if tpu == 0 else tcfg.TPU
    jblock = None if tpu == 0 else jcfg.TPU
    got = dataclasses.asdict(RENIConfig.from_reni_cfg(tcfg.RENI, task, tpu_cfg=tblock))
    want = dataclasses.asdict(JConfig.from_reni_cfg(jcfg.RENI, task, tpu_cfg=jblock))
    assert got == want


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (4, 3, 6, 3), (7, 2, 2, 3)])
@pytest.mark.parametrize("nrow", [5, 2])
def test_make_grid_and_png_match_jax(shape, nrow, tmp_path):
    """make_grid equals JAX's; the port's PNG (numpy + zlib) decodes with PIL
    to the pixels of the PNG JAX's logger writes with PIL."""
    from PIL import Image

    images = np.random.default_rng(shape[0]).uniform(-0.2, 1.2, size=shape).astype(np.float32)
    grid = tlog.make_grid(images, nrow=nrow)
    np.testing.assert_array_equal(grid, jlog.make_grid(images, nrow=nrow))
    jl = jlog.MetricLogger(str(tmp_path / "jax"), use_tensorboard=False)
    tl = tlog.MetricLogger(str(tmp_path / "torch"), use_tensorboard=False)
    jl.log_image("grid", grid, 3)
    tl.log_image("grid", grid, 3)
    jl.close()
    tl.close()
    name = os.path.join("images", "grid_000003.png")
    port = np.asarray(Image.open(tmp_path / "torch" / name))
    assert port.dtype == np.uint8 and port.shape == grid.shape
    np.testing.assert_array_equal(port, np.asarray(Image.open(tmp_path / "jax" / name)))
    # the port's own PNG reader reads it back too
    np.testing.assert_array_equal(tsph.read_png(str(tmp_path / "torch" / name)), port)


def _sphere_obj(tmp_path) -> str:
    from reni_tpu.render import mesh as jmesh

    m = jmesh.make_uv_sphere(6, 12)
    obj = tmp_path / "sphere.obj"
    with open(obj, "w") as f:
        for v in m.verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in m.faces + 1:
            f.write(f"f {a} {b} {c}\n")
    return str(obj)


def _sphere_setup(tmp_path):
    from reni_tpu.render import inverse as jinv

    return jinv.InverseRenderSetup(_sphere_obj(tmp_path), render_resolution=16, kd=0.5)


@pytest.mark.parametrize("kind", ["ldr", "hdr", "inverse"])
def test_example_images_at_explicit_indices_match_jax(kind, tmp_path):
    """example_images with explicit indices (reconstructions above the maps;
    for FIT_INVERSE renders above the GT renders), the same grid as JAX's to
    1e-5, at float32 through each package's plain decoder."""
    from reni_tpu.data import transforms as jT
    from reni_tpu_torch.data import transforms as tT

    cfg = dict(_model_cfg("FIT_LATENT"), output_activation="tanh")
    jm = JModel(JConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(8), 5)
    model = RENIModel(RENIConfig(**cfg))
    tp = tparams.from_numpy(jax.device_get(jp), "cpu")
    res = (8, 16)
    maps = _targets(16, 5, 9, np.float32)
    if kind == "ldr":
        jun, tun = jT.UnNormalise([0.5] * 3, [0.5] * 3), tT.UnNormalise([0.5] * 3, [0.5] * 3)
    else:
        mm = (-18.0536, 11.4633)
        jun, tun = jT.UnMinMaxNormalise(mm), tT.UnMinMaxNormalise(mm)
    kw = dict(mode=[3, 0, 4], n_images=3, is_hdr=kind != "ldr")
    jkw, tkw = dict(kw), dict(kw)
    if kind == "inverse":
        # one renderer for both grids (JAX's; the port's is held to it in
        # tests/test_torch_render.py), so that the grids' composition is
        # what is compared
        jset = _sphere_setup(tmp_path)
        render = jset.render_fn(16)
        gt = jset.generate_gt_renders(jnp.asarray(maps), jun, 16)
        jkw.update(render_fn=render, gt_renders=gt)
        tkw.update(render_fn=lambda env, sw: torch.from_numpy(np.asarray(
            render(jnp.asarray(_np(env)), jnp.asarray(_np(sw))))),
            gt_renders=torch.from_numpy(np.asarray(gt)))
    want = jvis.example_images(jm, jp, res, dataset_images=jnp.asarray(maps), unnormalise=jun,
                               **jkw)
    got = tvis.example_images(model, tp, res, dataset_images=torch.from_numpy(maps),
                              unnormalise=tun, **tkw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_example_images_random_and_noise_repeat_for_one_seed():
    """The random rows and prior samples come from the generator it is
    given: one seed, one grid (the trainer re-seeds for every grid)."""
    cfg = _model_cfg("FIT_LATENT")
    model = RENIModel(RENIConfig(**cfg))
    tp = model.init(torch.Generator().manual_seed(1), 5, device="cpu")
    maps = torch.from_numpy(_targets(16, 5, 9, np.float32))
    for mode in ("random", "noise"):
        a, b = (tvis.example_images(model, tp, (8, 16), mode=mode, n_images=3,
                                    generator=torch.Generator().manual_seed(4),
                                    dataset_images=maps) for _ in range(2))
        np.testing.assert_array_equal(a, b)
        assert a.shape == ((2 if mode == "random" else 1) * 10 + 2, 3 * 18 + 2, 3)
