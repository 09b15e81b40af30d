"""The port's tensor-parallel model axis (reni_tpu_torch/parallel/mesh.py's
model axis and state_sharding(shard_model=), parallel/tp.py's sharded plain
decoder, the stage runners' model sharding, the trainer's --mesh DxPxM) held
against the JAX package on the CPU, after tests/test_parallel.py's TP tests.

Single-process cases: the mesh shapes with a model axis, the alternating
specs and the moments born in their parameter's slice, a width the axis does
not divide, the kernel dispatch declining on the axis (JAX's reason; on the
card ``apply`` raises). Then gloo ranks as processes, started once for the
module: four (tests/torch_tp_worker.py ``four``: a 2 x 1 x 2 and a 1 x 1 x 4
mesh), two (``two``: FiLM on 1 x 1 x 2) and the trainer's 2-rank chain on
``--mesh 1x1x2`` (tests/torch_multihost_worker.py), uncut, and killed after
its first checkpoint then relaunched with --retries 1. FIT_DECODER against
JAX's single-device and TP fits at tests/test_parallel.py's bars (loss rtol
5e-4, params atol 5e-5); one float64 epoch against JAX to 1e-12 (a missing
or doubled model sum breaks it); the streaming runner in chunks from host
memory and from disk bit for bit the resident run; FIT_INVERSE with the
sharded frozen decoder; two runs the same bits; replicated leaves the same
bits on every rank; the relaunched trainer bit for bit the uncut one, and
its checkpoints whole tensors in optax's layout that JAX loads.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as W
from reni_tpu.core import sphere as jsph
from reni_tpu.kernels import siren_pallas as jk
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.parallel import mesh as jmesh
from reni_tpu.train import checkpoint as jck
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu_torch.data import synthetic
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.parallel import mesh as pmesh
from reni_tpu_torch.params import from_numpy
from reni_tpu_torch.render import mesh as render_mesh
from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import tasks as ttasks
from reni_tpu_torch.train.optim import OptimConfig
from test_torch_multihost import WORKER as CLI_WORKER
from test_torch_multihost import _config as cli_config
from test_torch_multihost import _versions, _write
from torch_ranks import ROOT, Ranks

RANKS_S = 240  # each set of ranks' time limit


def _synthetic(n, width, seed):
    d = np.asarray(jsph.get_directions(width))[0]
    rng = np.random.default_rng(seed)
    return np.stack([np.tanh(d @ rng.normal(size=(3, 3))) for _ in range(n)]).astype(np.float32)


def _jax_params(kw, seed, rows):
    return jax.device_get(JModel(JConfig(**kw)).init(jax.random.PRNGKey(seed), dataset_size=rows))


def _jax_noise(key, steps, shape, dtype=jnp.float32):
    """The latent noise JAX's fit_task draws from ``key`` for ``steps``
    FIT_DECODER steps: each step splits its key and samples from the
    second half."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype)))
    return np.stack(out)


def _jtask(kw, **over):
    kw = dict(kw, **over)
    return jtasks.TaskConfig(**dict(kw, optim=joptim.OptimConfig(**kw["optim"])))


def _flat(tree):
    return tck._flatten(tree)


def _part(out: dict, prefix: str) -> tuple[dict, dict]:
    params = {k[len(prefix) + 8:]: v for k, v in out.items() if k.startswith(prefix + "/params/")}
    metrics = {k[len(prefix) + 9:]: v for k, v in out.items()
               if k.startswith(prefix + "/metrics/")}
    return params, metrics


def _ldr(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("Train", 5), ("Test", 3)):
        d = root / split
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.uniform(size=(16, 32, 3)) * 255).astype(np.uint8)).save(
                str(d / f"img{i}.png"))
    return str(root)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start every set of ranks on the module's inputs; the value is a
    function of the set's name that waits for it and returns its results:
    the per-rank npz of ``four`` and ``two``, the run dirs of the trainer's
    ``uncut`` and ``relaunched`` chains."""
    work = tmp_path_factory.mktemp("tp")
    inp = {"images_tp": _synthetic(6, 16, seed=20), "images_tp_only": _synthetic(4, 16, seed=23),
           "inverse": _synthetic(4, 16, seed=9) * 0.5}
    with jax.enable_x64():
        inp["noise64"] = _jax_noise(jax.random.PRNGKey(22), 1, (8, 4, 3), jnp.float64)
    d = np.random.default_rng(8).normal(size=(1, 64, 3)).astype(np.float32)
    inp["directions"] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    trees = {"tp": _jax_params(W.MODEL, 21, 6), "tp_only": _jax_params(W.MODEL, 24, 4),
             "deep": _jax_params(W.DEEP, 21, 6), "film": _jax_params(W.FILM, 21, 6),
             "inverse": _jax_params(W.INVERSE, 0, 4), "stream": _jax_params(W.MODEL, 4, 8)}
    for name, tree in trees.items():
        inp.update({f"{name}/{k}": v for k, v in _flat(tree).items()})
    inp["noise_tp"] = _jax_noise(jax.random.PRNGKey(22), W.TP["epochs"], (8, 4, 3))
    inp["noise_tp_only"] = _jax_noise(jax.random.PRNGKey(25), W.TP_ONLY["epochs"], (4, 4, 3))
    inp["exr_dir"] = np.asarray(synthetic.write_dataset(
        str(work / "exr"), train=8, test=0, width=32, seed=2)["Train"])
    np.savez(work / "inputs.npz", **inp)
    worker = str(ROOT / "tests" / "torch_tp_worker.py")
    data = _ldr(work / "ldr")
    cfgs = {}
    for name in ("uncut", "relaunched"):
        cfg = cli_config(data, str(work / name))
        cfg.TPU.SHARD_LATENTS = False
        cfgs[name] = _write(cfg, work / f"{name}.json")
    mesh = ["--", "--mesh", "1x1x2"]
    launched = {
        "four": Ranks([worker, "four", str(work), str(work / "init_four")], 4),
        "two": Ranks([worker, "two", str(work), str(work / "init_two")], 2),
        "uncut": Ranks([CLI_WORKER, "cli", str(work / "init_uncut"), cfgs["uncut"], "0", *mesh],
                       2),
        "killed": Ranks([CLI_WORKER, "cli", str(work / "init_killed"), cfgs["relaunched"], "1",
                         *mesh], 2),
    }
    done: dict = {}

    def relaunch(block=False):
        # the killed chain's relaunch, as soon as both its ranks have ended
        if "relaunched" not in launched and (block or all(p.poll() is not None
                                                          for p in launched["killed"].procs)):
            outs = launched["killed"].wait(RANKS_S)
            assert [rc for rc, _ in outs] == [17, 17], outs
            launched["relaunched"] = Ranks([CLI_WORKER, "cli", str(work / "init_relaunched"),
                                            cfgs["relaunched"], "0", *mesh, "--retries", "1"], 2)

    def result(name):
        relaunch()
        if name in done:
            return done[name]
        if name in ("four", "two"):
            launched[name].check(RANKS_S)
            n = 4 if name == "four" else 2
            done[name] = ([dict(np.load(work / f"{name}_{r}.npz")) for r in range(n)], inp, trees)
        elif name == "uncut":
            logs = launched["uncut"].check(RANKS_S)
            done[name] = (_versions(work / "uncut"), logs)
        else:
            relaunch(block=True)
            logs = launched["relaunched"].check(RANKS_S)
            done[name] = (_versions(work / "relaunched"), logs)
        return done[name]

    yield result
    for procs in launched.values():
        for p in procs.procs:
            if p.poll() is None:
                p.kill()


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 1, 4), (1, 1, 8), (4, 1, 2)])
def test_mesh_shapes_with_a_model_axis(ranks, dims):
    """tests/test_parallel.py:45-47's shapes: the axis sizes, and every
    rank's coordinates those of its device in JAX's mesh (row-major, the
    model axis minor). (It asks for ``ranks`` so that they start first.)"""
    jm = jmesh.make_mesh(*dims, devices=jax.devices())
    for r, device in enumerate(jm.devices.reshape(-1)):
        m = pmesh.Mesh(*dims, rank=r)
        assert m.shape == dict(jm.shape) and m.size == 8
        want = tuple(int(c[0]) for c in np.nonzero(jm.devices == device))
        assert (m.data_index, m.pixel_index, m.model_index) == want
    with pytest.raises(ValueError, match="WORLD_SIZE 1 does not divide over pixel=1 x model=2"):
        pmesh.make_mesh(n_model=2, device="cpu")


@pytest.mark.parametrize("hidden_layers", [1, 2], ids=["final_whole", "final_row"])
def test_specs_alternate_and_moments_shard_like_their_params(hidden_layers):
    """tests/test_parallel.py:368-400: even trunk layers column-parallel, odd
    ones row-parallel, final.w row-parallel when fed sharded activations,
    the latents and the FiLM mapping whole; the specs are JAX's. Cut for a
    stage on model coordinate 1 of 2, each leaf holds its slice, the
    optimizer's moments are born in that shape at the first step and the
    gather makes both whole again (the whole values where they were)."""
    kw = dict(W.MODEL, hidden_layers=hidden_layers)
    jp = _jax_params(kw, 26, 4)
    model = RENIModel(RENIConfig(**kw))
    params = from_numpy(jp, "cpu")
    specs = pmesh.state_sharding(pmesh.Mesh(2, 2, 2), params)
    jm = jmesh.make_mesh(2, 2, 2, devices=jax.devices())
    jspecs = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(sh.spec)
              for path, sh in jax.tree_util.tree_leaves_with_path(jmesh.state_sharding(jm, jp))}
    assert specs == jspecs
    assert specs["decoder/layers/0/w"] == (None, "model") and specs["decoder/layers/0/b"] == (
        "model",)
    assert specs["decoder/layers/1/w"] == ("model", None) and specs["decoder/layers/1/b"] == ()
    assert specs["decoder/final/w"] == (("model", None) if hidden_layers == 2 else ())
    assert specs["latents/mu"] == ()
    film = _jax_params(W.FILM, 3, 2)
    fspecs = pmesh.state_sharding(pmesh.Mesh(1, 1, 2), from_numpy(film, "cpu"))
    assert all(v == () for k, v in fspecs.items() if "mapping" in k)

    state = ttasks.init_train_state(model, params, OptimConfig(lr_start=1e-3, lr_end=1e-3,
                                                               epochs=1, steps_per_epoch=1),
                                    torch.Generator())
    before = {k: v.detach().clone() for k, v in _named(state).items()}
    gather = pmesh.shard_model_leaves(state, pmesh.Mesh(1, 1, 2, rank=1))
    for path, t in _named(state).items():
        spec = specs[path]
        want = before[path] if "model" not in spec else before[path].narrow(
            spec.index("model"), before[path].shape[spec.index("model")] // 2,
            before[path].shape[spec.index("model")] // 2)
        assert torch.equal(t, want), path
        assert getattr(t, "model_shard", None) is None or "model" in spec
    loss = sum((t * t).sum() for t in state.trainable["decoder"]["layers"][0].values())
    loss.backward()
    state.optimizer.step()
    for path, t in _named(state).items():
        st = state.optimizer.optimizer.state.get(t, {})
        if st:
            assert st["exp_avg"].shape == t.shape, path
    gather()  # a layout: the all-reduce over one rank's group is none
    assert all(t.shape == before[k].shape for k, t in _named(state).items())


def _named(state):
    from reni_tpu_torch.params import tree_items

    return dict(tree_items(state.params))


def test_a_width_the_model_axis_does_not_divide_raises():
    """tests/test_parallel.py:403-420."""
    kw = dict(W.MODEL, model_type="AutoDecoder", hidden_features=30)
    params = from_numpy(_jax_params(kw, 28, 2), "cpu")
    with pytest.raises(ValueError, match="model axis"):
        pmesh.state_sharding(pmesh.Mesh(1, 2, 4), {"decoder": params["decoder"]})


def test_the_dispatch_declines_on_a_model_axis(monkeypatch):
    """tests/test_pallas_sharded.py:200-235: unsupported_reason and the step
    kernel's reason name the model axis with JAX's words (the port runs its
    plain decoder where JAX runs XLA); on the card ``apply`` with use_pallas
    under a model axis raises instead of decoding plain."""
    jm = jmesh.make_mesh(2, 2, 2, devices=jax.devices())
    want = jk.unsupported_reason(512, 128, mesh=jm)
    got = tk.unsupported_reason(512, 128, mesh=pmesh.Mesh(2, 2, 2))
    assert got.split(";")[0] == want.split(";")[0] == (
        "mesh has a model (tensor-parallel) axis of size 2")
    assert "chip-resident weights" in got and "chip-resident weights" in want
    model = RENIModel(RENIConfig(**dict(W.MODEL, use_pallas=True, hidden_features=64)))
    with pmesh.kernel_mesh(pmesh.Mesh(1, 1, 2), 128):
        assert model.fused_step_reason(4, 128) == tk.unsupported_reason(
            128, 64, mesh=pmesh.Mesh(1, 1, 2))
    params = model.init(torch.Generator(), 2, device="cpu")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pmesh.kernel_mesh(pmesh.Mesh(1, 1, 2), 128), pytest.raises(
            ValueError, match="mesh has a model"):
        model.apply(params, model.latents(params, [0]), torch.zeros(1, 128, 3))


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tp", "tp_only", "film"])
def test_fit_decoder_on_the_model_axis_matches_jax(ranks, case):
    """FIT_DECODER on 2 x 1 x 2, on TP-only 1 x 1 x 4 (both against JAX's
    single-device fit and JAX's fit on the same mesh) and FiLM on 1 x 1 x 2
    (against JAX's single-device fit), with JAX's latent noise, at
    tests/test_parallel.py:295-365's bars: loss rtol 5e-4, params atol
    5e-5."""
    outs, inp, trees = ranks("two" if case == "film" else "four")
    kw = {"tp": W.MODEL, "tp_only": W.MODEL, "film": W.FILM}[case]
    task = W.TP_ONLY if case == "tp_only" else W.TP
    images = inp["images_tp_only" if case == "tp_only" else "images_tp"]
    dims = {"tp": (2, 1, 2), "tp_only": (1, 1, 4)}.get(case)
    params, metrics = _part(outs[0], case)
    meshes = [None] if dims is None else [
        None, jmesh.make_mesh(*dims, devices=jax.devices()[:int(np.prod(dims))])]
    for mesh in meshes:
        # the key JAX's noise was drawn from for the ranks
        jp, jmet = jtasks.fit_task(JModel(JConfig(**kw)), trees[case], _jtask(task),
                                   lambda res: jnp.asarray(images),
                                   jax.random.PRNGKey(25 if case == "tp_only" else 22), mesh=mesh)
        np.testing.assert_allclose(metrics["fit_decoder_loss"], jmet["fit_decoder_loss"],
                                   rtol=5e-4)
        want = _flat(jax.device_get(jp))
        assert params.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(params[k], want[k], atol=5e-5, err_msg=k)


@pytest.mark.parametrize("case", ["cbc", "deep", "latent", "film"])
def test_one_float64_epoch_matches_jax(ranks, case):
    """One float64 epoch on the model axis (the frozen decoder sharded for
    FIT_LATENT) against JAX's single-device fit under x64, JAX's noise fed
    to both: the metrics to 1e-12 relative, the leaves to 1e-9 (Adam's first
    step is about lr x sign(g)). Counting a replicated gradient twice, or
    leaving out a ``copy``, is off by far more."""
    outs, inp, trees = ranks("two" if case == "film" else "four")
    kw = {"cbc": W.MODEL, "deep": W.DEEP, "latent": dict(W.MODEL, fixed_decoder=True),
          "film": W.FILM}[case]
    key = {"cbc": "tp", "deep": "deep", "latent": "tp", "film": "film"}[case]
    task = W.LATENT if case == "latent" else W.TP
    params, metrics = _part(outs[0], f"f64_{case}")
    with jax.enable_x64():
        jm = JModel(JConfig(**kw))
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), trees[key])
        images = jnp.asarray(inp["images_tp"].astype(np.float64))
        # the key of the float64 noise the ranks were fed
        jp, jmet = jtasks.fit_task(jm, jp64, _jtask(task, epochs=1), lambda res: images,
                                   jax.random.PRNGKey(22))
        want = _flat(jax.device_get(jp))
    for k, v in jmet.items():
        np.testing.assert_allclose(metrics[k], np.asarray(v), rtol=1e-12, atol=0, err_msg=k)
    for k in want:
        np.testing.assert_allclose(params[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_the_dispatch_takes_the_sharded_decoder_with_a_note(ranks):
    """Each rank's decode with use_pallas under the 2 x 1 x 2 kernel mesh
    (on CPU tensors, its slices of the weights) equals the whole decoder's
    decode, and the step kernel's reason is the model axis'."""
    outs, inp, trees = ranks("four")
    model = RENIModel(RENIConfig(**W.MODEL))
    params = from_numpy(trees["tp"], "cpu")
    with torch.no_grad():
        want = model.apply(params, model.latents(params, [0, 1, 2]),
                           torch.from_numpy(inp["directions"])).numpy()
    for out in outs:
        np.testing.assert_allclose(out["dispatch/decode"], want, atol=1e-6)
        assert str(out["dispatch/reason"]).startswith("mesh has a model (tensor-parallel) axis")


def test_fit_inverse_on_the_model_axis(ranks):
    """FIT_INVERSE with the frozen decoder sharded on 2 x 1 x 2 against the
    port's single-device run (rtol 2e-4, the data x pixel mesh's bar in
    tests/test_torch_parallel.py)."""
    outs, inp, trees = ranks("four")
    params, metrics = _part(outs[0], "inverse")
    setup = InverseRenderSetup(render_mesh.make_uv_sphere(8, 16), device="cpu", **W.SCENE)
    p, m = fit_inverse(RENIModel(RENIConfig(**W.INVERSE)), from_numpy(trees["inverse"], "cpu"),
                       W.task_config(W.INVERSE_TASK), lambda res: torch.from_numpy(inp["inverse"]),
                       lambda x: x, torch.Generator().manual_seed(1), setup=setup)
    np.testing.assert_allclose(metrics["fit_inverse_loss"], m["fit_inverse_loss"], rtol=2e-4)
    np.testing.assert_allclose(params["latents/mu"], _flat(tck.fetch_tree(p))["latents/mu"],
                               atol=2e-5)


@pytest.mark.parametrize("label", ["host", "disk"])
def test_streaming_in_chunks_on_the_model_axis(ranks, label):
    """tests/test_streaming.py:363-385: the streaming runner in chunks of 2
    on 2 x 1 x 2 (from host memory, from disk: each model rank of a data
    coordinate decodes that coordinate's rows) ends bit for bit at the
    resident run on the mesh, which is the port's single-device resident
    fit within JAX's 1e-5."""
    outs, inp, trees = ranks("four")
    for out in outs:
        base, got = _part(out, "stream_resident"), _part(out, f"stream_{label}")
        for x, y in zip(base, got):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=f"{label} {k}")
        if label == "disk":
            d = int(out["coords"][0])
            rows = set(out["stream_disk/decoded"].tolist())
            assert rows == {i for i in range(8) if (i % 4) // 2 == d}, rows
    from reni_tpu_torch.data import datasets

    eager = datasets.get_dataset("RENI_HDR", str(inp["exr_dir"]), W.PUBLISHED, True)
    p, m = ttasks.fit_task(RENIModel(RENIConfig(**W.MODEL)), from_numpy(trees["stream"], "cpu"),
                           W.task_config(W.STREAM), lambda res: eager.images_at(res, device="cpu"),
                           torch.Generator().manual_seed(5))
    eager.close()
    params, metrics = _part(outs[0], "stream_resident")
    for k in m:
        np.testing.assert_allclose(metrics[k], m[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k, v in _flat(tck.fetch_tree(p)).items():
        np.testing.assert_allclose(params[k], v, atol=1e-5, rtol=1e-5, err_msg=k)


def test_two_runs_give_the_same_bits_and_replicas_agree(ranks):
    """Two runs on 2 x 1 x 2 give the same bits, and every rank returns the
    same whole parameters and metrics (the model-sharded leaves gathered,
    the replicated ones bitwise equal)."""
    outs, _, _ = ranks("four")
    for out in outs:
        a, b = _part(out, "tp"), _part(out, "tp_again")
        for x, y in zip(a, b):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    keys = [k for k in outs[0] if "/params/" in k or "/metrics/" in k]
    assert len(keys) > 100
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def test_killed_tp_trainer_relaunched_is_the_uncut_chain(ranks):
    """The trainer's chain on --mesh 1x1x2, both ranks ended after the first
    checkpoint and relaunched with --retries 1: it adopts the run and its
    final checkpoints are the uncut chain's bit for bit; rank 0 alone writes
    (one run dir); TPU.USE_PALLAS (on by default) is turned off on the axis,
    with a line."""
    (uncut,), logs = ranks("uncut")
    (relaunched,), relogs = ranks("relaunched")
    assert "[relaunch] adopting" in relogs[0]
    assert "TPU.USE_PALLAS off on the model axis (model=2)" in logs[0]
    for task in ("fit_decoder", "fit_latent"):
        with np.load(uncut / "checkpoints" / f"{task}_final.npz") as a, \
                np.load(relaunched / "checkpoints" / f"{task}_final.npz") as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{task} {k}")


def test_tp_checkpoints_are_whole_and_load_in_jax(ranks):
    """The TP trainer's checkpoints hold whole tensors in optax's layout:
    JAX's load_checkpoint reads the decoder at its config's whole shapes,
    its load_opt_state fills the template of JAX's own optimizer with leaves
    of the template's shapes, and JAX's decode of them equals the port's on
    one device."""
    (uncut,), _ = ranks("uncut")
    path = str(uncut / "checkpoints" / "fit_decoder_latest")
    loaded, meta = jck.load_checkpoint(path)
    cfg = JConfig(**meta["model_config"])
    jm = JModel(cfg)
    fresh = jm.init(jax.random.PRNGKey(0), dataset_size=5)
    assert {k: v.shape for k, v in _flat(fresh).items()} == {
        k: v.shape for k, v in _flat(loaded).items()}
    optim = joptim.build_optimizer(joptim.OptimConfig(epochs=8, steps_per_epoch=2))
    template = jtasks.init_train_state(jm, loaded, optim, jax.random.PRNGKey(1)).opt_state
    opt_state = jck.load_opt_state(path, template)
    for a, b in zip(jax.tree.leaves(opt_state), jax.tree.leaves(template)):
        assert a.shape == b.shape
    model = RENIModel(tck.load_model_config(path))
    params = from_numpy(tck.load_checkpoint(path)[0], "cpu")
    D = jsph.get_directions(16)
    with torch.no_grad():
        got = model.apply(params, model.latents(params, [0, 1]), torch.tensor(np.asarray(D)))
    want = jm.apply(loaded, jm.latents(loaded, np.arange(2)), D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rows = [json.loads(line) for line in open(uncut / "metrics.jsonl")]
    assert any("fit_latent_loss" in r for r in rows)
