"""FIT_INVERSE's graphed step (``reni_tpu_torch/train/tasks.py::GraphedStep``):
on the CPU it stays the eager step, bit for bit; the capturable Adam's LR
tensor takes the schedule's float32 values, and its state round-trips
through a checkpoint; spans and ``snapshot()`` while a capture is in
progress; a replay's metrics are copies, and a replay adds to the kernels'
launch counters what its capture counted; a mesh or a failed capture falls
back to the eager step with one log line; the runner's call boundary
(``run_stage``) uploads a batch layout once and reads back once a dtype;
the benchmark's ``graph_replay_pct.fit_inverse`` reads the share of
replayed steps.

The tests marked ``cuda`` hold graph replays against eager steps, bit for
bit, at the benchmark's FIT_INVERSE shapes on the card, and skip without
one; this file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_step.py -q
"""

import contextlib
import gc
import types

import numpy as np
import pytest
import torch

from portbench import harness
from reni_tpu_torch.core import sphere
from reni_tpu_torch.models import reni as reni_mod
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.params import tree_items
from reni_tpu_torch.render import inverse
from reni_tpu_torch.render import mesh as mesh_lib
from reni_tpu_torch.render import shading
from reni_tpu_torch.kernels import siren_bwd, siren_fwd, siren_step
from reni_tpu_torch.train import checkpoint, tasks
from reni_tpu_torch.train.optim import (
    OptimConfig,
    ScheduledOptimizer,
    build_optimizer,
    build_schedule,
)
from reni_tpu_torch.utils import graphs, profiling

WIDTH = 16  # 8 x 16 directions
MAPS = 3


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _cpu_inverse():
    cfg = RENIConfig(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
                     hidden_layers=2, hidden_features=32, output_activation=None,
                     last_layer_linear=True, fixed_decoder=True, use_pallas=True)
    model = RENIModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), MAPS, device="cpu")
    params["latents"]["mu"] = torch.randn(params["latents"]["mu"].shape,
                                          generator=torch.Generator().manual_seed(3))
    state = tasks.init_train_state(model, params, OptimConfig(lr_start=1e-2, lr_end=1e-3,
                                                              epochs=2, steps_per_epoch=1),
                                   torch.Generator().manual_seed(1))
    setup = inverse.InverseRenderSetup(mesh_lib.make_uv_sphere(8, 16), render_resolution=16,
                                       kd=0.5, light_chunk=64, device="cpu")
    maps = torch.rand((MAPS, WIDTH * WIDTH // 2, 3), generator=torch.Generator().manual_seed(2))
    gt = setup.generate_gt_renders(maps, lambda x: x, WIDTH)
    step = tasks.make_fit_inverse_step(model, sphere.get_directions(WIDTH, device="cpu"),
                                       sphere.get_sineweight(WIDTH, device="cpu"),
                                       setup.render_fn(WIDTH), lambda x: x, alpha=1e-7,
                                       beta=1e-3)
    return state, step, gt


def _capturable_on_cpu(monkeypatch):
    """Let torch run Adam's capturable form on the CPU, whose arithmetic is
    the card's (torch allows it only on accelerators)."""
    from torch.optim import adam

    devices = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*devices(*a, **k), "cpu"])


def _moments(state) -> list:
    opt = state.optimizer.optimizer
    return [t.clone() for _, p in tree_items(state.trainable)
            for t in opt.state[p].values()]


def test_on_the_cpu_the_step_stays_eager_bit_for_bit(monkeypatch):
    """Three steps of the graphed step on the CPU give the eager step's
    loss, latents and Adam moments bit for bit, capture nothing and keep
    the optimizer as it was built."""
    monkeypatch.setattr(reni_mod, "_noted_paths", set())
    runs = {}
    for graph in (True, False):
        state, step, gt = _cpu_inverse()
        run = step if graph else step.eager
        batch = (gt, torch.arange(MAPS), torch.ones(MAPS))
        losses = [run(state, batch)[1]["loss"] for _ in range(3)]
        runs[graph] = losses, dict(tree_items(state.trainable)), _moments(state), state, step
    (lg, pg, mg, sg, step), (le, pe, me, _, _) = runs[True], runs[False]
    assert isinstance(step, tasks.GraphedStep) and not step.graphs
    assert not sg.optimizer.capturable
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert pg.keys() == pe.keys() and all(torch.equal(pg[k], pe[k]) for k in pg)
    assert len(mg) == len(me) and all(torch.equal(a, b) for a, b in zip(mg, me))


def test_the_lr_tensor_takes_the_schedules_float32_values():
    """A capturable Adam's LR tensor after ``write_lr`` holds
    ``schedule(count)`` bit for bit, as the param groups of one that is not
    do, for counts 0 to 50 over a staircase that steps every 3 updates."""
    cfg = OptimConfig(lr_start=1e-2, lr_end=1e-4, epochs=7, steps_per_epoch=3)
    schedule = build_schedule(cfg)
    tensor_lr = ScheduledOptimizer(torch.optim.Adam([torch.zeros(2, requires_grad=True)]),
                                   schedule)
    tensor_lr.make_capturable(torch.device("cpu"))
    float_lr = ScheduledOptimizer(torch.optim.Adam([torch.zeros(2, requires_grad=True)]),
                                  schedule)
    assert tensor_lr.optimizer.param_groups[0]["lr"] is tensor_lr.lr
    seen = set()
    for count in range(51):
        tensor_lr.count = float_lr.count = count
        tensor_lr.write_lr()
        float_lr.write_lr()
        want = np.float32(schedule(count))
        assert tensor_lr.lr.dtype == torch.float32
        assert tensor_lr.lr.numpy().tobytes() == want.tobytes(), count
        assert np.float32(float_lr.optimizer.param_groups[0]["lr"]).tobytes() == want.tobytes()
        seen.add(want.item())
    assert len(seen) == 17  # the staircase moved


def test_make_capturable_refuses_another_optimizer():
    opt = ScheduledOptimizer(torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1),
                             lambda c: 0.1)
    with pytest.raises(TypeError):
        opt.make_capturable(torch.device("cpu"))
    assert not opt.capturable


def test_spans_while_capturing_record_no_device_events(monkeypatch):
    """With a capture in progress a span still records its host times and
    no device events, ``backward_span`` brackets as before, and
    ``snapshot()`` returns without a synchronise."""
    profiling.snapshot()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    a = torch.ones(3, requires_grad=True)
    with _profile():
        with profiling.span("task.graph_capture"):
            with profiling.span("render.forward", a):
                x, close = profiling.backward_span("render.backward", a)
                close(x * 2.0).sum().backward()
        inside = profiling.snapshot()
    snap = profiling.snapshot()
    names = [s["name"] for s in snap["spans"]]
    assert names == ["task.graph_capture", "render.forward", "render.backward"]
    assert [s["name"] for s in inside["spans"]] == names
    assert all(s["device_ms"] is None and s["host_ms"] is not None for s in snap["spans"])
    assert torch.equal(a.grad, torch.full((3,), 2.0))


def _stub_graph(names=("loss", "mse_loss")):
    """A ``_Graph`` whose replay, as a graph's does, overwrites its output
    in place (with one more than before)."""
    out = torch.zeros(len(names))
    return tasks._Graph(types.SimpleNamespace(replay=lambda: out.add_(1.0)),
                        (torch.zeros(2),), out, names, (), [])


def test_replayed_metrics_are_copies():
    """Two consecutive replays return metrics that share no storage with
    each other or the graph's output; the batch goes into the graph's
    inputs and each replay is one update of the schedule's count."""
    opt = ScheduledOptimizer(torch.optim.Adam([torch.zeros(2, requires_grad=True)]),
                             lambda c: 0.1)
    state = types.SimpleNamespace(optimizer=opt)
    g = _stub_graph()
    first = tasks.GraphedStep.replay(g, state, (torch.tensor([1.0, 2.0]),))
    second = tasks.GraphedStep.replay(g, state, (torch.tensor([3.0, 4.0]),))
    assert opt.count == 2
    assert torch.equal(g.inputs[0], torch.tensor([3.0, 4.0]))
    assert first["loss"].item() == 1.0 and second["loss"].item() == 2.0
    ptrs = {m.untyped_storage().data_ptr() for m in (first["loss"], second["loss"], g.out)}
    assert len(ptrs) == 3


def test_a_replay_adds_the_launches_its_capture_counted(monkeypatch):
    """What a capture's calls added to the registered counters (a
    function's attribute, a dict's item) is taken back, since a capture
    launches nothing, and each replay adds it, also after a counter was
    reset by assignment; counters that did not grow are left alone."""
    monkeypatch.setattr(graphs, "_COUNTERS", [])

    def wrapper():
        pass

    wrapper.launches = 0
    by_lib = {"a": 0, "b": 0}
    graphs.counter(wrapper, "launches")
    graphs.counter(by_lib, *by_lib)
    before = graphs.launch_counts()
    wrapper.launches += 2  # as a capture's calls count
    by_lib["a"] += 1
    launched = graphs.take_launches(before)
    assert launched == ((wrapper, "launches", 2), (by_lib, "a", 1))
    assert wrapper.launches == 0 and by_lib == {"a": 0, "b": 0}
    opt = ScheduledOptimizer(torch.optim.Adam([torch.zeros(2, requires_grad=True)]),
                             lambda c: 0.1)
    g = _stub_graph()
    g.launched = launched
    state = types.SimpleNamespace(optimizer=opt)
    for _ in range(3):
        tasks.GraphedStep.replay(g, state, (torch.zeros(2),))
    assert wrapper.launches == 6 and by_lib == {"a": 3, "b": 0}
    wrapper.launches = 0
    tasks.GraphedStep.replay(g, state, (torch.zeros(2),))
    assert wrapper.launches == 2 and by_lib == {"a": 4, "b": 0}


def test_the_kernel_wrappers_register_their_launch_counters():
    """The counters the trainers' launch checks read are registered, so a
    replay counts what it launches."""
    registered = {(id(owner), key) for owner, key in graphs._COUNTERS}
    for owner, key in ((siren_bwd.siren_trunk_bwd_cuda, "launches"),
                       (siren_bwd.film_trunk_bwd_cuda, "launches"),
                       (siren_step.passes_forward, "launches"),
                       (siren_step.passes_output, "launches"),
                       (siren_step.siren_step_cuda, "launches"),
                       (siren_step.film_step_cuda, "launches"),
                       (siren_fwd.fused_apply, "launches"),
                       (siren_fwd.fused_film_apply, "launches"),
                       (siren_fwd, "fused_fwd_launches"), (siren_fwd, "tile_fwd_launches"),
                       *((siren_step.pass_launches, k) for k in siren_step.pass_launches)):
        assert (id(owner), key) in registered, (owner, key)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("capturable_first", [True, False], ids=["capturable-then-restore",
                                                                  "restore-then-capturable"])
def test_a_capturable_adams_state_round_trips_through_a_checkpoint(monkeypatch, device,
                                                                   capturable_first):
    """A capturable Adam's state saved in optax's layout and restored into
    a fresh optimizer, made capturable before or after the restore, gives
    its step on the parameter's device (float32) and the same bits over two
    more updates."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _capturable_on_cpu(monkeypatch)
    dev = torch.device(device)
    target = torch.linspace(-1.0, 1.0, 6, device=dev).reshape(2, 3)
    cfg = OptimConfig(lr_start=1e-2, lr_end=1e-3, beta1=0.5, beta2=0.9, epochs=4)

    def built(init):
        leaves = [init.clone().requires_grad_(True), init[0].clone().requires_grad_(True)]
        return leaves, build_optimizer(cfg, leaves, ["a", "b"])

    def update(leaves, opt):
        opt.zero_grad()
        loss = ((leaves[0] - target) ** 2).sum() + (leaves[1] * target[1]).sin().sum()
        loss.backward()
        opt.step()
        return loss.detach()

    leaves, opt = built(torch.zeros(2, 3, device=dev))
    opt.make_capturable(dev)
    for _ in range(2):
        update(leaves, opt)
    flat = checkpoint.opt_state_arrays(opt)
    again, restored = built(leaves[0].detach())
    with torch.no_grad():
        again[1].copy_(leaves[1])
    if capturable_first:
        restored.make_capturable(dev)
    checkpoint.set_opt_state(restored, flat)
    if not capturable_first:
        restored.make_capturable(dev)
    for p in again:
        step = restored.optimizer.state[p]["step"]
        assert step.device == p.device and step.dtype == torch.float32 and step.item() == 2.0
    saved = checkpoint.opt_state_arrays(restored)
    assert saved.keys() == flat.keys()
    assert all(np.array_equal(saved[k], flat[k]) for k in flat)
    for _ in range(2):
        assert torch.equal(update(leaves, opt), update(again, restored))
    assert all(torch.equal(a, b) for a, b in zip(leaves, again))
    for p, q in zip(leaves, again):
        assert all(torch.equal(opt.optimizer.state[p][k], restored.optimizer.state[q][k])
                   for k in ("step", "exp_avg", "exp_avg_sq"))


def _stub_step(monkeypatch):
    monkeypatch.setattr(reni_mod, "_noted_paths", set())
    calls = []

    def eager(state, batch):
        calls.append(batch)
        return state, {"loss": torch.zeros(())}

    opt = ScheduledOptimizer(torch.optim.Adam([torch.zeros(2, requires_grad=True)]),
                             lambda c: 0.1)
    state = types.SimpleNamespace(optimizer=opt, trainable={}, frozen={})
    return tasks.GraphedStep(eager, body=None), state, calls


def test_a_mesh_falls_back_to_the_eager_step_with_one_line(monkeypatch, capsys):
    step, state, calls = _stub_step(monkeypatch)
    monkeypatch.setattr(tasks, "active_view", lambda: object())
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    batch = (torch.zeros(2),)
    for _ in range(3):
        step(state, batch)
    monkeypatch.undo()
    lines = [ln for ln in capsys.readouterr().err.splitlines() if "FIT_INVERSE" in ln]
    assert len(calls) == 3 and not step.graphs and not state.optimizer.capturable
    assert lines == ["[reni_tpu] the FIT_INVERSE step runs eagerly: a mesh is active"]


def test_a_failed_capture_falls_back_to_the_eager_step_with_one_line(monkeypatch, capsys):
    step, state, calls = _stub_step(monkeypatch)
    monkeypatch.setattr(step, "why_eager", lambda state, batch: None)

    def capture(state, batch):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step, "capture", capture)
    batch = (torch.zeros(2),)
    for _ in range(4):
        step(state, batch)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if "FIT_INVERSE" in ln]
    assert len(calls) == 4
    assert list(step.graphs.values()) == [tasks._EAGER]
    assert len(lines) == 1 and "capture raised RuntimeError: operation not permitted" in lines[0]


def test_a_new_state_starts_its_key_again(monkeypatch):
    """A graph holds the state's tensors: a call with another state runs
    the eager step again (the first of its key) and captures anew."""
    step, state, calls = _stub_step(monkeypatch)
    monkeypatch.setattr(step, "why_eager", lambda state, batch: None)
    captured = []

    def capture(st, batch):
        g = _stub_graph()
        g.anchors = step.anchors(st)
        captured.append(g)
        return g

    monkeypatch.setattr(step, "capture", capture)
    batch = (torch.zeros(2),)
    for _ in range(3):
        step(state, batch)
    assert len(calls) == 1 and len(captured) == 1
    _, other, _ = _stub_step(monkeypatch)
    step(other, batch)
    assert len(calls) == 2 and len(captured) == 1
    step(other, batch)
    assert len(captured) == 2


def test_run_stage_reuses_its_uploads_and_reads_back_each_dtype_once(monkeypatch):
    """A runner call reuses the previous call's index and mask on the
    device where ``make_batches`` gives the same arrays and uploads them
    where it does not; its epoch means come back in each metric's dtype,
    one copy to the host a dtype."""
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: copies.append(t.dtype) or cpu(t))
    seen = []

    def step(state, batch):
        images, idx, bmask = batch
        seen.append((idx, bmask))
        mean = (images.sum() * bmask.sum()).double()
        return state, {"a": mean.float(), "n": idx.sum().double(), "b": mean * 2}

    images = torch.arange(5 * 4 * 3, dtype=torch.float32).reshape(5, 4, 3)
    _, first = tasks.run_stage(step, None, images, 2, 2)
    _, again = tasks.run_stage(step, None, images, 2, 2)
    assert list(first) == ["a", "n", "b"] and sorted(map(str, copies)) == sorted(
        map(str, [torch.float32, torch.float64] * 2))
    # views of the same uploaded tensors, not uploaded again
    assert all(x._base is not None and x._base is y._base for x, y in zip(seen[0], seen[6]))
    assert first["a"].dtype == np.float32 and first["b"].dtype == np.float64
    for k in first:
        assert first[k].shape == (2,) and np.array_equal(first[k], again[k])
    want = np.mean([float(images[[0, 1]].sum()) * 2, float(images[[2, 3]].sum()) * 2,
                    float(images[[4, 0]].sum())])  # the tail batch masks its pad row
    np.testing.assert_allclose(first["b"], 2 * want, rtol=1e-12)
    tasks.run_stage(step, None, images, 1, 3)
    assert seen[-1][0].shape == (3,) and seen[-1][0]._base is not seen[0][0]._base


def _spans_with_replays(replayed: list[bool]):
    with _profile():
        for r in replayed:
            with profiling.span("task.step"):
                if r:
                    with profiling.span("task.graph_replay"):
                        pass
                else:
                    with profiling.span("model.step"):
                        pass


@pytest.mark.parametrize("replayed,expected", [([True] * 4, 100.0), ([False, True, True, True],
                                                                      75.0), ([False] * 2, None)],
                         ids=["all", "three-of-four", "none"])
def test_graph_replay_pct_reads_the_replayed_share(replayed, expected):
    """The share of steps that replayed; None where none did (a program
    without a graphed step)."""
    profiling.snapshot()
    _spans_with_replays(replayed)
    got = harness.read_metric("graph_replay_pct.fit_inverse", {"task": "fit_inverse"})
    assert got == (None if expected is None else pytest.approx(expected))
    assert harness.read_metric("graph_replay_pct.fit_inverse", {"task": "fit_decoder"}) is None


def test_graph_replay_pct_is_none_without_steps():
    profiling.snapshot()
    with _profile():
        with profiling.span("task.call"):
            pass
    assert harness.read_metric("graph_replay_pct.fit_inverse", {"task": "fit_inverse"}) is None


# ---------------------------------------------------------------------------
# on the card: graph replays against eager steps at the benchmark's shapes
# ---------------------------------------------------------------------------

CELL_MAPS, CELL_RES, CELL_RENDER = 3, (64, 128), 128
OBJECT = "data/3D_Models/teapot.obj"
MINMAX = (-18.0536, 11.4633)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cell(device, seed: int = 0):
    """The benchmark's FIT_INVERSE cell at a seeded 5 x 256 Cond-by-Concat
    decoder: (model, params, setup, gt renders (S, 128, 128, 3) at 64x128
    maps, unnormalise)."""
    from reni_tpu_torch.data.transforms import UnMinMaxNormalise

    model = RENIModel(RENIConfig(model_type="VariationalAutoDecoder", equivariance="SO2",
                                 latent_dim=49, hidden_layers=5, hidden_features=256,
                                 output_activation="tanh", last_layer_linear=True,
                                 fixed_decoder=True, use_pallas=True, pallas_trunk="bfloat16",
                                 fast_sine=True))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(torch.Generator().manual_seed(seed), CELL_MAPS, device=device)
    params["latents"]["mu"] = 0.3 * torch.randn(params["latents"]["mu"].shape, generator=gen,
                                                device=device)
    setup = inverse.InverseRenderSetup(OBJECT, render_resolution=CELL_RENDER, kd=0.5,
                                       device=device)
    unnormalise = UnMinMaxNormalise(MINMAX)
    h, w = CELL_RES
    maps = torch.empty((CELL_MAPS, h * w, 3), device=device).uniform_(-0.2, 0.6, generator=gen)
    gt = setup.generate_gt_renders(maps, unnormalise, w)
    return model, params, setup, gt, unnormalise


def _state(model, params):
    return tasks.init_train_state(model, params, OptimConfig(
        lr_start=1e-2, lr_end=1e-4, beta1=0.0, beta2=0.9, epochs=2400, steps_per_epoch=1),
        torch.Generator().manual_seed(1))


def _step(model, setup, unnormalise, width, device, render=None):
    return tasks.make_fit_inverse_step(
        model, sphere.get_directions(width, device=device),
        sphere.get_sineweight(width, device=device), render or setup.render_fn(width),
        unnormalise, alpha=1e-7, beta=1e-3)


def _run(step, state, batches) -> list:
    """Each batch's metrics, stacked, on the host."""
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append(torch.stack([m[k] for k in sorted(m)]))
    return [t.cpu() for t in out]


def _bits(state) -> list:
    opt = state.optimizer.optimizer
    leaves = [p.detach() for _, p in tree_items(state.trainable)]
    return [t.cpu() for t in leaves] + [t.cpu() for p in leaves for t in opt.state[p].values()]


def _twins(cuda, batches_at: dict):
    """The graphed and the eager step (its Adam made capturable, as the
    graphed step's first call makes its own) from the same seed, each at
    every width of ``batches_at`` ({width: [batches]}) in turn, sharing each
    width's render: (metrics, state bits, graphed steps) of both."""
    model, params, setup, gt, unnormalise = _cell(cuda)
    out = {}
    for graph in (True, False):
        state = _state(model, params)
        if not graph:
            state.optimizer.make_capturable(cuda)
        metrics, steps = [], []
        for width, batches in batches_at.items():
            step = _step(model, setup, unnormalise, width, cuda, render=setup.render_fn(width))
            metrics += _run(step if graph else step.eager, state, batches(gt))
            steps.append(step)
        out[graph] = metrics, _bits(state), steps
    return out


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.numpy().view(np.uint8), y.numpy().view(np.uint8))
        for x, y in zip(a, b))


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_bit_for_bit(cuda):
    """24 steps at the cell's shapes: the graph's replays give the eager
    steps' losses, latents and Adam moments bit for bit; one graph."""
    def full(gt):
        return [(gt, torch.arange(CELL_MAPS, device=cuda),
                 torch.ones(CELL_MAPS, device=cuda))] * 24

    twins = _twins(cuda, {CELL_RES[1]: full})
    (mg, sg, (step,)), (me, se, _) = twins[True], twins[False]
    assert len(step.graphs) == 1 and isinstance(next(iter(step.graphs.values())), tasks._Graph)
    assert all(bool(torch.isfinite(m).all()) for m in mg)
    assert _same_bits(mg, me) and _same_bits(sg, se)


@pytest.mark.cuda
def test_a_ragged_batch_and_a_second_grid_capture_again(cuda):
    """A last batch of two maps (a caller that does not pad) and a second
    direction grid (another stage's resolution) each capture once more, and
    every step still equals the eager step's bits."""
    def ragged(gt):
        idx = torch.arange(CELL_MAPS, device=cuda)
        full = (gt, idx, torch.ones(CELL_MAPS, device=cuda))
        tail = (gt[:2], idx[:2], torch.ones(2, device=cuda))
        return [full] * 4 + [tail] * 3 + [full] * 2 + [tail] * 2

    def coarse(gt):
        return [(gt, torch.arange(CELL_MAPS, device=cuda),
                 torch.ones(CELL_MAPS, device=cuda))] * 4

    twins = _twins(cuda, {CELL_RES[1]: ragged, CELL_RES[1] // 2: coarse})
    (mg, sg, steps), (me, se, _) = twins[True], twins[False]
    assert [len(s.graphs) for s in steps] == [2, 1]
    assert all(isinstance(g, tasks._Graph) for s in steps for g in s.graphs.values())
    assert _same_bits(mg, me) and _same_bits(sg, se)


@pytest.mark.cuda
def test_the_transport_matrix_is_built_once_and_replays_run_no_python(cuda, monkeypatch):
    """T is built once, at the GT renders; of 10 graphed steps only the
    eager first one and the capture run Python through the render."""
    built = []
    make = shading.transport_matrix
    monkeypatch.setattr(shading, "transport_matrix", lambda *a, **k: built.append(1) or make(
        *a, **k))
    model, params, setup, gt, unnormalise = _cell(cuda)
    render = setup.render_fn(CELL_RES[1])
    through = []

    def counted(*a, **k):
        through.append(1)
        return render(*a, **k)

    step = _step(model, setup, unnormalise, CELL_RES[1], cuda, render=counted)
    batch = (gt, torch.arange(CELL_MAPS, device=cuda), torch.ones(CELL_MAPS, device=cuda))
    _run(step, _state(model, params), [batch] * 10)
    assert len(built) == 1 and len(through) == 2


@pytest.mark.cuda
def test_a_profiled_replay_times_its_spans(cuda):
    """In a profiler session each replay records the spans its capture
    opened (the render's and the decoder's), timed on the card, under its
    ``task.graph_replay`` span, whose device time holds theirs; the
    benchmark's readers find them."""
    model, params, setup, gt, unnormalise = _cell(cuda)
    step = _step(model, setup, unnormalise, CELL_RES[1], cuda)
    state = _state(model, params)
    batch = (gt, torch.arange(CELL_MAPS, device=cuda), torch.ones(CELL_MAPS, device=cuda))
    _run(step, state, [batch] * 3)
    profiling.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        tasks.run_stage(step, state, gt, 4, CELL_MAPS)
    snap = profiling.snapshot()["spans"]
    replays = [i for i, s in enumerate(snap) if s["name"] == "task.graph_replay"]
    assert len(replays) == 4
    for name in ("render.forward", "render.backward", "kernels.trunk_fwd", "kernels.trunk_bwd"):
        found = [s for s in snap if s["name"] == name]
        assert len(found) == 4, name
        for s in found:
            assert s["parent"] in replays and 0 < s["device_ms"] < snap[s["parent"]]["device_ms"]
    trace = {"task": "fit_inverse"}
    assert harness.read_metric("graph_replay_pct.fit_inverse", trace) == 100.0
    for metric in ("render_device_ms", "decoder_device_ms"):
        assert harness.read_metric(metric, trace) > 0, metric


@pytest.mark.cuda
def test_replays_count_the_launches_of_eager_steps(cuda):
    """Over 10 graphed steps the decoder's wrappers count what 10 eager
    steps count: a forward as the fwd passes and a backward a step, two
    calls into the pass entry, no forward kernel."""
    model, params, setup, gt, unnormalise = _cell(cuda)
    batch = (gt, torch.arange(CELL_MAPS, device=cuda), torch.ones(CELL_MAPS, device=cuda))
    counted = {}
    for graph in (True, False):
        step = _step(model, setup, unnormalise, CELL_RES[1], cuda)
        state = _state(model, params)
        if not graph:
            state.optimizer.make_capturable(cuda)
        before = graphs.launch_counts()
        _run(step if graph else step.eager, state, [batch] * 10)
        counted[graph] = {(id(owner), key): now - was for (owner, key), was, now
                          in zip(graphs._COUNTERS, before, graphs.launch_counts()) if now != was}
    assert counted[True] == counted[False]
    want = {(id(siren_step.passes_forward), "launches"): 10,
            (id(siren_bwd.siren_trunk_bwd_cuda), "launches"): 10,
            (id(siren_step.pass_launches), "siren_step"): 20}
    assert {k: counted[True].get(k) for k in want} == want
    assert (id(siren_fwd.fused_apply), "launches") not in counted[True]


@pytest.mark.cuda
def test_replays_after_a_profiler_session_ends_keep_their_bits(cuda):
    """A profiled replay points the graph's event records at the session's
    events and back at its own: after the session is replaced (its events
    destroyed) untraced replays and a second session's replays give the
    eager steps' bits, and the second session times its spans."""
    model, params, setup, gt, unnormalise = _cell(cuda)
    out = {}
    for graph in (True, False):
        step = _step(model, setup, unnormalise, CELL_RES[1], cuda)
        state = _state(model, params)
        if not graph:
            state.optimizer.make_capturable(cuda)
        means = []
        for profiled in (False, True, False, True, False):
            profiling.snapshot()
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext()):
                state, m = tasks.run_stage(step if graph else step.eager, state, gt, 3,
                                           CELL_MAPS)
            spans = profiling.snapshot()["spans"]
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                pass  # a new session: the old one and its events go
            profiling.snapshot()
            gc.collect()
            means.append(np.stack([m[k] for k in sorted(m)]))
            if graph and profiled:
                timed = [s for s in spans if s["name"] == "render.forward"]
                assert len(timed) == 3 and all(s["device_ms"] > 0 for s in timed)
        out[graph] = means, _bits(state)
    (mg, sg), (me, se) = out[True], out[False]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(mg, me))
    assert _same_bits(sg, se)
