"""The port's spans (``reni_tpu_torch/utils/profiling.py``) on the CPU: off
outside a profiler session, nested on the profiler's clock inside one, at
the layer boundaries of a FIT_DECODER and a FIT_INVERSE step (whose
numbers they leave bit for bit alone), written by ``trace(dir)``, and read
by the benchmark's six span metrics (``portbench/metrics``)."""

import contextlib
import json
import threading

import pytest
import torch

from portbench import harness
from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.params import tree_items
from reni_tpu_torch.render import inverse
from reni_tpu_torch.render import mesh as mesh_lib
from reni_tpu_torch.train import tasks
from reni_tpu_torch.train.optim import OptimConfig
from reni_tpu_torch.utils import profiling

WIDTH = 16  # 8 x 16 directions
MAPS = 3
BATCH = 2  # two steps an epoch, FIT_DECODER's second one padded
INVERSE_MAPS = 4  # unpadded: a padded row's cosine term has a NaN gradient


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _names(snap) -> list:
    return [s["name"] for s in snap["spans"]]


def _ancestors(snap, i) -> list:
    out, p = [], snap["spans"][i]["parent"]
    while p is not None:
        out.append(snap["spans"][p]["name"])
        p = snap["spans"][p]["parent"]
    return out


def _under(snap, name, outer) -> bool:
    """Every span ``name`` lies inside a span ``outer``, and there is one."""
    found = [i for i, n in enumerate(_names(snap)) if n == name]
    return bool(found) and all(outer in _ancestors(snap, i) for i in found)


def test_off_outside_a_session_records_nothing():
    profiling.snapshot()  # ends any session an earlier test left
    kept = len(profiling._RECORDER.session.spans)
    a = torch.ones(3, requires_grad=True)
    first, second = profiling.span("task.step", a), profiling.span("kernels.step")
    assert first is second is profiling._OFF
    with first:
        x, close = profiling.backward_span("render.backward", a)
    assert x is a and close(a) is a
    assert len(profiling._RECORDER.session.spans) == kept


def test_nested_spans_on_the_profilers_clock():
    """Parents nest, a span on another thread with none open there takes
    the span opened last, and a span around a torch.mm contains the op's
    interval on the profiler's clock to 50 us."""
    a = torch.randn(256, 256)
    with _profile() as prof:
        with profiling.span("task.call"):
            with profiling.span("task.step"):
                b = a @ a
            worker = threading.Thread(target=lambda: profiling.span("task.readback").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    snap = profiling.snapshot()
    assert _names(snap) == ["task.call", "task.step", "task.readback"]
    assert [s["parent"] for s in snap["spans"]] == [None, 0, 0]
    assert snap["spans"][2]["thread"] != snap["spans"][0]["thread"]
    assert all(s["host_ms"] > 0 and s["device_ms"] is None for s in snap["spans"])
    start = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 1
    step = snap["spans"][1]
    assert (step["host_start_ns"] - start) / 1e3 <= mm[0].time_range.start + 50
    assert (step["host_end_ns"] - start) / 1e3 >= mm[0].time_range.end - 50
    assert torch.equal(b, a @ a)
    assert profiling.snapshot() is snap  # a session's record is taken once


def _decoder_state(film: bool, use_pallas: bool):
    cfg = RENIConfig(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
                     hidden_layers=2, hidden_features=32, output_activation=None,
                     conditioning="FiLM" if film else "Cond-by-Concat",
                     last_layer_linear=True, use_pallas=use_pallas)
    model = RENIModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), MAPS, device="cpu")
    state = tasks.init_train_state(model, params, OptimConfig(lr_start=1e-3, lr_end=1e-4,
                                                              epochs=2, steps_per_epoch=2),
                                   torch.Generator().manual_seed(1))
    step = tasks.make_fit_decoder_step(model, sphere.get_directions(WIDTH, device="cpu"),
                                       sphere.get_sineweight(WIDTH, device="cpu"), kld_weighting=1e-4)
    maps = torch.rand((MAPS, WIDTH * WIDTH // 2, 3), generator=torch.Generator().manual_seed(2))
    return model, state, step, maps


@pytest.mark.parametrize("film,use_pallas", [(False, True), (False, False), (True, True)],
                         ids=["cbc-step", "cbc-autograd", "film-step"])
def test_fit_decoder_spans(film, use_pallas):
    """run_stage: task.call > task.upload, task.step > model.step, then
    task.backward and task.readback; the train-step route's kernels.step and
    kernels.step_bwd, or the autograd route's kernels.trunk_* (use_pallas on
    the CPU takes the kernels' plain versions)."""
    model, state, step, maps = _decoder_state(film, use_pallas)
    with _profile():
        tasks.run_stage(step, state, maps, 1, BATCH)
    snap = profiling.snapshot()
    names = _names(snap)
    assert names.count("task.call") == 1 and names.count("task.step") == 2
    assert names.count("task.upload") == names.count("task.readback") == 1
    assert _under(snap, "task.upload", "task.call") and _under(snap, "task.readback", "task.call")
    assert _under(snap, "task.step", "task.call")
    for name in ("model.step", "task.backward"):
        assert _under(snap, name, "task.step"), name
    if use_pallas:
        kernel = ("kernels.step", "kernels.step_bwd") if model.fused_step_reason(
            BATCH, WIDTH * WIDTH // 2) is None else ("kernels.trunk_fwd", "kernels.trunk_bwd")
        assert _under(snap, kernel[0], "model.step")
        assert _under(snap, kernel[1], "task.backward")
    else:
        assert not [n for n in names if n.startswith("kernels.")]
        assert names.count("model.step") == 2


def _inverse_step():
    cfg = RENIConfig(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
                     hidden_layers=2, hidden_features=32, output_activation=None,
                     last_layer_linear=True, fixed_decoder=True, use_pallas=True)
    model = RENIModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), INVERSE_MAPS, device="cpu")
    params["latents"]["mu"] = torch.randn(params["latents"]["mu"].shape,
                                          generator=torch.Generator().manual_seed(3))
    state = tasks.init_train_state(model, params, OptimConfig(lr_start=1e-2, lr_end=1e-3,
                                                              epochs=2, steps_per_epoch=2),
                                   torch.Generator().manual_seed(1))
    setup = inverse.InverseRenderSetup(mesh_lib.make_uv_sphere(8, 16), render_resolution=16,
                                       kd=0.5, light_chunk=64, device="cpu")
    maps = torch.rand((INVERSE_MAPS, WIDTH * WIDTH // 2, 3),
                      generator=torch.Generator().manual_seed(2))
    gt = setup.generate_gt_renders(maps, lambda x: x, WIDTH)
    step = tasks.make_fit_inverse_step(model, sphere.get_directions(WIDTH, device="cpu"),
                                       sphere.get_sineweight(WIDTH, device="cpu"), setup.render_fn(WIDTH),
                                       lambda x: x, alpha=1e-7, beta=1e-3)
    return state, step, gt


def _inverse_numbers(profiled: bool):
    state, step, gt = _inverse_step()
    with _profile() if profiled else contextlib.nullcontext():
        state, metrics = tasks.run_stage(step, state, gt, 1, BATCH)
    leaves = dict(tree_items(state.trainable))
    return (metrics["loss"], {k: v.detach().clone() for k, v in leaves.items()},
            {k: v.grad.clone() for k, v in leaves.items()})


def test_fit_inverse_spans_leave_the_step_bit_for_bit():
    """render.forward and render.backward lie under task.step, and so do the
    decoder's kernels.trunk_*; loss, latents and gradients with spans on
    equal those with spans off bit for bit."""
    off = _inverse_numbers(False)
    on = _inverse_numbers(True)
    snap = profiling.snapshot()
    for name in ("render.forward", "render.backward", "kernels.trunk_fwd", "kernels.trunk_bwd"):
        assert _under(snap, name, "task.step"), name
    assert _under(snap, "render.backward", "task.backward")
    names = _names(snap)
    assert names.count("render.forward") == names.count("render.backward") == 2
    assert (off[0] == on[0]).all()
    for a, b in zip(off[1:], on[1:]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_trace_writes_the_chrome_trace_and_the_spans(tmp_path):
    model, state, step, maps = _decoder_state(False, True)
    with profiling.trace(str(tmp_path)):
        tasks.run_stage(step, state, maps, 1, BATCH)
    with open(tmp_path / "reni_tpu_torch.trace.json") as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"task.call", "task.step", "model.step", "kernels.step"} <= events
    with open(tmp_path / "reni_tpu_torch.spans.json") as f:
        spans = json.load(f)["spans"]
    assert [s["name"] for s in spans][:2] == ["task.call", "task.upload"]
    assert all(s["host_ms"] > 0 for s in spans)


def _span(name, parent=None, host_ms=1.0, device=None):
    start, end = device or (None, None)
    return {"name": name, "parent": parent, "thread": 1, "host_start_ns": 0,
            "host_end_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": None if device is None else end - start,
            "device_start_ms": start, "device_end_ms": end}


# two steps: the first spans 0-10 ms on the card, the second 12-25 ms
SNAPSHOT = {"spans": [
    _span("task.call", None, 30.0, (0.0, 26.0)),
    _span("task.step", 0, 4.0, (0.0, 10.0)),
    _span("kernels.step", 1, 1.5),
    _span("kernels.trunk_fwd", 2, 0.5, (1.0, 2.0)),  # inside kernels.step: counted once
    _span("render.forward", 1, 1.0, (2.0, 6.0)),
    _span("render.backward", 1, 1.0, (6.0, 8.5)),
    _span("task.step", 0, 6.0, (12.0, 25.0)),
    _span("kernels.step_bwd", 6, 0.5),
    _span("kernels.trunk_bwd", 6, 0.25, (13.0, 13.5)),
    _span("render.forward", 6, 1.0, (14.0, 18.0)),
    _span("task.readback", 0, 2.0),
]}


@pytest.mark.parametrize("metric,task,expected", [
    ("host_step_ms.fit_decoder", "fit_decoder", 5.0),
    ("host_step_ms.fit_inverse", "fit_inverse", 5.0),
    ("launch_host_ms.fit_decoder", "fit_decoder", (1.5 + 0.5 + 0.25) / 2),
    ("driver_gap_pct.fit_decoder", "fit_decoder", 100.0 * 2.0 / 40.0),
    ("render_device_ms", "fit_inverse", (4.0 + 2.5 + 4.0) / 2),
    ("decoder_device_ms", "fit_inverse", (1.0 + 0.5) / 2),
])
def test_span_metrics_read_a_snapshot(monkeypatch, metric, task, expected):
    """Each reader through the harness, on a trace of a 40 ms stretch; None
    for the other task and where the program has no snapshot."""
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    trace = {"task": task, "window_s": 0.04, "busy_s": 0.038, "steps": 2, "least_s": 1e-3}
    assert harness.read_metric(metric, trace) == pytest.approx(expected)
    other = "fit_inverse" if task == "fit_decoder" else "fit_decoder"
    assert harness.read_metric(metric, dict(trace, task=other)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": []})
    assert harness.read_metric(metric, trace) is None
