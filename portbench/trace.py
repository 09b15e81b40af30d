"""What the traced run reads from a ``torch.profiler`` trace of a steady
stretch of the window: the device's busy time, the time by kernel name and
the longest idle gaps with what the host was doing in each.

``busy_intervals`` is a frozen copy of ``chip_smoke.py::busy_share``'s
arithmetic (the union of every kernel's and copy's interval on every
stream), kept here so that the yardstick lives with the benchmark."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import harness

TOP = 10


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals (microseconds), in order."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _host_at(cpu_events, t: float) -> str:
    """The innermost host event (a runtime call, or an operator where the
    host's activity is traced) running at ``t`` (microseconds)."""
    best = None
    for e in cpu_events:
        if e.time_range.start <= t < e.time_range.end:
            if best is None or e.time_range.elapsed_us() < best.time_range.elapsed_us():
                best = e
    return best.name if best is not None else "(host between runtime calls)"


def summarise(prof, window_s: float) -> dict:
    """{busy_s, window_s, device_ops, idle_gaps, kernels} of a trace whose
    stretch lasted ``window_s`` on the host's clock. ``kernels`` is every
    device operation's total seconds by name."""
    from torch.autograd import DeviceType

    work = _device_events(prof)
    merged = busy_intervals(work)
    busy = sum(e - s for s, e in merged) / 1e6
    kernels: dict[str, float] = {}
    for e in work:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    idle = [[_host_at(cpu, start), gap / 1e6] for gap, start in gaps]
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


@contextlib.contextmanager
def traced(out: dict, device):
    """Profile the block; on exit, after a synchronise, ``out`` holds
    ``summarise``'s dict for it. On the card only the CUDA activity is
    recorded (kernels, copies and the runtime calls that launch them): the
    host's operator events cost the enqueue enough to leave the card idle,
    so the host's side of an idle gap is the runtime call it was in."""
    on_card = device.type == "cuda"
    act = torch.profiler.ProfilerActivity
    acts = [act.CUDA if on_card else act.CPU]
    harness.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        harness.synchronize(device)
        window = time.perf_counter() - t0
    out.update(summarise(prof, window))
