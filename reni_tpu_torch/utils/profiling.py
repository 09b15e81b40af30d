"""Tracing (counterpart of ``reni_tpu/utils/profiling.py::trace``): the
port's spans and the operator's trace.

``span(name, on=None)`` marks one layer boundary of the port (PERF.md
section 3: ``task.*`` in the task driver, ``model.step``, ``render.*``,
``kernels.*``, ``mesh.reduce``). A span records only while a
``torch.profiler`` session is active: ``trace`` below, ``cli/run.py
--profile``, a benchmark's traced run. Otherwise it returns one shared
no-op context, and costs one flag read. While a session is on, a span

- enters ``torch.profiler.record_function(name)``, so that it shows in the
  Chrome trace on the timeline of the kernels and copies it launched;
- keeps a record in memory: its name, its parent (the innermost span open
  on its thread; on a thread with none open, such as autograd's device
  thread, the span opened last on any other), its thread, and its host
  start and end in Unix-epoch nanoseconds, the profiler's clock (an
  event's ``time_range`` is microseconds after
  ``prof.profiler.kineto_results.trace_start_ns()``);
- with a CUDA tensor ``on``, records a pair of timing events on the
  current stream of that tensor's device around it.

``snapshot()`` synchronises once and returns the record of the latest
session: each span's host ms, device ms, and device start and end in ms
after the session's first event on its device. A session's record runs
from its first span to the first ``snapshot()`` taken after it ended.

``backward_span(name, x)`` brackets the backward of a stretch of code:
the span opens when autograd reaches the stretch's output and closes when
it reaches its input ``x``.

While a CUDA graph is captured (``torch.cuda.is_current_stream_capturing()``)
a span records no device events of its own: the capture runs nothing. Inside
``graph_marks(marks)`` each span with a CUDA tensor ``on`` (a span in a
profiler session or not) records instead a pair of external timing events
into the graph, and ``GraphTimer.replay`` points them at fresh events at
each replay in a session, so that a replay's spans are timed as an eager
step's are (``snapshot`` lists them, closed, under the replay's span). A
``snapshot()`` taken while a capture is in progress does not synchronise
and gives no device times.

``trace(dir)`` records a ``torch.profiler`` trace of the host and, when a
card is present, of the device, and writes it as a Chrome trace
(``dir/reni_tpu_torch.trace.json``; open it in Perfetto or
chrome://tracing) and the spans' snapshot beside it
(``dir/reni_tpu_torch.spans.json``). The JAX package writes a
``jax.profiler`` trace instead. Point it at a short run: the profiler
keeps every event in memory.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_MARKS: list | None = None  # the marks of the CUDA graph being captured (``graph_marks``)


def _capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph (False where
    torch has no CUDA)."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:
        return False


class _Session:
    """The spans of one profiler session, in the order they opened."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.stacks: dict[int, list[int]] = {}
        self.origins: dict[torch.device, torch.cuda.Event] = {}
        self.lock = threading.Lock()


class _Mark:
    """A span opened while a CUDA graph is captured inside ``graph_marks``:
    a pair of external timing events (``torch.cuda.Event(external=True)``)
    that the graph records around the span's work at every replay."""

    __slots__ = ("name", "device", "events")

    def __init__(self, name: str, on: torch.Tensor):
        self.name, self.device = name, on.device
        self.events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                            for _ in range(2))

    def __enter__(self):
        _MARKS.append(self)
        self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        self.events[1].record(torch.cuda.current_stream(self.device))
        return False


class _Span:
    __slots__ = ("name", "on", "session", "index", "parent", "thread", "start_ns", "end_ns",
                 "events", "device", "mark", "_rf")

    def __init__(self, name: str, on: torch.Tensor | None):
        self.name, self.on = name, on
        self.end_ns = self.events = self.device = self.mark = None

    def __enter__(self):
        s = self.session = _RECORDER.current()
        self.thread = threading.get_ident()
        with s.lock:
            stack = s.stacks.setdefault(self.thread, [])
            if stack:
                self.parent = stack[-1]
            else:
                tops = [st[-1] for st in s.stacks.values() if st]
                self.parent = max(tops) if tops else None
            self.index = len(s.spans)
            s.spans.append(self)
            stack.append(self.index)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.on is not None and self.on.is_cuda:
            if _capturing():
                if _MARKS is not None:
                    self.mark = _Mark(self.name, self.on).__enter__()
            else:
                self.device = self.on.device
                stream = torch.cuda.current_stream(self.device)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                if self.device not in s.origins:
                    s.origins[self.device] = self.events[0]
                self.events[0].record(stream)
        self.start_ns = time.time_ns()
        self.on = None
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.mark is not None:
            self.mark.__exit__(*exc)
        self._rf.__exit__(*exc)
        with self.session.lock:
            stack = self.session.stacks[self.thread]
            if self.index in stack:
                stack.remove(self.index)
        return False

    def record(self, origins: dict, timed: bool = True) -> dict:
        done = self.end_ns is not None
        out = {"name": self.name, "parent": self.parent, "thread": self.thread,
               "host_start_ns": self.start_ns, "host_end_ns": self.end_ns,
               "host_ms": (self.end_ns - self.start_ns) / 1e6 if done else None,
               "device_ms": None, "device_start_ms": None, "device_end_ms": None}
        if timed and done and self.events is not None:
            origin = origins[self.device]
            out["device_start_ms"] = origin.elapsed_time(self.events[0])
            out["device_end_ms"] = origin.elapsed_time(self.events[1])
            out["device_ms"] = self.events[0].elapsed_time(self.events[1])
        return out


class _Recorder:
    """The process's latest session (the profiler is one per process too)."""

    def __init__(self):
        self.session = _Session()
        self.ended = False
        self.taken: dict | None = None

    def current(self) -> _Session:
        if self.ended:
            self.session, self.ended, self.taken = _Session(), False, None
        return self.session

    def snapshot(self) -> dict:
        if self.taken is not None:
            return self.taken
        s = self.session
        if _capturing():  # no synchronise inside a capture, so no device times
            return {"spans": [sp.record(s.origins, timed=False) for sp in list(s.spans)]}
        for dev in s.origins:
            torch.cuda.synchronize(dev)
        out = {"spans": [sp.record(s.origins) for sp in list(s.spans)]}
        if not _profiler._is_profiler_enabled:
            self.ended, self.taken = True, out
        return out

    def end(self) -> None:
        self.ended, self.taken = True, None


_RECORDER = _Recorder()


def span(name: str, on: torch.Tensor | None = None):
    """``with span('layer.part', t): ...``: a span while a profiler session
    is active (device times on ``t``'s stream when ``t`` is a CUDA tensor),
    a graph's mark while one is captured inside ``graph_marks``, else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _OFF if torch.compiler.is_compiling() else _Span(name, on)
    if _MARKS is not None and on is not None and on.is_cuda and _capturing():
        return _Mark(name, on)
    return _OFF


class _Bracket(torch.autograd.Function):
    """The identity, whose backward enters (``opens``) or exits ``mark``."""

    @staticmethod
    def forward(ctx, x, mark, opens):
        ctx.mark, ctx.opens = mark, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            ctx.mark.__enter__()
        else:
            ctx.mark.__exit__(None, None, None)
        return g, None, None


def _same(y):
    return y


def backward_span(name: str, x: torch.Tensor):
    """(x', close). While spans are on and ``x`` needs a gradient, ``x'`` is
    ``x`` through an identity whose backward closes the span ``name`` and
    ``close(y)`` passes ``y`` through one whose backward opens it: the span
    covers the backward of the code from ``x'`` to ``y``. Otherwise ``x``
    itself and a ``close`` that returns its argument."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x, _same
    mark = span(name, x)
    if mark is _OFF:
        return x, _same
    return _Bracket.apply(x, mark, False), lambda y: _Bracket.apply(y, mark, True)


@contextlib.contextmanager
def graph_marks(marks: list):
    """Collect into ``marks`` the spans with a CUDA tensor that open while a
    CUDA graph is captured in the block: each records a pair of external
    timing events into the graph (``GraphTimer`` times a replay by them)."""
    global _MARKS
    outer, _MARKS = _MARKS, marks
    try:
        yield marks
    finally:
        _MARKS = outer


_EVENT_RECORD_NODE = 7  # cuda.h CU_GRAPH_NODE_TYPE_EVENT_RECORD


@functools.cache
def _driver():
    """The CUDA driver library (ctypes) with the graph calls' signatures."""
    cu = ctypes.CDLL("libcuda.so.1")
    P, PP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    for fn, args in (("cuGraphGetNodes", [P, PP, ctypes.POINTER(ctypes.c_size_t)]),
                     ("cuGraphNodeGetType", [P, ctypes.POINTER(ctypes.c_int)]),
                     ("cuGraphEventRecordNodeGetEvent", [P, PP]),
                     ("cuGraphExecEventRecordNodeSetEvent", [P, P, P])):
        getattr(cu, fn).argtypes, getattr(cu, fn).restype = args, ctypes.c_int
    return cu


def _cu_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def _event_handle(event: torch.cuda.Event) -> int:
    return event._as_parameter_.value


def _event_nodes(graph, marks: list) -> list | None:
    """Each mark's two event-record nodes in ``graph`` (a CUDAGraph made
    with ``keep_graph=True``), or None where it has no marks or the graph
    lacks a mark's node."""
    if not marks:
        return None
    cu = _driver()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    by_event = {}
    for node in nodes:
        kind, event = ctypes.c_int(), ctypes.c_void_p()
        _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == _EVENT_RECORD_NODE:
            _cu_check(cu.cuGraphEventRecordNodeGetEvent(node, ctypes.byref(event)),
                      "cuGraphEventRecordNodeGetEvent")
            by_event[event.value] = node
    try:
        return [tuple(by_event[_event_handle(e)] for e in m.events) for m in marks]
    except KeyError:
        return None


class GraphTimer:
    """Replays a captured CUDA graph; in a profiler session, times the
    spans it captured (``graph_marks``'s marks): before the replay each
    mark's event-record nodes are pointed at a fresh pair of timing events
    (``cuGraphExecEventRecordNodeSetEvent``), and after it each mark is
    recorded as a closed span of the session with those events, under the
    span open around the replay, and the nodes are pointed back at the
    mark's own events, which live as long as the graph (the session's
    events die with it, and a later replay must not record into them).
    ``graph`` is a ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``
    and instantiated. Where the driver does not give the nodes, the marks
    record no spans."""

    def __init__(self, graph, marks: list):
        self.graph, self.marks = graph, marks
        try:
            self.nodes = _event_nodes(graph, marks)
        except (OSError, RuntimeError):  # no driver library, or a call refused
            self.nodes = None

    def replay(self) -> None:
        if self.nodes is None or not _profiler._is_profiler_enabled:
            self.graph.replay()
            return
        pairs = []
        for mark in self.marks:
            stream = torch.cuda.current_stream(mark.device)
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for event in pair:
                event.record(stream)  # creates the event, which the replay records again
            pairs.append(pair)
        self._point(pairs)
        try:
            self.graph.replay()
        finally:
            # a launch in flight keeps the events it was given
            self._point([m.events for m in self.marks])
        for mark, pair in zip(self.marks, pairs):
            sp = _Span(mark.name, None)
            sp.__enter__()
            sp.__exit__(None, None, None)
            sp.events, sp.device = pair, mark.device
            sp.session.origins.setdefault(mark.device, pair[0])

    def _point(self, pairs: list) -> None:
        """Point each mark's two event-record nodes at ``pairs``' events."""
        cu, exe = _driver(), ctypes.c_void_p(self.graph.raw_cuda_graph_exec())
        for pair, nodes in zip(pairs, self.nodes):
            for event, node in zip(pair, nodes):
                _cu_check(cu.cuGraphExecEventRecordNodeSetEvent(
                    exe, node, ctypes.c_void_p(_event_handle(event))),
                    "cuGraphExecEventRecordNodeSetEvent")


def snapshot() -> dict:
    """``{"spans": [...]}`` of the latest profiler session, one dict a span
    in the order they opened: ``name``, ``parent`` (an index into the list,
    or None), ``thread``, ``host_start_ns`` / ``host_end_ns`` (Unix epoch,
    the profiler's clock), ``host_ms``, and for a span with device events
    ``device_ms``, ``device_start_ms`` / ``device_end_ms`` (after the
    session's first event on that device; None without events). A span
    still open has no end. Synchronises each device the spans timed."""
    return _RECORDER.snapshot()


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('dir'): ...`` then open ``dir/reni_tpu_torch.trace.json``;
    the spans' snapshot is ``dir/reni_tpu_torch.spans.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    _RECORDER.end()
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "reni_tpu_torch.trace.json"))
        with open(os.path.join(log_dir, "reni_tpu_torch.spans.json"), "w") as f:
            json.dump(snapshot(), f)
