"""Tracing (counterpart of ``reni_tpu/utils/profiling.py::trace``).

``trace(dir)`` records a ``torch.profiler`` trace of the host and, when a
card is present, of the device, and writes it as a Chrome trace
(``dir/reni_tpu_torch.trace.json``; open it in Perfetto or
chrome://tracing). The JAX package writes a ``jax.profiler`` trace instead.
Point it at a short run: the profiler keeps every event in memory.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('dir'): ...`` then open ``dir/reni_tpu_torch.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "reni_tpu_torch.trace.json"))
