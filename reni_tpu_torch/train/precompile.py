"""Background builds of the native libraries later stages and tasks load
(counterpart of ``reni_tpu/train/precompile.py``, ``TPU.PRECOMPILE``).

The JAX package compiles each later curriculum stage's whole-stage XLA
program in daemon threads while the current stage trains. The port has no
such programs: its one compile step is the build of a native library at its
first use, ``nvcc`` for the CUDA kernels (``kernels/_build.build``, minutes
for a cold step library) and ``g++`` for the rasterizer and the EXR decoder.
So the precompiler builds, in daemon threads, the libraries the current
task's stages and the chain's later tasks will load: FIT_INVERSE's
rasterizer and the forward and backward kernels while FIT_DECODER trains,
``film_step`` for a FiLM chain, the EXR decoder for ``STREAM_FROM_DISK``.

Correctness never depends on it: a library that is built is the same file
whichever thread built it (``_build`` builds one name at a time, into a
temporary file of its thread, and renames it into place), the real first
use finds it built or builds it inline, and a background failure is logged
and reported, never raised; the inline build then raises with the
compiler's output, as without the precompiler.

A daemon thread (not ``ThreadPoolExecutor``) on purpose, as in JAX: an
executor joins its workers at interpreter exit, so a build stuck in the
compiler would block the exit the hang watchdog (``RENI_TPU_HANG_EXIT_S``)
exists to make.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Callable, NamedTuple

_LOG = logging.getLogger("reni_tpu_torch.precompile")


class Build(NamedTuple):
    """One library: its name, where it builds to, and its build function."""

    name: str
    path: Callable[[], Path]
    build: Callable[[], object]


class Precompiler:
    """Fire-and-forget builds: each ``launch`` starts one daemon thread
    that builds its libraries in order. ``report()`` says what was built,
    what was already built and what failed."""

    def __init__(self):
        self._seen: set[str] = set()
        self._done: list[tuple[str, str]] = []  # (outcome, name), appended by the threads
        self._threads: list[threading.Thread] = []

    def launch(self, builds: list[Build]) -> int:
        """Build, in a new daemon thread, each of ``builds`` not launched
        before; returns how many that is."""
        todo = [b for b in builds if b.name not in self._seen]
        self._seen.update(b.name for b in todo)
        if todo:
            t = threading.Thread(target=self._run, args=(todo,), daemon=True,
                                 name="reni-precompile")
            t.start()
            self._threads.append(t)
        return len(todo)

    def _run(self, builds: list[Build]) -> None:
        for item in builds:
            try:
                present = item.path().exists()
                item.build()
                outcome = "present" if present else "built"
            except Exception as e:  # noqa: BLE001 - never fail training
                outcome = "failed"
                _LOG.warning("background build of %s failed: %s", item.name, e)
            self._done.append((outcome, item.name))

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait for every launched build (tests and reports; training never
        waits); returns whether all ended."""
        for t in self._threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self._threads)

    def report(self) -> dict[str, list[str]]:
        return {k: sorted(n for o, n in list(self._done) if o == k)
                for k in ("built", "present", "failed")}


def _kernel(name: str) -> Build:
    from reni_tpu_torch.kernels import _build

    return Build(name, lambda: _build.library_path(name), lambda: _build.build(name))


def _rasterizer() -> Build:
    from reni_tpu_torch.render import rasterizer

    return Build("rasterizer", rasterizer.library_path, rasterizer.build)


def _exr_decode() -> Build:
    from reni_tpu_torch.data import exr

    return Build("exr_decode", exr.library_path, exr.build)


def task_builds(model_config, task: str, device, *, from_disk: bool = False) -> list[Build]:
    """The libraries a task loads: with ``use_pallas`` on the card the step
    kernel of its conditioning and the forward kernel (FIT_DECODER's grids),
    for FIT_LATENT and FIT_INVERSE also the backward (their decodes take the
    forward passes of the step library), and the tiled passes of the trunk
    where ``siren_step.pass_design`` routes it there; FIT_INVERSE's
    rasterizer; the EXR decoder when rows decode from disk. On the CPU the
    kernels' wrappers take their plain versions, so only the g++ libraries
    load there."""
    import torch

    from reni_tpu_torch.kernels import siren_step

    out = []
    if model_config.use_pallas and torch.device(device).type == "cuda":
        out.append(_kernel("film_step" if model_config.is_film else "siren_step"))
        trunk, film = model_config.pallas_trunk, model_config.is_film
        n_mm = model_config.hidden_layers - film
        if siren_step.pass_design(trunk, model_config.hidden_features, n_mm) == "tiled":
            out.append(_kernel(siren_step.tiled_source(film, trunk)))
        out.append(_kernel("siren_fwd"))
        if task != "FIT_DECODER":
            out.append(_kernel("siren_bwd"))
    if task == "FIT_INVERSE":
        out.append(_rasterizer())
    if from_disk:
        out.append(_exr_decode())
    return out


_DEFAULT: list[Precompiler] = []


def default_pool() -> Precompiler:
    """The process's precompiler (``fit_task(precompile=True)``)."""
    if not _DEFAULT:
        _DEFAULT.append(Precompiler())
    return _DEFAULT[0]
