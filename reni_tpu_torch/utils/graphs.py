"""What a captured CUDA graph reads, and what its replays launch.

A graph reads its operands at the addresses they had at its capture. The
port's caches (the stacked and packed decoder weights of
``kernels/siren_fwd.py``, the render's transport matrix of
``render/shading.py``) hand out tensors that they may later drop, and a
dropped tensor's memory goes to the next allocation. So each cache passes
what it hands out through ``keep``, and the code that captures a graph
collects those tensors with ``keeping`` and holds them as long as the graph
(``train/tasks.py::GraphedStep``).

The kernel wrappers count their launches in Python (a function's
``.launches``, a module's globals, a dict's items), and a replay runs no
Python. So each wrapper registers its counters with ``counter``; the code
that captures a graph takes ``launch_counts()`` before the capture and
``take_launches(before)`` after it (a capture launches nothing), and adds
that with ``add_launches`` at every replay: a counter then counts a
replay's launches as it counts an eager step's."""

from __future__ import annotations

import contextlib

_KEPT: list | None = None  # the tensors the graph being captured reads from caches
_COUNTERS: list = []  # (owner, key) of every registered launch counter


def keep(value):
    """``value``, held by the capture in progress (``keeping``), if any."""
    if _KEPT is not None:
        _KEPT.append(value)
    return value


@contextlib.contextmanager
def keeping(into: list):
    """Collect into ``into`` what the caches hand out in the block, on any
    thread (autograd runs a capture's backward on its own)."""
    global _KEPT
    outer, _KEPT = _KEPT, into
    try:
        yield into
    finally:
        _KEPT = outer


def counter(owner, *keys: str) -> None:
    """Register launch counters: the attributes ``keys`` of ``owner`` (a
    function's ``launches``, a module's globals), or its items where
    ``owner`` is a dict. The counters are read by name at each use, so a
    caller may reset one by assignment."""
    _COUNTERS.extend((owner, key) for key in keys)


def _read(owner, key: str) -> int:
    return owner[key] if isinstance(owner, dict) else getattr(owner, key)


def launch_counts() -> list:
    """Every registered counter's value, in the order of registration."""
    return [_read(owner, key) for owner, key in _COUNTERS]


def take_launches(before: list) -> tuple:
    """((owner, key, increase), ...) of the counters that grew since
    ``launch_counts()`` gave ``before``, each set back to its value then:
    the calls of a capture launch nothing, its replays do."""
    grew = tuple((owner, key, now - was) for (owner, key), was, now
                 in zip(_COUNTERS, before, launch_counts()) if now != was)
    add_launches(tuple((owner, key, -n) for owner, key, n in grew))
    return grew


def add_launches(increases: tuple) -> None:
    """Add ``take_launches``' increases to their counters."""
    for owner, key, n in increases:
        if isinstance(owner, dict):
            owner[key] += n
        else:
            setattr(owner, key, getattr(owner, key) + n)
