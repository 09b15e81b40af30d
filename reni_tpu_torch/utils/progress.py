"""The trainer's last sign of progress, which the hang watchdog of
``cli/run.py`` (``RENI_TPU_HANG_EXIT_S``) reads: the task set-up, each
callback segment, the waits for the chip lock and every build of a native
library note it. A first ``nvcc`` build is a long, silent step inside a
task's first call; noting it before and after keeps a watchdog shorter than
a cold build from firing on a healthy run."""

from __future__ import annotations

import time

PROGRESS = {"ts": time.time(), "what": "startup"}


def note(what: str) -> None:
    PROGRESS["ts"] = time.time()
    PROGRESS["what"] = what


def idle_s() -> float:
    """Seconds since the last note."""
    return time.time() - PROGRESS["ts"]
