"""Advisory chip arbitration (counterpart of ``reni_tpu/utils/chiplock.py``).

The card is shared by every process on its machine: two jobs that launch
kernels on it at once timeshare it, which wrecks timed runs (``chip_smoke.py``
and the benchmark read contended, not real, numbers) and can exhaust its
memory. Two cooperating pieces arbitrate without a daemon:

- the **chip lock**: an ``fcntl.flock`` on a well-known file. Long-running
  card entry points (``cli.run``, ``cli.evaluate``) hold it for their
  lifetime, so concurrent launches serialize. Advisory and fail-open: a
  holder that never yields is eventually bypassed with a warning rather
  than deadlocking the caller; a dead holder's lock is released by the
  kernel.
- the **stop file**: a preemptor (a timed run that must measure an idle
  card) creates it to ask the current holder to yield. The trainer checks it
  at segment boundaries (agreed by rank 0, at the same loop points as
  ``TRAINER.MAX_RUNTIME``), force-saves a resumable checkpoint, consumes the
  file and exits with code **115**; an outer loop (``until python -m
  reni_tpu_torch.cli.run ... --retries N; do :; done`` or any supervisor)
  relaunches the run, which blocks on the lock until the preemptor
  finishes and then resumes from the newest checkpoint.

Exit codes: **114** = rerun after a hang or a planned restart (the hang
watchdog, ``RENI_TPU_RSS_EXIT_GB``), **115** = yielded the card to a
preemptor. Both mean "rerun me".

Gating: the lock and the stop file engage only for a single-process job
with a CUDA device (CPU runs and the mesh's multi-process ranks, which must
never serialize across a collective, stay untouched), or when
``RENI_TPU_CHIP_LOCK`` / ``RENI_TPU_STOP_FILE`` name a path; the lock
never for the ranks of a multi-process run (the stop file there is rank 0's
verdict for all). Setting either to the empty string disables that half.
The environment names and exit codes are the JAX package's; the default
paths are its file names in the temporary directory (``TMPDIR``, else
``/tmp``, which makes them JAX's), so that jobs given their own temporary
directories never meet on one lock or one stop file.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

DEFAULT_LOCK = os.path.join(tempfile.gettempdir(), "reni_tpu_chip.lock")
DEFAULT_STOP = os.path.join(tempfile.gettempdir(), "reni_tpu_stop")
YIELD_EXIT_CODE = 115


def _log(msg: str) -> None:
    # stderr: callers may reserve stdout for machine-readable JSON
    print(f"[chiplock] {msg}", file=sys.stderr, flush=True)


def _auto_engaged(device=None) -> bool:
    """Default gate of the card's entry points: a single-process job whose
    device (``device``, default the card) is a CUDA device. Preemptors use
    ``preempt_and_hold``, which touches no device."""
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        # one rank a process: same-machine ranks would deadlock across
        # collectives if serialized
        return False
    import torch

    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def trainer_lock_path(device=None) -> str | None:
    """Lock path of a card entry point running on ``device`` (None =
    locking off). The ranks of a multi-process run never take it, even
    where the variable names a path: each rank would wait for the lock its
    peer holds while that peer waits for it in a collective."""
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        return None
    p = os.environ.get("RENI_TPU_CHIP_LOCK")
    if p is not None:
        return p or None
    return DEFAULT_LOCK if _auto_engaged(device) else None


def trainer_stop_path(device=None) -> str | None:
    """Stop-file path the trainer on ``device`` honours (None = never
    yield)."""
    p = os.environ.get("RENI_TPU_STOP_FILE")
    if p is not None:
        return p or None
    return DEFAULT_STOP if _auto_engaged(device) else None


@contextlib.contextmanager
def hold_chip_lock(
    path: str | None,
    *,
    wait_s: float | None = None,
    what: str = "chip job",
    progress_cb=None,
):
    """Hold the advisory chip lock for the context; yields whether it was
    actually acquired. ``path=None`` is a no-op (yields False). Blocks up
    to ``wait_s`` (default ``RENI_TPU_CHIP_LOCK_WAIT_S`` or 3600 s); on
    timeout proceeds WITHOUT the lock — advisory, never a deadlock.
    ``progress_cb(msg)`` is invoked each poll so callers' hang watchdogs
    (cli.run's RENI_TPU_HANG_EXIT_S) don't count lock waiting as a hang."""
    if path is None:
        yield False
        return
    import fcntl

    if wait_s is None:
        wait_s = float(os.environ.get("RENI_TPU_CHIP_LOCK_WAIT_S", "3600"))
    f = open(path, "a")
    got = False
    deadline = time.monotonic() + wait_s
    try:
        first = True
        while True:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                got = True
                break
            except OSError:
                if time.monotonic() > deadline:
                    _log(
                        f"{what}: chip lock {path} still held after "
                        f"{wait_s:.0f}s — proceeding WITHOUT it (advisory)"
                    )
                    break
                if first:
                    _log(
                        f"{what}: waiting for chip lock {path} "
                        "(another chip job is running)"
                    )
                    first = False
                if progress_cb is not None:
                    progress_cb(f"{what}: waiting for chip lock")
                time.sleep(2.0)
        yield got
    finally:
        if got:
            with contextlib.suppress(OSError):
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        f.close()


def yield_requested(stop: str | None) -> bool:
    """Has a preemptor asked for the card? (Local check: the trainer
    wraps it in rank 0's ``multihost.agree_on_flag``.)"""
    return bool(stop) and os.path.exists(stop)


def honor_yield(stop: str | None, *, primary: bool = True, what: str = "trainer"):
    """Consume the stop file and exit ``YIELD_EXIT_CODE``. The caller has
    already saved any state worth keeping (the trainer force-saves a
    checkpoint first; benchmark items just rerun)."""
    if primary and stop:
        with contextlib.suppress(FileNotFoundError, OSError):
            os.remove(stop)
    _log(
        f"{what}: stop file {stop} present — yielding the chip "
        f"(exit {YIELD_EXIT_CODE}); rerun (or --retries / a supervisor "
        "loop) resumes from the newest checkpoint"
    )
    raise SystemExit(YIELD_EXIT_CODE)


def maybe_yield(stop: str | None, *, what: str) -> None:
    """For timed scripts, between timed items: exit 115 if a preemptor
    asked for the card."""
    if yield_requested(stop):
        honor_yield(stop, what=what)


@contextlib.contextmanager
def preempt_and_hold(*, wait_s: float, what: str = "bench"):
    """For preemptors (a timed run): ask any current holder to yield, then
    take the chip lock. Touches no device, so it is safe to call while the
    card is stuck. Yields True when the card is exclusively ours (or
    arbitration is explicitly disabled), False when the wait timed out and
    the measurement may be contended."""
    lp = os.environ.get("RENI_TPU_CHIP_LOCK")
    if lp is not None and not lp:
        yield True  # explicitly disabled: caller opted out of arbitration
        return
    lp = lp or DEFAULT_LOCK
    stop = os.environ.get("RENI_TPU_STOP_FILE")
    if stop is None:
        stop = DEFAULT_STOP
    stop = stop or None  # empty env disables the preemption half too
    import fcntl

    f = open(lp, "a")
    got = False
    deadline = time.monotonic() + wait_s
    try:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            got = True
        except OSError:
            if stop:
                _log(f"{what}: chip busy — requesting yield via {stop}")
            else:
                _log(f"{what}: chip busy — waiting (preemption disabled)")
            while not got and time.monotonic() <= deadline:
                if stop:
                    # re-assert each poll: a relaunched holder consumes
                    # the file on its way out, and a fresh holder that won
                    # the flock race must see a new request
                    with open(stop, "a"):
                        pass
                try:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                    got = True
                except OSError:
                    time.sleep(2.0)
            if not got:
                _log(
                    f"{what}: chip lock still held after {wait_s:.0f}s — "
                    "proceeding anyway (numbers may be contended)"
                )
        if got and stop:
            # stale or our own request: nobody should yield to us now
            with contextlib.suppress(FileNotFoundError, OSError):
                os.remove(stop)
        yield got
    finally:
        if got:
            with contextlib.suppress(OSError):
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        elif stop:
            # timed-out (contended) path: the request stayed active during
            # the measurement — the holder yielding mid-run still helps —
            # but must not linger to spuriously stop the NEXT holder
            with contextlib.suppress(FileNotFoundError, OSError):
                os.remove(stop)
        f.close()
