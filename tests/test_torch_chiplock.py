"""The port's chip arbitration (reni_tpu_torch/utils/chiplock.py), with
tests/test_chiplock.py's nine cases: the advisory lock that serializes jobs
on the card, the stop-file preemption a timed run uses to measure an idle
card while a long training run yields and then resumes, and the trainer's
side of it (``cli/run.py``): exit 115 at a segment boundary after a
force-save, then the process-relaunch adoption (``_find_resumable_run``)
finishing the chain in the same run dir, bit for bit the uncut chain."""

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from reni_tpu.utils import chiplock as jchiplock
from reni_tpu_torch.utils import chiplock


def test_same_names_paths_and_codes_as_jax():
    """JAX's file names and exit code; the directory is the temporary one
    (TMPDIR, else /tmp: JAX's paths), so jobs with their own TMPDIR never
    share a lock or a stop file."""
    assert chiplock.YIELD_EXIT_CODE == jchiplock.YIELD_EXIT_CODE
    for port, jax_path in ((chiplock.DEFAULT_LOCK, jchiplock.DEFAULT_LOCK),
                           (chiplock.DEFAULT_STOP, jchiplock.DEFAULT_STOP)):
        assert port == os.path.join(tempfile.gettempdir(), os.path.basename(jax_path))
        assert os.path.dirname(jax_path) == "/tmp"


def test_hold_acquires_and_contends(tmp_path):
    lock = str(tmp_path / "chip.lock")
    with chiplock.hold_chip_lock(lock, wait_s=5.0, what="a") as got_a:
        assert got_a
        # a second holder (fresh fd, same process — flock treats open file
        # descriptions independently) must fail open after its wait budget
        t0 = time.monotonic()
        with chiplock.hold_chip_lock(lock, wait_s=0.1, what="b") as got_b:
            assert not got_b  # advisory: proceeded WITHOUT the lock
        assert time.monotonic() - t0 < 5.0
    # released: a third attempt acquires immediately
    with chiplock.hold_chip_lock(lock, wait_s=0.1, what="c") as got_c:
        assert got_c


def test_hold_none_is_noop():
    with chiplock.hold_chip_lock(None, what="off") as got:
        assert got is False


def test_preempt_acquires_free_lock_and_clears_stale_stop(tmp_path, monkeypatch):
    lock = str(tmp_path / "chip.lock")
    stop = str(tmp_path / "stop")
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", lock)
    monkeypatch.setenv("RENI_TPU_STOP_FILE", stop)
    open(stop, "w").close()  # stale request from a crashed preemptor
    with chiplock.preempt_and_hold(wait_s=2.0, what="bench") as exclusive:
        assert exclusive
        assert not os.path.exists(stop)  # consumed on acquisition


def test_preempt_disabled_by_empty_env(monkeypatch):
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", "")
    with chiplock.preempt_and_hold(wait_s=0.1, what="bench") as exclusive:
        assert exclusive  # explicitly opted out: treated as uncontended


def test_preempt_honors_disabled_stop_file(tmp_path, monkeypatch):
    """RENI_TPU_STOP_FILE="" disables the preemption half symmetrically:
    the preemptor must wait WITHOUT dropping a stop file anywhere."""
    lock = str(tmp_path / "chip.lock")
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", lock)
    monkeypatch.setenv("RENI_TPU_STOP_FILE", "")
    default_preexists = os.path.exists(chiplock.DEFAULT_STOP)
    with chiplock.hold_chip_lock(lock, wait_s=5.0, what="holder") as got:
        assert got
        with chiplock.preempt_and_hold(wait_s=0.5, what="bench") as exclusive:
            assert not exclusive  # timed out, contended
        assert os.path.exists(chiplock.DEFAULT_STOP) == default_preexists


def test_preempt_requests_yield_then_takes_lock(tmp_path, monkeypatch):
    """The full handshake: a holder sees the stop file appear, releases,
    and the preemptor takes over and consumes the request."""
    lock = str(tmp_path / "chip.lock")
    stop = str(tmp_path / "stop")
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", lock)
    monkeypatch.setenv("RENI_TPU_STOP_FILE", stop)

    outcome = {}

    def preemptor():
        with chiplock.preempt_and_hold(wait_s=30.0, what="bench") as exclusive:
            outcome["exclusive"] = exclusive
            outcome["stop_left"] = os.path.exists(stop)

    with chiplock.hold_chip_lock(lock, wait_s=5.0, what="holder") as got:
        assert got
        t = threading.Thread(target=preemptor)
        t.start()
        deadline = time.monotonic() + 20.0
        while not os.path.exists(stop):  # the yield request arrives
            assert time.monotonic() < deadline, "preemptor never asked"
            time.sleep(0.05)
        # holder yields by leaving the context (the trainer exits 115 here)
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert outcome == {"exclusive": True, "stop_left": False}


def test_trainer_gates_off_on_cpu(monkeypatch):
    """Without explicit env the machinery stays off on the CPU (the test
    suite and the gloo ranks of tests/test_torch_multihost.py must never
    serialize on a shared lock) and for the ranks of a multi-process
    run, whose ranks never take the lock even where it is named; a single
    process on a CUDA device engages it, with JAX's file names in the
    temporary directory."""
    monkeypatch.delenv("RENI_TPU_CHIP_LOCK", raising=False)
    monkeypatch.delenv("RENI_TPU_STOP_FILE", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert chiplock.trainer_lock_path("cpu") is None
    assert chiplock.trainer_stop_path("cpu") is None
    assert chiplock.trainer_lock_path("cuda") == chiplock.DEFAULT_LOCK
    assert chiplock.trainer_stop_path("cuda:0") == chiplock.DEFAULT_STOP
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert chiplock.trainer_lock_path("cuda") is None
    assert chiplock.trainer_stop_path("cuda") is None
    # a named lock is still not a rank's to take; a named stop file is asked
    # of every rank, rank 0's verdict deciding
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", "/somewhere/chip.lock")
    monkeypatch.setenv("RENI_TPU_STOP_FILE", "/somewhere/stop")
    assert chiplock.trainer_lock_path("cuda") is None
    assert chiplock.trainer_stop_path("cuda") == "/somewhere/stop"


def test_maybe_yield_exits_115(tmp_path):
    stop = str(tmp_path / "stop")
    chiplock.maybe_yield(stop, what="bench-item")  # absent: no-op
    open(stop, "w").close()
    with pytest.raises(SystemExit) as ei:
        chiplock.maybe_yield(stop, what="bench-item")
    assert ei.value.code == chiplock.YIELD_EXIT_CODE
    assert not os.path.exists(stop)  # consumed


# --- trainer integration: yield at a segment boundary, then relaunch-resume


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_cli_yield_and_relaunch_resume(tmp_path, monkeypatch):
    """A stop file makes the trainer force-checkpoint and exit 115 at the
    first segment boundary (and consume the file); the relaunch with
    --retries adopts the incomplete run and finishes the chain there, bit
    for bit the uncut chain; a complete chain, or an edited config, is not
    adopted."""
    from PIL import Image

    from reni_tpu_torch.cli.run import _find_resumable_run, main, run_with_retries
    from test_torch_cli import _assert_same_bits, _finals, _tiny_config

    rng = np.random.default_rng(0)
    for split, n in (("Train", 5), ("Test", 3)):
        d = tmp_path / "ldr" / split
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.uniform(size=(16, 32, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(str(d / f"img{i}.png"))
    cfg = _tiny_config(tmp_path, str(tmp_path / "ldr"))
    cfg.TRAINER.LOGGER.LOG_IMAGES = False
    uncut = cfg.clone()
    uncut.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / "uncut")
    _, uncut_dir = main(uncut, device="cpu")

    assert _find_resumable_run(cfg) == (None, None)
    stop = str(tmp_path / "stop")
    monkeypatch.setenv("RENI_TPU_STOP_FILE", stop)
    open(stop, "w").close()
    with pytest.raises(SystemExit) as ei:
        main(cfg, device="cpu")
    assert ei.value.code == chiplock.YIELD_EXIT_CODE
    assert not os.path.exists(stop), "the yield must consume the request"

    v0 = None
    for base, dirs, _ in os.walk(str(tmp_path / "runs")):
        if "version_0" in dirs:
            v0 = os.path.join(base, "version_0")
    assert v0, "the first attempt made no run dir"
    cks = os.listdir(os.path.join(v0, "checkpoints"))
    assert "fit_decoder_epoch=0006.npz" in cks  # saved before yielding
    assert not any(c.startswith("fit_decoder_final") for c in cks)
    with open(os.path.join(v0, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f if '"event"' in line]
    assert [(e["event"], e["epoch"]) for e in events] == [("chip_yield", 6)]

    adopt_dir, (tasks_list, resume, load) = _find_resumable_run(cfg)
    assert adopt_dir == v0 and tasks_list == ["FIT_DECODER", "FIT_LATENT"]
    assert resume and "fit_decoder" in resume and load is None

    results, log_dir = run_with_retries(cfg, retries=1, device="cpu")
    assert log_dir == v0, "the relaunch must reuse the incomplete run dir"
    assert results["FIT_DECODER"][1]["fit_decoder_loss"].shape == (6,)
    assert not os.path.exists(os.path.join(os.path.dirname(v0), "version_1"))
    _assert_same_bits(_finals(v0), _finals(uncut_dir))
    assert _find_resumable_run(cfg) == (None, None)

    for name in ("fit_latent_final", "fit_latent_latest", "fit_latent_epoch=0012"):
        for ext in (".npz", ".json"):
            os.remove(os.path.join(v0, "checkpoints", name + ext))
    assert _find_resumable_run(cfg)[0] == v0  # incomplete again: adoptable
    edited = cfg.clone()
    edited.RENI.FIT_LATENT.EPOCHS = 24  # same auto-name, another config
    assert _find_resumable_run(edited) == (None, None)


def test_a_held_lock_forbids_adoption(tmp_path, monkeypatch, capsys):
    """The lock held across retries (JAX cli/run.py:876-900): while another
    job holds it past the wait, the relaunch runs without it and does not
    adopt that job's run directory."""
    from reni_tpu_torch.cli import run as trun

    lock = str(tmp_path / "chip.lock")
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK", lock)
    monkeypatch.setenv("RENI_TPU_CHIP_LOCK_WAIT_S", "0.1")
    seen = []
    monkeypatch.setattr(trun, "_find_resumable_run", lambda cfg: seen.append(cfg) or (None, None))
    monkeypatch.setattr(trun, "main", lambda config, **kw: ({}, kw["log_dir"]))
    cfg = trun.get_cfg_defaults()
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / "runs")
    with chiplock.hold_chip_lock(lock, what="holder") as got:
        assert got
        trun.run_with_retries(cfg, retries=1, device="cpu")
    assert seen == [] and "not adopting" in capsys.readouterr().out
    trun.run_with_retries(cfg, retries=1, device="cpu")  # free again: adoption is asked
    assert len(seen) == 1
