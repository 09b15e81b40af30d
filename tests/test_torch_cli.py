"""The port's trainer (``reni_tpu_torch/cli/run.py``) on the CPU at the tiny
sizes of ``tests/test_cli.py``: the task chain through ``main`` beside the
JAX package's ``main`` on the same config, FIT_INVERSE and FiLM chains, the
task-order asserts, crash retries and relaunch adoption (bit for bit the
uncut chain), MAX_RUNTIME, the wall-clock save cadence, ``--profile``, the
precision knob, the later slices' knobs, the hang watchdog and the RSS exit
(exit 114, then a relaunch bit for bit the uncut run), and the module's
command line with ``--device cpu``."""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from reni_tpu.cli import run as jrun
from reni_tpu.utils.config import get_cfg_defaults as jdefaults
from reni_tpu_torch.cli import run as trun
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train.optim import OptimConfig, build_schedule
from reni_tpu_torch.utils.config import get_cfg_defaults

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Both packages' loggers fall back to JSONL alone: importing
    torch.utils.tensorboard loads TensorFlow here (about 10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture()
def tiny_dataset(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("Train", 5), ("Test", 3)):
        d = tmp_path / "ldr" / split
        d.mkdir(parents=True)
        for i in range(n):
            arr = (rng.uniform(size=(16, 32, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(str(d / f"img{i}.png"))
    return str(tmp_path / "ldr")


def _tiny_config(tmp_path, dataset_path, defaults=get_cfg_defaults, runs="runs"):
    """tests/test_cli.py::_tiny_config, for either package's config tree."""
    cfg = defaults()
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT"]
    cfg.RENI.MODEL_TYPE = "VariationalAutoDecoder"
    cfg.RENI.CONDITIONING = "Cond-by-Concat"
    cfg.RENI.LATENT_DIMENSION = 4
    cfg.RENI.HIDDEN_LAYERS = 1
    cfg.RENI.HIDDEN_FEATURES = 16
    cfg.RENI.OUTPUT_ACTIVATION = None
    for task in ("FIT_DECODER", "FIT_LATENT"):
        t = cfg.RENI[task]
        t.EPOCHS = 12
        t.BATCH_SIZE = 4
        t.MULTI_RES_TRAINING = True
        t.INITAL_RESOLUTION = [8, 16]
        t.FINAL_RESOLUTION = [16, 32]
        t.CURRICULUM = [6]
        t.LR_START = 1e-3
        t.LR_END = 1e-4
    cfg.DATASET.NAME = "RENI_LDR"
    cfg.DATASET.RENI_LDR.PATH = dataset_path
    cfg.DATASET.RENI_LDR.TRANSFORMS = [["normalize", [[0.5] * 3, [0.5] * 3]]]
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 6
    cfg.TRAINER.LOGGER.EPOCHS_BETWEEN_EXAMPLES = 6
    cfg.TRAINER.LOGGER.NUMBER_OF_IMAGES = 2
    cfg.TRAINER.LOGGER.IMAGES_TO_SHOW = "random"
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / runs)
    return cfg


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _files(log_dir):
    out = []
    for root, _, files in os.walk(log_dir):
        out += [os.path.relpath(os.path.join(root, f), log_dir) for f in files]
    return sorted(out)


def _finals(log_dir, tasks=("FIT_DECODER", "FIT_LATENT")):
    out = {}
    for task in tasks:
        with np.load(os.path.join(log_dir, "checkpoints", f"{task.lower()}_final.npz")) as z:
            out[task] = {k: z[k] for k in z.files}
    return out


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for task in a:
        assert a[task].keys() == b[task].keys(), task
        for k in a[task]:
            np.testing.assert_array_equal(a[task][k], b[task][k], err_msg=f"{task} {k}")


def test_chain_through_main_matches_jax_layout(tmp_path, tiny_dataset):
    """FIT_DECODER -> FIT_LATENT through the port's main: the results, the
    LR logged per epoch equal to the schedule at epoch - 1, best-2 +
    ``_latest`` + ``_final`` checkpoints, image grids, the graph file and
    config.json; and the same files and metric keys as JAX's main writes
    for the same config (its graph is StableHLO, the port's torch.export)."""
    cfg = _tiny_config(tmp_path, tiny_dataset)
    results, log_dir = trun.main(cfg, device="cpu")
    assert set(results) == {"FIT_DECODER", "FIT_LATENT"}
    mu = results["FIT_LATENT"][0]["latents"]["mu"]
    assert tuple(mu.shape) == (3, 4, 3) and not torch.allclose(mu, torch.zeros_like(mu))
    assert results["FIT_DECODER"][1]["fit_decoder_loss"].shape == (12,)

    rows = _rows(log_dir)
    gamma = math.exp(math.log(1e-4 / 1e-3) / 12)
    schedule = build_schedule(OptimConfig(lr_start=1e-3, lr_end=1e-4, epochs=12))
    for key in ("fit_decoder_lr", "fit_latent_lr"):
        pairs = [(r["step"], r[key]) for r in rows if key in r]
        assert [e for e, _ in pairs] == [6, 12]
        for epoch, v in pairs:
            assert v == schedule(epoch - 1)
            assert v == pytest.approx(1e-3 * gamma ** (epoch - 1), rel=1e-6)

    files = _files(log_dir)
    for task in ("fit_decoder", "fit_latent"):
        for name in ("epoch=0006", "epoch=0012", "latest", "final"):
            assert f"checkpoints/{task}_{name}.npz" in files
        assert f"images/{task}_images_000012.png" in files
        assert f"{task}_graph.txt" in files
    with open(os.path.join(log_dir, "config.json")) as f:
        assert json.load(f) == json.loads(trun._config_fingerprint(cfg))

    jresults, jlog_dir = jrun.main(_tiny_config(tmp_path, tiny_dataset, jdefaults, "jax_runs"))
    assert set(jresults) == set(results)
    jfiles = [f.replace("_graph.stablehlo.txt", "_graph.txt") for f in _files(jlog_dir)]
    assert sorted(jfiles) == files
    jrows = _rows(jlog_dir)
    assert [(r["step"], sorted(r)) for r in rows] == [(r["step"], sorted(r)) for r in jrows]
    for task, (_, m) in results.items():
        assert m.keys() == jresults[task][1].keys()


@pytest.mark.parametrize("tasks", [["FIT_LATENT", "FIT_DECODER"], ["FIT_LATENT"]],
                         ids=["decoder_second", "latent_alone"])
def test_task_order_asserts(tmp_path, tiny_dataset, tasks):
    """FIT_DECODER must come first, and a chain that does not start with it
    needs TRAINER.CHKPTS.LOAD_PATH or --resume."""
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.RENI.TASKS = tasks
    with pytest.raises(AssertionError, match="FIT_DECODER|LOAD_PATH"):
        trun.main(cfg, device="cpu")


def _sphere_obj(tmp_path):
    from reni_tpu_torch.render import mesh as mesh_lib

    m = mesh_lib.make_uv_sphere(6, 12)
    obj = tmp_path / "sphere.obj"
    with open(obj, "w") as f:
        for v in m.verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in m.faces + 1:
            f.write(f"f {a} {b} {c}\n")
    return str(obj)


def _with_inverse(cfg, tmp_path):
    inv = cfg.RENI.FIT_INVERSE
    inv.EPOCHS = 8
    inv.BATCH_SIZE = 3
    inv.MULTI_RES_TRAINING = False
    inv.FINAL_RESOLUTION = [8, 16]
    inv.RENDER_RESOLUTION = 16
    inv.OBJECT_PATH = _sphere_obj(tmp_path)
    inv.KD_VALUE = 0.5
    inv.LR_START = 1e-2
    inv.LR_END = 1e-3
    return cfg


def test_fit_inverse_via_cli(tmp_path, tiny_dataset):
    """FIT_DECODER -> FIT_INVERSE: periodic inverse checkpoints, scalars and
    the final render grid."""
    cfg = _with_inverse(_tiny_config(tmp_path, tiny_dataset), tmp_path)
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_INVERSE"]
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 4
    results, log_dir = trun.main(cfg, device="cpu")
    metrics = results["FIT_INVERSE"][1]
    assert metrics["fit_inverse_loss"].shape == (8,)
    assert np.isfinite(metrics["fit_inverse_loss"]).all()
    files = _files(log_dir)
    for name in ("epoch=0004", "epoch=0008", "latest", "final"):
        assert f"checkpoints/fit_inverse_{name}.npz" in files
    assert "images/fit_inverse_images_000008.png" in files
    assert any("fit_inverse_loss" in r for r in _rows(log_dir))


def test_film_chain_via_cli(tmp_path, tiny_dataset):
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.RENI.CONDITIONING = "FiLM"
    cfg.RENI.MAPPING_LAYERS = 2
    cfg.RENI.MAPPING_FEATURES = 16
    results, _ = trun.main(cfg, device="cpu")
    assert np.isfinite(results["FIT_DECODER"][1]["fit_decoder_loss"]).all()
    assert "mapping" in results["FIT_LATENT"][0]["decoder"]


def test_auto_resume_plan(tmp_path):
    """The crash-retry policy (tests/test_cli.py:322's cases): mid-task ->
    resume it; complete -> the next task; a trimmed list; a partial foreign
    checkpoint is not loaded. A complete FIT_DECODER with kept epoch files
    chains its best one, as the uncut chain does."""
    import time as _time

    from reni_tpu_torch.models.reni import RENIConfig, RENIModel

    cfg = get_cfg_defaults()
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT"]
    cfg.RENI.FIT_DECODER.EPOCHS = 12
    log_dir = str(tmp_path)
    ckdir = os.path.join(log_dir, "checkpoints")

    tasks_list, resume, load = trun._auto_resume_plan(cfg, log_dir)
    assert tasks_list == ["FIT_DECODER", "FIT_LATENT"] and resume is None

    model = RENIModel(RENIConfig(latent_dim=4, hidden_layers=1, hidden_features=16))
    params = model.init(torch.Generator(), 2, device="cpu")

    def save(name, epoch, loss=None):
        meta = {"task": "FIT_DECODER", "epoch": epoch}
        if loss is not None:
            meta["loss"] = loss
        tck.save_checkpoint(os.path.join(ckdir, name), params, metadata=meta)
        _time.sleep(0.01)

    save("fit_decoder_latest", 6)
    tasks_list, resume, load = trun._auto_resume_plan(cfg, log_dir)
    assert tasks_list == ["FIT_DECODER", "FIT_LATENT"]
    assert resume and resume.endswith("fit_decoder_latest") and load is None

    save("fit_decoder_latest", 12)
    tasks_list, resume, load = trun._auto_resume_plan(cfg, log_dir)
    assert tasks_list == ["FIT_LATENT"]
    assert resume is None and load.endswith("fit_decoder_latest")

    trimmed = cfg.clone()
    trimmed.RENI.TASKS = ["FIT_LATENT"]
    tasks_list, resume, load = trun._auto_resume_plan(trimmed, log_dir)
    assert tasks_list == ["FIT_LATENT"]
    assert resume is None and load.endswith("fit_decoder_latest")

    save("fit_decoder_epoch=0008", 8, loss=0.5)
    save("fit_decoder_epoch=0004", 4, loss=0.7)
    save("fit_decoder_latest", 12, loss=0.9)
    tasks_list, resume, load = trun._auto_resume_plan(cfg, log_dir)
    assert tasks_list == ["FIT_LATENT"] and resume is None
    assert load.endswith("fit_decoder_epoch=0008")

    save("fit_decoder_latest", 6)
    tasks_list, resume, load = trun._auto_resume_plan(trimmed, log_dir)
    assert tasks_list == ["FIT_LATENT"] and resume is None
    assert load == trimmed.TRAINER.CHKPTS.LOAD_PATH


class _Killed(BaseException):
    """Stands in for a process killed mid-run: no ``except Exception``
    catches it."""


def _crash_after_save(monkeypatch, task, epoch, exc):
    """Raise ``exc`` once, right after ``task``'s checkpoint at ``epoch``."""
    real = trun._BestTracker.maybe_save
    fired = []

    def flaky(self, params, ep, *a, **k):
        real(self, params, ep, *a, **k)
        if self.task == task and ep == epoch and not fired:
            fired.append(ep)
            raise exc

    monkeypatch.setattr(trun._BestTracker, "maybe_save", flaky)
    return fired


def _resume_config(tmp_path, dataset, runs, tasks=("FIT_DECODER", "FIT_LATENT")):
    """EVERY_N_EPOCHS 4, images every 6: callbacks at epochs 4, 6, 10 and 12
    of FIT_DECODER and FIT_LATENT, saves at 4, 6 (the stage end) and 12, so a
    crash after epoch 4 resumes mid-stage (FIT_INVERSE: saves at 4 and 8)."""
    cfg = _tiny_config(tmp_path, dataset, runs=runs)
    if "FIT_INVERSE" in tasks:
        _with_inverse(cfg, tmp_path)
    cfg.RENI.TASKS = list(tasks)
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 4
    return cfg


@pytest.mark.parametrize("where", [("FIT_DECODER", 4), ("FIT_LATENT", 4), ("FIT_INVERSE", 4)],
                         ids=["fit_decoder_mid_stage", "fit_latent_mid_stage",
                              "fit_inverse_mid_task"])
def test_run_with_retries_recovers_bitwise(tmp_path, tiny_dataset, monkeypatch, where):
    """A crash right after a checkpoint: --retries resumes the task from it
    in the same run dir, logs a retry event, and the chain's final
    checkpoints are bit for bit those of the uncut chain."""
    chain = (("FIT_DECODER", "FIT_INVERSE") if where[0] == "FIT_INVERSE"
             else ("FIT_DECODER", "FIT_LATENT"))
    _, uncut = trun.main(_resume_config(tmp_path, tiny_dataset, "uncut", chain), device="cpu")
    fired = _crash_after_save(monkeypatch, *where, RuntimeError("simulated crash"))
    results, log_dir = trun.run_with_retries(
        _resume_config(tmp_path, tiny_dataset, "retried", chain), retries=1, device="cpu")
    assert fired == [where[1]]
    _assert_same_bits(_finals(log_dir, chain), _finals(uncut, chain))
    retries = [r for r in _rows(log_dir) if r.get("event") == "retry"]
    assert len(retries) == 1 and retries[0]["attempt"] == 1
    assert retries[0]["tasks"] == list(chain[chain.index(where[0]):])
    assert retries[0]["resume"].endswith(f"{where[0].lower()}_latest")
    assert os.listdir(os.path.dirname(log_dir)) == ["version_0"]


def test_relaunch_adopts_the_killed_run_bitwise(tmp_path, tiny_dataset, monkeypatch, capsys):
    """A process killed after FIT_DECODER's epoch-4 checkpoint, then the
    same command again with --retries 1: it adopts the killed run's
    version_0 (``[relaunch] adopting``, a ``relaunch_adopt`` event), its
    rows after the adoption equal the uncut run's rows of the same epochs,
    and its final checkpoints and kept files are the uncut run's."""
    _, uncut = trun.main(_resume_config(tmp_path, tiny_dataset, "uncut"), device="cpu")
    _crash_after_save(monkeypatch, "FIT_DECODER", 4, _Killed())
    cfg = _resume_config(tmp_path, tiny_dataset, "relaunched")
    with pytest.raises(_Killed):
        trun.run_with_retries(cfg, retries=1, device="cpu")
    capsys.readouterr()
    _, log_dir = trun.run_with_retries(cfg, retries=1, device="cpu")
    assert "[relaunch] adopting" in capsys.readouterr().out
    assert os.path.basename(log_dir) == "version_0"
    assert os.listdir(os.path.dirname(log_dir)) == ["version_0"]
    _assert_same_bits(_finals(log_dir), _finals(uncut))
    assert sorted(os.listdir(os.path.join(log_dir, "checkpoints"))) == sorted(
        os.listdir(os.path.join(uncut, "checkpoints")))
    rows = _rows(log_dir)
    adopt = [i for i, r in enumerate(rows) if r.get("event") == "relaunch_adopt"]
    assert len(adopt) == 1 and rows[adopt[0]]["resume"].endswith("fit_decoder_latest")
    after = [r for r in rows[adopt[0] + 1:] if "event" not in r]
    want = [r for r in _rows(uncut) if "event" not in r]
    assert after == want[len(want) - len(after):] and len(after) == len(want) - 1


def test_relaunch_refuses_a_run_with_another_config(tmp_path, tiny_dataset, monkeypatch,
                                                    capsys):
    """With an explicit TB.NAME the run dir names no hyperparameters: a
    killed run whose config.json differs from the relaunch's is not
    adopted, and the relaunch starts version_1."""
    _crash_after_save(monkeypatch, "FIT_DECODER", 4, _Killed())
    cfg = _resume_config(tmp_path, tiny_dataset, "runs")
    cfg.TRAINER.LOGGER.TB.NAME = "fixed"
    with pytest.raises(_Killed):
        trun.run_with_retries(cfg, retries=1, device="cpu")
    edited = cfg.clone()
    edited.RENI.FIT_DECODER.LR_START = 2e-3
    capsys.readouterr()
    _, log_dir = trun.run_with_retries(edited, retries=1, device="cpu")
    assert "different config" in capsys.readouterr().out
    assert os.path.basename(log_dir) == "version_1"


_WEDGE = """\
import sys, threading, time
from reni_tpu_torch.cli import run as trun
from reni_tpu_torch.utils import progress

real = trun._BestTracker.maybe_save
stalled = threading.Event()


def heartbeat():
    # the trainer's last note kept fresh up to the stall, so that the one
    # idle gap is the stall's, however slow set-up and training run
    while not stalled.wait(0.1):
        progress.PROGRESS["ts"] = time.time()


def wedged(self, params, epoch, *a, **k):
    real(self, params, epoch, *a, **k)
    if epoch == 2:  # a launch that never returns: no progress from here on
        stalled.set()
        time.sleep(600)


threading.Thread(target=heartbeat, daemon=True).start()


trun._BestTracker.maybe_save = wedged
sys.exit(trun.cli(sys.argv[1:]))
"""


@pytest.mark.parametrize("fault", ["hang", "rss"])
def test_exit_114_then_the_relaunch_is_the_uncut_run(tmp_path, tiny_dataset, fault):
    """The two exits 114 (tests/test_cli.py:419 and :538), as subprocess
    runs of the trainer's command line, a segment (a progress note) every 2
    epochs: RENI_TPU_HANG_EXIT_S=5 with the trainer stuck after its epoch-2
    checkpoint and its notes kept fresh until then (the watchdog logs a
    ``hang_exit`` event naming that epoch's note and exits), RENI_TPU_RSS_EXIT_GB below the process's RSS (at the
    first segment: checkpoint, ``rss_exit`` event, exit). The same command
    with --retries 1 then adopts the run and ends bit for bit at the uncut
    run's final checkpoint."""
    cfg = _resume_config(tmp_path, tiny_dataset, "runs", ("FIT_DECODER",))
    cfg.TRAINER.LOGGER_TYPE = "jsonl"  # no TensorFlow import in the child
    cfg.TRAINER.LOGGER.LOG_IMAGES = False
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 2
    uncut = cfg.clone()
    uncut.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / "uncut")
    _, uncut_dir = trun.main(uncut, device="cpu")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    argv = ["--cfg_path", str(cfg_path), "--device", "cpu", "--retries", "1"]
    if fault == "hang":
        env["RENI_TPU_HANG_EXIT_S"] = "5"
        cmd = [sys.executable, "-c", _WEDGE] + argv
    else:
        env["RENI_TPU_RSS_EXIT_GB"] = "0.001"
        cmd = [sys.executable, "-m", "reni_tpu_torch.cli.run"] + argv
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 114, res.stdout[-1500:] + res.stderr[-1500:]
    log_dir = trun._experiment_runs(cfg)[0]
    events = [r for r in _rows(log_dir) if "event" in r]
    assert [e["event"] for e in events] == [f"{fault}_exit"], events
    if fault == "hang":
        assert "HANG: no trainer progress" in res.stderr and events[0]["idle_s"] >= 5
        assert events[0]["last"].startswith("FIT_DECODER epoch 2 "), events
    else:
        assert "RENI_TPU_RSS_EXIT_GB" in res.stdout and events[0]["epoch"] == 2
    _, relaunched = trun.run_with_retries(cfg, retries=1, device="cpu")
    assert relaunched == log_dir
    assert [r["event"] for r in _rows(log_dir) if "event" in r][-1] == "relaunch_adopt"
    _assert_same_bits(_finals(log_dir, ("FIT_DECODER",)), _finals(uncut_dir, ("FIT_DECODER",)))


def test_hang_watchdog_exits_114():
    """RENI_TPU_HANG_EXIT_S (tests/test_cli.py:419): no progress note within
    the bound exits 114; progress notes 0.05 s apart keep the process alive
    past twice the bound."""
    code = ("import time\n"
            "from reni_tpu_torch.cli import run\n"
            "run._arm_hang_watchdog()\n"
            "t_end = time.monotonic() + 6\n"
            "while time.monotonic() < t_end:\n"
            "    time.sleep(0.05)\n"
            "    run._note_progress('alive')\n"
            "print('survived', flush=True)\n"
            "time.sleep(60)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, RENI_TPU_HANG_EXIT_S="3")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 114 and "survived" in res.stdout, res.stderr[-1000:]


def test_max_runtime_stops_after_the_first_segment(tmp_path, tiny_dataset, monkeypatch):
    """TRAINER.MAX_RUNTIME (hours): once the clock passes it, the task stops
    at its next callback and later tasks do not start. The trainer's clock
    here jumps two hours after its second reading (the deadline and the
    check before the first task)."""
    import time as real

    readings = []

    def clock():
        readings.append(1)
        return real.time() + (7200.0 if len(readings) > 2 else 0.0)

    monkeypatch.setattr(trun, "time", types.SimpleNamespace(
        time=clock, monotonic=real.monotonic, perf_counter=real.perf_counter))
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.TRAINER.MAX_RUNTIME = 1.0
    results, _ = trun.main(cfg, device="cpu")
    assert set(results) == {"FIT_DECODER"}
    assert results["FIT_DECODER"][1]["fit_decoder_loss"].shape == (6,)


def test_wall_clock_checkpoint_cadence(tmp_path, tiny_dataset, monkeypatch):
    """RENI_TPU_CKPT_WALL_S: with a tiny target every segment's callback
    saves and segments shrink to an epoch; the stage end (epoch 6, off the
    every-5 grid) is saved."""
    monkeypatch.setenv("RENI_TPU_CKPT_WALL_S", "0.0001")
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.RENI.TASKS = ["FIT_DECODER"]
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 5
    _, log_dir = trun.main(cfg, device="cpu")
    cks = os.listdir(os.path.join(log_dir, "checkpoints"))
    assert "fit_decoder_epoch=0006.npz" in cks, cks
    epochs = {r["step"] for r in _rows(log_dir) if "fit_decoder_loss" in r}
    assert len(epochs) >= 10, sorted(epochs)


def test_profile_writes_a_trace(tmp_path, tiny_dataset):
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.RENI.TASKS = ["FIT_DECODER"]
    cfg.RENI.FIT_DECODER.EPOCHS = 2
    cfg.RENI.FIT_DECODER.MULTI_RES_TRAINING = False
    cfg.TRAINER.LOGGER.LOG_IMAGES = False
    trun.main(cfg, device="cpu", profile_dir=str(tmp_path / "trace"))
    with open(tmp_path / "trace" / "reni_tpu_torch.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_tensorboard_receives_scalars_and_images(tmp_path, tiny_dataset, monkeypatch):
    """With LOGGER_TYPE tensorboard the logger hands every scalar and grid to
    torch.utils.tensorboard's SummaryWriter (a recording stand-in here)."""
    calls = []

    class Writer:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, step))

        def add_image(self, tag, img, step, dataformats):
            calls.append(("image", tag, step, img.shape, dataformats))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    cfg = _tiny_config(tmp_path, tiny_dataset)
    cfg.RENI.TASKS = ["FIT_DECODER"]
    _, log_dir = trun.main(cfg, device="cpu")
    assert calls[0] == ("init", log_dir) and calls[-1] == ("close",)
    assert ("scalar", "fit_decoder_loss", 12) in calls
    assert any(c[0] == "image" and c[1] == "fit_decoder_images" and c[4] == "HWC"
               for c in calls)
    calls.clear()
    cfg.TRAINER.LOGGER_TYPE = "jsonl"
    trun.main(cfg, device="cpu")
    assert calls == []


@pytest.mark.parametrize("precision, mixed, want", [
    ("bfloat16", False, "highest"), ("float32", False, "highest"),
    ("tensorfloat32", False, "high"), ("tensorfloat32", True, "highest")])
def test_precision_knob(precision, mixed, want):
    """TPU.PRECISION: the default bfloat16 and float32 keep torch's float32
    matmuls at "highest" (the shading's light sums must not take TF32);
    tensorfloat32 selects "high"; TRAINER.MIXED_PRECISION selects bfloat16."""
    cfg = get_cfg_defaults()
    cfg.TPU.PRECISION = precision
    cfg.TRAINER.MIXED_PRECISION = mixed
    before = torch.get_float32_matmul_precision()
    try:
        trun._apply_precision(cfg)
        assert torch.get_float32_matmul_precision() == want
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("ask, item", [
    (dict(mesh="2x1"), "A-11"), (dict(MESH=dict(DATA=2)), "A-11"),
    (dict(MESH=dict(PIXEL=2)), "A-11"), (dict(SHARD_LATENTS=True), "A-11"),
    (dict(env=("WORLD_SIZE", "2")), "A-11"), (dict(env=("RENI_TPU_HANG_EXIT_S", "60")), "A-13"),
    (dict(env=("RENI_TPU_RSS_EXIT_GB", "40")), "A-13"),
    (dict(env=("RENI_TPU_STOP_FILE", "{tmp}/stop")), "A-13"),
    (dict(env=("RENI_TPU_CHIP_LOCK", "{tmp}/lock")), "A-13"),
    (dict(mesh="1x1x2"), "A-11b"), (dict(MESH=dict(MODEL=2)), "A-11b")],
    ids=lambda v: str(v).replace(" ", ""))
def test_later_slices_are_ported(tmp_path, tiny_dataset, monkeypatch, ask, item):
    """The mesh, sharded latents and multi-process runs (A-11) and the
    tensor-parallel model axis (A-11b) are ported (tests/test_torch_multihost.py
    and tests/test_torch_tp.py run the ranks): in one process without
    torchrun's variables a mesh of two ranks, a model axis of two among them,
    raises ValueError naming WORLD_SIZE, WORLD_SIZE=2 without MASTER_ADDR
    raises in the rendezvous, both before any training, and SHARD_LATENTS on
    one rank trains as without it (the streaming keys run:
    tests/test_torch_streaming.py). The fault machinery (A-13) is accepted:
    the trainer through run_with_retries trains with each of its variables
    set (a stop file that does not exist asks nothing; the chip lock is
    taken and released)."""
    cfg = _tiny_config(tmp_path, tiny_dataset)
    ask = dict(ask)
    mesh = ask.pop("mesh", None)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if "env" in ask:
        var, value = ask.pop("env")
        monkeypatch.setenv(var, value.replace("{tmp}", str(tmp_path)))
    for key, value in ask.items():
        if isinstance(value, dict):
            cfg.TPU[key].update(value)
        else:
            cfg.TPU[key] = value
    if item == "A-13" or cfg.TPU.SHARD_LATENTS:
        cfg.RENI.TASKS = ["FIT_DECODER"]
        cfg.RENI.FIT_DECODER.EPOCHS = 2
        cfg.RENI.FIT_DECODER.MULTI_RES_TRAINING = False
        results, _ = trun.run_with_retries(cfg, device="cpu", mesh=mesh)
        assert results["FIT_DECODER"][1]["fit_decoder_loss"].shape == (2,)
        return
    with pytest.raises(ValueError, match="WORLD_SIZE|MASTER_ADDR"):
        trun.main(cfg, device="cpu", mesh=mesh)
    assert not os.path.exists(cfg.TRAINER.LOGGER.TB.SAVE_DIR)
    assert not torch.distributed.is_initialized()


def test_precompile_trains(tmp_path, tiny_dataset, capsys):
    """TPU.PRECOMPILE: the chain's later tasks' libraries build in the
    background (on the CPU the kernels' wrappers take their plain versions,
    so no kernel library is asked for) and the training is the run's without
    it, bit for bit."""
    runs = []
    for precompile in (False, True):
        cfg = _tiny_config(tmp_path, tiny_dataset, runs=f"runs_{precompile}")
        cfg.RENI.TASKS = ["FIT_DECODER"]
        cfg.RENI.FIT_DECODER.EPOCHS = 2
        cfg.RENI.FIT_DECODER.MULTI_RES_TRAINING = False
        cfg.TPU.PRECOMPILE = precompile
        runs.append(trun.main(cfg, device="cpu", mesh="1x1")[1])
    assert "TPU.PRECOMPILE: later tasks' libraries build in background" in capsys.readouterr().out
    _assert_same_bits(*(_finals(r, ("FIT_DECODER",)) for r in runs))


def test_cli_needs_the_card_unless_told(tmp_path, tiny_dataset, monkeypatch):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_tiny_config(tmp_path, tiny_dataset).to_dict()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.cli(["--cfg_path", str(cfg_path)])
    assert not os.path.exists(tmp_path / "runs")


def test_module_runs_the_three_task_chain_on_the_cpu(tmp_path, tiny_dataset):
    """``python -m reni_tpu_torch.cli.run --cfg_path <json> --device cpu``:
    FIT_DECODER -> FIT_LATENT -> FIT_INVERSE, with metrics.jsonl, best-2 +
    ``_latest`` + ``_final`` per task, PNG grids, config.json and the
    decoder graph."""
    cfg = _with_inverse(_tiny_config(tmp_path, tiny_dataset), tmp_path)
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT", "FIT_INVERSE"]
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 2
    cfg.TRAINER.LOGGER_TYPE = "jsonl"  # no TensorFlow import in the child
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-m", "reni_tpu_torch.cli.run", "--cfg_path",
                          str(cfg_path), "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    log_dir, = [os.path.join(root, "version_0") for root, dirs, _ in os.walk(tmp_path / "runs")
                if "version_0" in dirs]
    files = _files(log_dir)
    for task, epochs in (("fit_decoder", 12), ("fit_latent", 12), ("fit_inverse", 8)):
        kept = [f for f in files if f.startswith(f"checkpoints/{task}_epoch=")]
        assert len(kept) == 4, kept  # best 2, npz and json each
        for name in ("latest", "final"):
            assert f"checkpoints/{task}_{name}.npz" in files
            assert f"checkpoints/{task}_{name}.json" in files
        assert f"{task}_graph.txt" in files
        assert any(f.startswith(f"images/{task}_images_") and f.endswith(".png") for f in files)
        assert {r["step"] for r in _rows(log_dir) if f"{task}_loss" in r} >= {epochs}
    assert "config.json" in files and "metrics.jsonl" in files
    assert not any("events.out" in f for f in files)
    for task in ("FIT_DECODER", "FIT_LATENT", "FIT_INVERSE"):
        assert f"[reni_tpu_torch] {task}:" in res.stdout


def test_chip_smoke_cli_config_is_the_zoo_recipe(tmp_path):
    """chip_smoke.py's cli_run phase holds configs/zoo_synthetic.yaml's values
    (as JSON: the card's machine has no PyYAML) and FIT_INVERSE as its
    fit_inverse phase runs it; only the chain, the cuts and the paths
    differ."""
    import yaml

    import chip_smoke

    with open(os.path.join(ROOT, "configs", "zoo_synthetic.yaml")) as f:
        assert chip_smoke.ZOO_SYNTHETIC == yaml.safe_load(f)
    from reni_tpu_torch.train.tasks import TaskConfig

    cfg = chip_smoke.cli_config(str(tmp_path / "maps"), str(tmp_path / "runs"))
    assert cfg.RENI.TASKS == list(chip_smoke.CLI_TASKS)
    got = TaskConfig.from_config(cfg, "FIT_INVERSE")
    want = chip_smoke.inverse_task_config()
    for field in ("optim", "batch_size", "cosine_similarity_weight", "prior_loss_weight",
                  "render_resolution", "object_path", "kd_value", "azimuths", "elevations"):
        a, b = getattr(got, field), getattr(want, field)
        if field == "optim":
            a, b = a.__dict__ | {"epochs": 0}, b.__dict__ | {"epochs": 0}
        assert a == b, field
    cut = chip_smoke.CLI_CUTS["FIT_INVERSE"][0]
    assert got.resolution_stages() == [(chip_smoke.FIT_RES[1], cut)]
    for task, (epochs, curriculum) in chip_smoke.CLI_CUTS.items():
        assert cfg.RENI[task].EPOCHS == epochs
        assert not curriculum or cfg.RENI[task].CURRICULUM == curriculum
    assert cfg.TRAINER.CHKPTS.SAVE_DIR == "checkpoints" and cfg.DATASET.NAME == "RENI_HDR"
