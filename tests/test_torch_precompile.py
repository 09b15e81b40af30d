"""The port's background builds (reni_tpu_torch/train/precompile.py) on the
CPU, where there is no nvcc: stand-in build functions and a stand-in
compiler. fit_task(precompile=True) trains bit for bit as without it and
builds what it was given in the background; a failed background build is
logged and reported, never raised; threads building one library make one
compile and one file (kernels/_build.py's per-name lock and per-thread
temporary file); which libraries each task loads."""

import dataclasses
import os
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from reni_tpu_torch.kernels import _build
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import precompile as pc
from reni_tpu_torch.train import tasks
from reni_tpu_torch.train.optim import OptimConfig
from reni_tpu_torch.utils import progress

MODEL = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
             hidden_layers=1, hidden_features=16, output_activation=None)


def _stand_in(tmp_path, name: str, fail: bool = False, delay: float = 0.2) -> pc.Build:
    out = tmp_path / f"{name}.so"

    def build():
        time.sleep(delay)
        if fail:
            raise RuntimeError(f"stand-in compiler error for {name}")
        out.write_text(name)
        return out

    return pc.Build(name, lambda: out, build)


def _fit(precompile, images):
    model = RENIModel(RENIConfig(**MODEL))
    params = model.init(torch.Generator().manual_seed(0), images.shape[0], device="cpu")
    task = tasks.TaskConfig(task="FIT_DECODER", optim=OptimConfig(lr_start=1e-3, lr_end=1e-4),
                            batch_size=2, epochs=4, initial_resolution=(4, 8),
                            final_resolution=(8, 16), curriculum=(2,))
    maps = {(4, 8): images[:, :32], (8, 16): images}
    return tasks.fit_task(model, params, task, lambda res: maps[res],
                          torch.Generator().manual_seed(1), precompile=precompile)


@pytest.mark.parametrize("fail", [False, True], ids=["built", "failed"])
def test_fit_task_precompile_is_bitwise_the_plain_run(tmp_path, monkeypatch, caplog, fail):
    """The task's libraries (stand-ins here) build in the background while
    it trains; the run is the one without precompile, bit for bit. A failing
    build is contained: logged, named in the report, not raised, and the
    builds after it still run."""
    images = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 128, 3))
                              .astype(np.float32))
    asked = []

    def builds(model_config, task, device, *, from_disk=False):
        asked.append((task, torch.device(device).type, from_disk))
        return [_stand_in(tmp_path, "step_lib", fail=fail), _stand_in(tmp_path, "fwd_lib")]

    monkeypatch.setattr(pc, "task_builds", builds)
    plain = _fit(False, images)
    pool = pc.Precompiler()
    got = _fit(pool, images)
    assert pool.drain(timeout=30)
    assert asked == [("FIT_DECODER", "cpu", False)]
    for k in plain[1]:
        np.testing.assert_array_equal(got[1][k], plain[1][k])
    for k in ("mu", "log_var"):
        assert torch.equal(got[0]["latents"][k], plain[0]["latents"][k])
    report = pool.report()
    if fail:
        assert report == {"built": ["fwd_lib"], "present": [], "failed": ["step_lib"]}
        assert "stand-in compiler error for step_lib" in caplog.text
    else:
        assert report == {"built": ["fwd_lib", "step_lib"], "present": [], "failed": []}
        assert (tmp_path / "step_lib.so").read_text() == "step_lib"


def test_pool_queues_a_library_once_and_reports_what_was_there(tmp_path):
    pool = pc.Precompiler()
    there = _stand_in(tmp_path, "there", delay=0)
    (tmp_path / "there.so").write_text("old")
    new = _stand_in(tmp_path, "new")
    assert pool.launch([there, new]) == 2
    assert pool.launch([new]) == 0
    assert pool.drain(timeout=30)
    assert pool.report() == {"built": ["new"], "present": ["there"], "failed": []}


def test_threads_building_one_library_make_one_file(tmp_path, monkeypatch):
    """kernels/_build.build under a stand-in nvcc (a script that counts its
    runs and writes its -o file slowly): more threads than cores asking for
    one library, the interpreter switching threads every microsecond, make
    one compile, one library and its log, no temporary file left; the build
    notes the trainer's progress (the hang watchdog's clock)."""
    csrc, out_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// stand-in source\n")
    runs = tmp_path / "runs.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "time.sleep(0.5)\n"
        "open(out, 'w').write('library')\n"
        "print('ptxas info: stand-in')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    notes = []
    monkeypatch.setattr(progress, "note", notes.append)
    paths = []
    n = 2 * (os.cpu_count() or 1)
    threads = [threading.Thread(target=lambda: paths.append(_build.build("fake")))
               for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(paths) == n and set(paths) == {_build.library_path("fake")}
    assert runs.read_text() == "run\n"
    assert sorted(os.listdir(out_dir)) == sorted([paths[0].name,
                                                  paths[0].with_suffix(".log").name])
    assert paths[0].read_text() == "library"
    assert notes == ["nvcc fake", "nvcc fake done"]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_task_builds_name_each_tasks_libraries(device):
    """With use_pallas on the card: the step kernel of the conditioning and
    the forward (FIT_DECODER), the backward too for FIT_LATENT and
    FIT_INVERSE; FIT_INVERSE's rasterizer and STREAM_FROM_DISK's EXR
    decoder anywhere; on the CPU no kernel library (the wrappers take their
    plain versions there), nor without use_pallas."""
    cbc = RENIConfig(**MODEL, use_pallas=True)
    film = dataclasses.replace(cbc, conditioning="FiLM")

    def names(cfg, task, **kw):
        return [b.name for b in pc.task_builds(cfg, task, device, **kw)]

    card = device == "cuda"
    assert names(cbc, "FIT_DECODER") == (["siren_step", "siren_fwd"] if card else [])
    assert names(film, "FIT_DECODER", from_disk=True) == (
        ["film_step", "siren_fwd"] if card else []) + ["exr_decode"]
    assert names(cbc, "FIT_LATENT") == (["siren_step", "siren_fwd", "siren_bwd"] if card else [])
    assert names(film, "FIT_INVERSE") == (
        ["film_step", "siren_fwd", "siren_bwd"] if card else []) + ["rasterizer"]
    assert names(dataclasses.replace(cbc, use_pallas=False), "FIT_INVERSE") == ["rasterizer"]
