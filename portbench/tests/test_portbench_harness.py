"""BENCHMARK.json and the files the harness finds by name in it."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_run_length_fit_the_check():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = harness.cell(BENCH, workload)
    assert cell["traffic"]["ranks"] == cell["workload"]["chips"]
    assert (harness.HERE / "drivers" / f"{cell['traffic']['task']}.py").exists()
    assert cell["limits"] and set(cell["limits"]) <= {"loss_gap", "grad_gap", "change_gap"}
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert harness.read_metric(m["name"], {}) is None  # nothing to read: no number


def test_configs_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_metric_readers_read_a_trace():
    tr = {"task": "fit_decoder", "steps": 20, "least_s": 1e-3, "busy_s": 0.25,
          "window_s": 0.26, "kernels": {"x": 0.2}}
    assert harness.read_metric("train_mfu", tr) == pytest.approx(100 * 0.02 / 0.26)
    assert harness.read_metric("train_kernel_roofline", tr) == pytest.approx(100 * 0.02 / 0.25)
    assert harness.read_metric("idle_pct.fit_decoder", tr) == pytest.approx(100 * 0.01 / 0.26)
    assert harness.read_metric("inverse_mfu", tr) is None


def test_a_run_without_a_card_fails_and_prints_no_result():
    """No fallback to the CPU: exit 2 and nothing on standard output."""
    wl = BENCH["workloads"][0]["name"]
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", wl,
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 2, res.stderr
    assert res.stdout == ""
    assert "card" in res.stderr
