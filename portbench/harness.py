"""What every cell shares: ``BENCHMARK.json`` and the files it names, the
check for cards, the per-layer metric readers, the result line.

A cell's configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``task`` names the driver
``drivers/<task>.py``), its limits ``limits/<workload>.json``; a per-layer
metric is ``metrics/<name>.py``, whose ``read(trace)`` returns a number or
None. A new cell or metric is new files and entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reni_tpu")


class NoCard(RuntimeError):
    """The cell needs more cards than this machine shows."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    """The workload's entry with its configuration, traffic and limits
    loaded: {"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} (the metrics that this cell reports)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return {
        "workload": w,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def require_cards(n: int) -> None:
    """Raise ``NoCard`` unless CUDA shows at least ``n`` cards: a run never
    falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of device memory allocated on ``device``."""
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def device_entry(device, count: int, peak: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
            "count": count, "memory_peak_bytes": peak}


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is the JAX
    package's or JAX's (names compared whole: ``reni_tpu_torch`` is not
    ``reni_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name: str, trace: dict):
    """``metrics/<name>.py``'s reading of the trace, or None."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    value = mod.read(trace)
    return None if value is None else float(value)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct where each is finite
    and within it."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output (``checks`` its last key)."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
