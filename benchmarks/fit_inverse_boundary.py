"""Where the benchmark's FIT_INVERSE cell (``reni_cbc_5x256.fit_inverse``,
built by ``portbench/drivers/fit_inverse.py``) spends a runner call, untraced,
on one card: what sets its run-to-run spread.

    python benchmarks/fit_inverse_boundary.py --seed N [--seconds 15] [--windows 1]

Set-up is the harness's (the cell's state, its first three steps, a warm-up
call). Then ``--windows`` consecutive windows, ``--seconds`` in all, call
``run_stage`` as the harness does; the step function is wrapped to record a CUDA event at the
entry of a call's first step and at the return of its last. Per call:

- ``gap_ms``: the card's time from the previous call's last step to this
  call's first (the epoch means and readback of that call, the return to
  the caller, this call's upload and the host's enqueue of the first step);
- ``steps_ms``: the card's time from the first step's entry to the last
  step's return, which holds the call's replays;
- ``upload_ms`` / ``enqueue_ms`` / ``readback_ms``: host time from the
  call's start to the first step's entry, from there to the last step's
  return, and from there to the call's return (the synchronise).

The last line is JSON: for each window a median per call of each time and
its ms a step (``step_ms``, as the benchmark's ``inverse_step_ms``), and
the card's name, power limit and SM clock before and after.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.drivers import fit_inverse  # noqa: E402
from reni_tpu_torch.train import tasks  # noqa: E402

WORKLOAD = "reni_cbc_5x256.fit_inverse"


def card() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return dict(zip(q.split(","), (v.strip() for v in out[0].split(",")))) if out else {}


def window(prog, seconds: float) -> dict:
    calls = []
    steps_per_call = prog.epochs * prog.steps_per_epoch

    def wrapped(state, batch):
        rec = calls[-1]
        if rec["n"] == 0:
            rec["t_first"] = time.perf_counter()
            rec["e_first"].record()
        out = prog.step(state, batch)
        rec["n"] += 1
        if rec["n"] == steps_per_call:
            rec["e_last"].record()
            rec["t_last"] = time.perf_counter()
        return out

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        calls.append({"n": 0, "e_first": torch.cuda.Event(enable_timing=True),
                      "e_last": torch.cuda.Event(enable_timing=True)})
        start = time.perf_counter()
        prog.state, _ = tasks.run_stage(wrapped, prog.state, prog.data, prog.epochs, prog.batch)
        calls[-1].update(t_start=start, t_end=time.perf_counter())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    per = {"gap_ms": [a["e_last"].elapsed_time(b["e_first"]) for a, b in zip(calls, calls[1:])],
           "steps_ms": [c["e_first"].elapsed_time(c["e_last"]) for c in calls],
           "upload_ms": [1e3 * (c["t_first"] - c["t_start"]) for c in calls],
           "enqueue_ms": [1e3 * (c["t_last"] - c["t_first"]) for c in calls],
           "readback_ms": [1e3 * (c["t_end"] - c["t_last"]) for c in calls]}
    out = {k: statistics.median(v) for k, v in per.items()}
    out.update(calls=len(calls), gap_ms_p90=statistics.quantiles(per["gap_ms"], n=10)[-1],
               step_ms=1e3 * elapsed / (len(calls) * steps_per_call))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--windows", type=int, default=1)
    args = p.parse_args()
    harness.require_cards(1)
    dev = torch.device("cuda")
    cell = harness.cell(harness.spec(), WORKLOAD)
    prog = fit_inverse.Program(cell, args.seed, dev)
    prog.first_steps(cell["traffic"]["compared_steps"])
    prog.call(prog.step, prog.epochs)  # warm-up, as the harness's
    torch.cuda.synchronize()
    result = {"seed": args.seed, "card": card(),
              "windows": [window(prog, args.seconds / args.windows) for _ in range(args.windows)]}
    result["sm_clock_after"] = card().get("clocks.sm")
    prog.free()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
