"""The run of a training cell, whatever its task: set-up builds one
training state from the seed and drives its first epoch through the
window's own runner call and feed (recording what the reference follows),
warms up, then the window calls the runner until ``--seconds`` have passed;
once it has closed the reference follows the recorded steps and the
numbers are judged against the cell's limits.

A driver (``drivers/<task>.py``) supplies a ``Program`` (this module's
``Program`` with the task's state, step and runner), ``reference(cell,
seed, device, quant=None, half=False)``, and ``report(prog, steps,
elapsed)`` / ``trace_info(prog)`` for its end-to-end and per-layer
metrics."""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from portbench import harness, trace
from portbench.reference import compare

# runner calls in the traced stretch (the second call of the window on):
# long enough that one stall of the host does not set the idle share
TRACED_CALLS = 4


class Program:
    """The port's training state on this rank and the calls that drive it.
    A subclass sets ``state``, ``step``, ``runner``, ``data``, ``batch``,
    ``epochs`` (a call's), ``steps_per_epoch``, ``beta1`` and ``initial``
    ({leaf path: the benchmark's tensor before any step})."""

    def call(self, step_fn, epochs: int) -> dict:
        self.state, metrics = self.runner(step_fn, self.state, self.data, epochs, self.batch)
        return metrics

    def named_leaves(self):
        opt = self.state.optimizer
        return zip(opt.names, opt.optimizer.param_groups[0]["params"])

    def first_steps(self, n: int) -> dict:
        """The epochs of the first ``n`` steps through the runner,
        recording each step's loss, the first gradient as Adam holds it
        after step 1 (its first moment over 1 - beta1) and every leaf's
        change after step ``n``, as norms."""
        rec: dict = {"losses": []}
        opt = self.state.optimizer.optimizer

        def capture(state, batch):
            state, m = self.step(state, batch)
            i = len(rec["losses"])
            if i < n:
                rec["losses"].append(m["loss"].detach().clone())
                if i == 0:  # a leaf the optimizer never stepped holds no moment
                    rec["grad"] = {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                                   / (1.0 - self.beta1) for k, p in self.named_leaves()}
                if i == n - 1:
                    rec["change"] = {k: p.detach() - self.initial[k]
                                     for k, p in self.named_leaves()}
            return state, m

        self.call(capture, -(-n // self.steps_per_epoch))
        return {"losses": [float(x) for x in rec["losses"]],
                "grad": compare.leaf_norms(rec["grad"]),
                "change": compare.leaf_norms(rec["change"])}

    def free(self) -> None:
        for name in list(vars(self)):
            setattr(self, name, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _agree(done: bool, world: int, device) -> bool:
    """Rank 0's decision on every rank."""
    if world == 1:
        return done
    import torch.distributed as dist

    flag = torch.tensor([1.0 if done else 0.0], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def run(ctx, driver, mesh=None) -> dict | None:
    """One run of a training cell on this rank; rank 0 returns the result."""
    cell, dev, world = ctx.cell, ctx.device, ctx.world
    marks = [("start", ctx.t_start), ("imports and context", time.time())]
    prog = driver.Program(cell, ctx.seed, dev, mesh)
    harness.synchronize(dev)
    marks.append(("inputs and state", time.time()))
    sound = prog.first_steps(cell["traffic"]["compared_steps"])
    harness.synchronize(dev)
    marks.append(("first epoch (builds)", time.time()))
    prog.call(prog.step, prog.epochs)  # warm-up: every shape of the window is built
    harness.synchronize(dev)
    marks.append(("warm-up call", time.time()))
    setup_s = marks[-1][1] - ctx.t_start
    print("portbench set-up: " + ", ".join(f"{name} {t - t0:.3f} s" for (_, t0), (name, t)
                                          in zip(marks, marks[1:])), file=sys.stderr)

    steps_per_call = prog.epochs * prog.steps_per_epoch
    count = {"calls": 0, "steps": 0, "failed": 0}

    def one_call() -> None:
        metrics = prog.call(prog.step, prog.epochs)
        count["calls"] += 1
        count["steps"] += steps_per_call
        count["failed"] += prog.steps_per_epoch * sum(not math.isfinite(x)
                                                      for x in metrics["loss"])

    traced: dict = {}
    t0 = time.perf_counter()
    while True:
        if ctx.trace and count["calls"] == 1:
            with trace.traced(traced, dev):
                for _ in range(TRACED_CALLS):
                    one_call()
        else:
            one_call()
        done = time.perf_counter() - t0 >= ctx.seconds and (traced or not ctx.trace)
        if _agree(done, world, dev):
            break
    steps, failed = count["steps"], count["failed"]
    harness.synchronize(dev)
    elapsed = time.perf_counter() - t0
    per_rank = _gather({"sound": sound, "peak": harness.peak_bytes(dev),
                        "busy_s": traced.get("busy_s")}, world)
    if ctx.rank != 0:
        prog.free()
        return None

    result: dict = {"attempted": steps, "failed": failed}
    if ctx.trace:
        tr = dict(traced, steps=TRACED_CALLS * steps_per_call, **driver.trace_info(prog))
        result["metrics"] = {m["name"]: {"value": v, "unit": m["unit"]}
                             for m in cell["per_layer"]
                             if (v := harness.read_metric(m["name"], tr)) is not None}
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    else:
        result["metrics"] = dict(driver.report(prog, steps, elapsed),
                                 setup_s={"value": setup_s, "unit": "s"})
    prog.free()
    device = harness.device_entry(dev, world, max(r["peak"] for r in per_rank))
    if ctx.trace:
        device["busy_s"] = sum(r["busy_s"] for r in per_rank) / world
        device["window_s"] = traced["window_s"]
    result["device"] = device

    ref = driver.reference(cell, ctx.seed, dev)
    numbers: dict = {}
    for r in per_rank:  # every rank's state against the one reference
        got = compare.training_numbers(r["sound"], ref)
        for k in ("loss_gap", "grad_gap", "change_gap"):
            numbers[k] = max(numbers.get(k, 0.0), got[k])
    ok, checks = harness.judge(numbers, cell["limits"])
    result["correct"] = ok and failed == 0
    result["compared"] = {"ranks": len(per_rank), "left_out": got["left_out"],
                          "grad_leaf": got["grad_leaf"], "change_leaf": got["change_leaf"]}
    result["checks"] = checks
    return result
