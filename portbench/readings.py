"""Readings that set a cell's limits (not run by the benchmark's own runs):

    python3 -m portbench.readings --workload <name> --seeds 1,2,3 \
        --modes program,control,half[,exchange] [--out FILE]

For each seed and mode, one JSON line of the numbers ``correct`` compares:

- ``program``: the port's first steps, as a run takes them in its set-up,
  against the reference (the lower readings); on several cards every
  rank's state, the worst rank's numbers;
- ``control``: the reference with its trunk's products in fp8 (e4m3
  operands, e5m2 gradients, per-tensor scales), put in the program's place
  (the nearest precision below the configuration's bf16);
- ``half``: the reference with half of each batch left out and the mean
  taken over the rest, put in the program's place (a fault);
- ``exchange`` (several cards): the program with the exchange between the
  cards left out (``parallel/mesh.py::all_reduce_sum`` does nothing).

A state left unchanged reads 1 in ``change_gap`` by its definition and needs
no run."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

from portbench import harness
from portbench.reference import compare, reni
from portbench.run import free_port, rank_env, start_ranks, stop


def _driver(cell: dict):
    return importlib.import_module(f"portbench.drivers.{cell['traffic']['task']}")


def program_steps(cell: dict, seed: int, device, world: int, exchange: bool = True) -> list:
    """Every rank's recorded first steps (on rank 0; None elsewhere)."""
    if world == 1:
        prog = _driver(cell).Program(cell, seed, device)
        got = prog.first_steps(cell["traffic"]["compared_steps"])
        prog.free()
        return [got]
    import torch.distributed as dist
    from reni_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(device=device)
    kept = meshlib.all_reduce_sum
    if not exchange:
        meshlib.all_reduce_sum = lambda tensors, group: None
    try:
        prog = _driver(cell).Program(cell, seed, device, mesh)
        got = prog.first_steps(cell["traffic"]["compared_steps"])
        prog.free()
    finally:
        meshlib.all_reduce_sum = kept

    out = [None] * world
    dist.all_gather_object(out, got)
    return out


def readings(cell: dict, seed: int, mode: str, device, world: int = 1) -> dict | None:
    driver = _driver(cell)
    t0 = time.perf_counter()
    if mode in ("program", "exchange"):
        ranks = program_steps(cell, seed, device, world, exchange=mode == "program")
        if ranks is None or torch.distributed.is_initialized() and torch.distributed.get_rank():
            return None
    elif mode == "control":
        ranks = [driver.reference(cell, seed, device, quant=reni.fp8_matmul)]
    elif mode == "half":
        ranks = [driver.reference(cell, seed, device, half=True)]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    ref = driver.reference(cell, seed, device)
    outs = [compare.training_numbers(got, ref) for got in ranks]
    out = {k: max(o[k] for o in outs) for k in ("loss_gap", "grad_gap", "change_gap")}
    worst = max(outs, key=lambda o: o["grad_gap"])
    out.update(grad_leaf=worst["grad_leaf"], change_leaf=worst["change_leaf"],
               left_out=worst["left_out"], ranks=len(outs), seed=seed, mode=mode,
               seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control,half")
    p.add_argument("--out")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cell = harness.cell(harness.spec(), args.workload)
    modes = args.modes.split(",")
    world = cell["traffic"]["ranks"] if {"program", "exchange"} & set(modes) else 1
    harness.require_cards(world)
    procs = []
    if world > 1:
        from datetime import timedelta

        from reni_tpu_torch.parallel import multihost

        if args.rank == 0:
            args.port = free_port()
            procs = start_ranks("portbench.readings", [
                "--workload", args.workload, "--seeds", args.seeds, "--modes", args.modes],
                world, args.port)
        os.environ.update(rank_env(args.rank, world, args.port))
        multihost.initialize(device="cuda", timeout=timedelta(seconds=300))
    dev = torch.device("cuda", args.rank)
    torch.cuda.set_device(dev)
    sink = open(args.out, "a") if args.out and args.rank == 0 else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for mode in modes:
                if args.rank and mode not in ("program", "exchange"):
                    continue
                got = readings(cell, seed, mode, dev, world if mode in ("program", "exchange")
                               else 1)
                if got is None:
                    continue
                line = json.dumps(dict(got, workload=args.workload))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
        stop(procs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
