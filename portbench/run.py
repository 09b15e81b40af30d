"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result (JSON); the compared numbers
and their limits are the last lines of standard error. Without the cards
the run exits 2 and prints no result. A cell on several cards starts one
process a card (this one is rank 0 and prints the line), their rendezvous on
a free localhost port."""

from __future__ import annotations

import time

T_START = time.time()  # set-up is timed from here: imports, context, inputs, warm-up

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from portbench import harness  # noqa: E402

RANK_TIMEOUT_S = 300


def free_port() -> int:
    """A free localhost TCP port (``chip_smoke.py::_free_port``'s pattern):
    no file under a fixed path, nothing in /dev/shm."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def start_ranks(module: str, argv: list[str], world: int, port: int) -> list[subprocess.Popen]:
    """Ranks 1 .. world - 1 as processes ``python -m module *argv --rank r
    --port port``; their output goes to this process's standard error."""
    return [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r),
                              "--port", str(port)],
                             stdout=sys.stderr, stderr=sys.stderr, env=rank_env(r, world, port))
            for r in range(1, world)]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    return env


def stop(procs: list[subprocess.Popen]) -> list[int]:
    """Wait for every rank, ending those that outlive the timeout."""
    codes = []
    deadline = time.time() + RANK_TIMEOUT_S
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.cell(harness.spec(), args.workload)
    world = cell["traffic"].get("ranks", 1)
    if world != cell["workload"]["chips"]:
        raise SystemExit(f"{args.workload}: traffic ranks {world} != chips "
                         f"{cell['workload']['chips']}")
    try:
        harness.require_cards(world)
    except harness.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    # the host only launches: one intra-op thread a rank keeps the ranks'
    # thread pools off each other's cores
    torch.set_num_threads(1)
    procs = []
    if world > 1:
        from datetime import timedelta

        from reni_tpu_torch.parallel import multihost

        if args.rank == 0:
            args.port = free_port()
            procs = start_ranks("portbench.run", [
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace)], world, args.port)
        os.environ.update(rank_env(args.rank, world, args.port))
        multihost.initialize(device="cuda", timeout=timedelta(seconds=RANK_TIMEOUT_S))
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']['task']}")
    ctx = types.SimpleNamespace(cell=cell, seed=args.seed, seconds=args.seconds,
                                trace=args.trace, device=device, t_start=T_START,
                                rank=args.rank, world=world)
    try:
        result = driver.run(ctx)
    finally:
        if world > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        codes = stop(procs)
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"portbench: ranks exited with {codes}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the JAX package or JAX", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
