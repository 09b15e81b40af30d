"""One rank of tests/test_torch_multihost.py's runs (gloo on the CPU, the
rendezvous through a file), in one of two modes:

    WORLD_SIZE=2 RANK=r LOCAL_RANK=r python tests/torch_multihost_worker.py \\
        helpers INIT_FILE OUT_DIR
    ... cli INIT_FILE CFG_PATH [DIE_AT_SAVE] -- [trainer arguments]

``helpers`` exercises parallel/multihost.py's agreement helpers and writes
OUT_DIR/helpers_<rank>.json; ``cli`` runs the trainer
(``reni_tpu_torch.cli.run.cli``, ``--device cpu``) on the rank, and with
DIE_AT_SAVE > 0 ends the process (exit 17) right after that many checkpoint
saves, on every rank at the same point: a crash mid-task; with DIE_AT_SAVE
< 0 it raises RuntimeError once instead, after -DIE_AT_SAVE saves (a crash
that ``--retries`` recovers in the process). Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def helpers(out_dir: str) -> None:
    from reni_tpu_torch.parallel import multihost

    rank = multihost.process_index()
    got = {
        "world": multihost.process_count(),
        "primary": multihost.is_primary(),
        "str": multihost.agree_on_str(f"plan of rank {rank}"),
        "flag": multihost.agree_on_flag(rank == 0),
        "path": multihost.agree_on_path(f"runs/exp/version_{3 + rank}"),
        "unversioned": multihost.agree_on_path(f"runs/exp_{rank}"),
        # the RSS exit's agreement: the largest value over the ranks
        "largest": multihost.max_over_ranks([1.5 + 2.0 * rank, -rank]),
    }
    # each rank in its own working directory: the relative path is a file
    # of rank 0's that the other rank does not have
    os.makedirs("ck", exist_ok=True)
    if rank == 0:
        with open("ck/best.npz", "wb") as f:
            f.write(bytes(range(256)) * 41)
        with open("ck/best.json", "w") as f:
            f.write('{"epoch": 7}')
    multihost.ensure_checkpoint("ck/best")
    with open("ck/best.npz", "rb") as f:
        got["npz"] = f.read() == bytes(range(256)) * 41
    with open("ck/best.json") as f:
        got["json"] = json.load(f)
    multihost.barrier("after files")
    got["both_join"] = multihost.barrier_timeout("both", 60.0)
    # rank 1 never joins this one
    if rank == 0:
        t = time.monotonic()
        got["alone"] = multihost.barrier_timeout("alone", 1.0)
        got["alone_s"] = time.monotonic() - t
    with open(os.path.join(out_dir, f"helpers_{rank}.json"), "w") as f:
        json.dump(got, f)
    if rank == 1:
        time.sleep(2.0)  # past rank 0's timeout
    os._exit(0)  # rank 0's abandoned barrier thread must not hold the exit


def cli(cfg_path: str, die_at_save: int, args: list[str]) -> None:
    from reni_tpu_torch.cli import run

    if die_at_save:
        saves = [0]
        real = run._BestTracker.maybe_save

        def maybe_save(self, *a, **k):
            real(self, *a, **k)
            saves[0] += 1
            if saves[0] == abs(die_at_save):
                sys.stdout.flush()
                if die_at_save > 0:
                    os._exit(17)
                raise RuntimeError("a crash after a save, on every rank")

        run._BestTracker.maybe_save = maybe_save
    run.cli(["--cfg_path", cfg_path, "--device", "cpu", *args])


def main() -> None:
    torch.set_num_threads(1)
    from reni_tpu_torch.parallel import multihost

    mode, init = sys.argv[1], sys.argv[2]
    multihost.initialize(device="cpu", init_method=f"file://{init}")
    if mode == "helpers":
        helpers(sys.argv[3])
    else:
        rest = sys.argv[3:]
        cut = rest.index("--") if "--" in rest else len(rest)
        cfg_path = rest[0]
        die = int(rest[1]) if cut > 1 else 0
        cli(cfg_path, die, rest[cut + 1:])


if __name__ == "__main__":
    main()
