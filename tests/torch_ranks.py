"""Start gloo ranks of the port on the CPU for tests/test_torch_parallel.py
and tests/test_torch_multihost.py: one process a rank, each with torchrun's
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` and one thread; the scripts
rendezvous through a file, never a TCP port, so that parallel test workers
cannot collide."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Ranks:
    """``n`` processes of ``argv`` (``{rank}`` in an argument is the rank's
    number); ``env`` adds to each rank's environment and ``cwd`` is its
    working directory (either may be a callable of the rank)."""

    def __init__(self, argv: list[str], n: int, env=None, cwd=ROOT):
        self.procs = []
        for r in range(n):
            e = {k: v for k, v in os.environ.items()
                 if k not in ("MASTER_ADDR", "MASTER_PORT", "PYTHONPATH")}
            e.update(WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r), PYTHONPATH=str(ROOT),
                     OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
            extra = env(r) if callable(env) else env
            e.update(extra or {})
            self.procs.append(subprocess.Popen(
                [sys.executable] + [a.replace("{rank}", str(r)) for a in argv], env=e,
                cwd=str(cwd(r) if callable(cwd) else cwd), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

    def wait(self, timeout: float) -> list[tuple[int, str]]:
        """(exit code, output) of each rank; every rank is killed when one
        does not end within ``timeout`` seconds."""
        outs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append((p.returncode, out))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            outs = [(None, p.communicate()[0]) for p in self.procs]
            raise AssertionError("ranks did not finish in time:\n"
                                 + "\n".join(o[-3000:] for _, o in outs))
        return outs

    def check(self, timeout: float) -> list[str]:
        outs = self.wait(timeout)
        bad = [f"rank {r} exited {rc}:\n{out[-4000:]}" for r, (rc, out) in enumerate(outs)
               if rc != 0]
        assert not bad, "\n".join(bad)
        return [out for _, out in outs]
