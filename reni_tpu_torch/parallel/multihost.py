"""Multi-process runs (counterpart of ``reni_tpu/parallel/multihost.py``).

One process a rank, started by ``torchrun`` or by hand with its variables:

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=4 RANK=r LOCAL_RANK=r \\
        python -m reni_tpu_torch.cli.run --cfg_path cfg.json --mesh 2x2

    from reni_tpu_torch.parallel import multihost
    multihost.initialize()              # torch.distributed.init_process_group
    mesh = multihost.global_mesh(n_pixel=1)

torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` take the place of JAX's ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Without ``WORLD_SIZE`` nothing
is initialised and every helper below is a no-op, as JAX's are without a
coordinator.

The backend is NCCL for ranks on the card and gloo for ranks on the CPU. A
caller may ask for gloo on the card (``backend="gloo"``): NCCL refuses two
ranks on one card, and gloo carries CUDA tensors for ``all_reduce``,
``broadcast`` and ``barrier``. Nothing here switches backend by itself. The
host-side agreement (strings, flags, paths, files, barriers) goes over a
gloo group on CPU tensors, whatever the backend of the device tensors.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

from reni_tpu_torch.utils.device import resolve_device

# the gloo group of the host-side agreement (None: the default group is gloo)
_host = {"group": None}


def initialize(backend: str | None = None, device=None, **kwargs) -> bool:
    """Join the run's process group from torchrun's variables; returns True
    when more than one rank takes part.

    Without ``WORLD_SIZE`` in the environment this is a no-op (False), as is
    a second call. ``device`` (default: the card) picks the default backend,
    NCCL on the card and gloo on the CPU; a rank on the card works on
    ``cuda:LOCAL_RANK``. ``kwargs`` go to ``init_process_group`` (the tests
    pass ``init_method="file://..."``)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend, world_size=world, rank=rank, **kwargs)
    _host["group"] = None if backend == "gloo" else dist.new_group(backend="gloo")
    return world > 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for the card (default), the
    CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs (rank 0)."""
    return process_index() == 0


def global_mesh(n_pixel: int = 1, device=None):
    """The ('data', 'pixel', 'model') mesh over every rank of the run."""
    from reni_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_pixel=n_pixel, device=device)


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (no-op with one rank). Used between the
    trainer's tasks so that no rank reads a chained checkpoint before rank 0
    has written it. ``name`` is for the reader: gloo barriers are matched by
    order."""
    if process_count() > 1:
        dist.barrier(group=_host["group"])


def _broadcast(value):
    obj = [value]
    dist.broadcast_object_list(obj, src=0, group=_host["group"])
    return obj[0]


def agree_on_str(value: str, max_len: int = 4096) -> str:
    """Every rank adopts rank 0's string (a crash-retry resume plan, an
    environment variable). Collective: every rank calls it at the same
    point."""
    if process_count() <= 1:
        return value
    if len(value.encode()) > max_len:
        raise ValueError(f"agree_on_str payload exceeds {max_len} bytes")
    return _broadcast(value)


def agree_on_flag(value: bool) -> bool:
    """Every rank adopts rank 0's boolean: the MAX_RUNTIME verdict and the
    wall-clock save decision, which per-rank clocks reach at different
    instants; a rank that stopped alone would leave the others blocked in a
    collective. Collective."""
    if process_count() <= 1:
        return bool(value)
    return bool(_broadcast(bool(value)))


def max_over_ranks(values) -> list[float]:
    """Each entry of ``values``, the largest over the ranks, in one
    all-reduce (the trainer's checks at a segment's end: the RSS exit's
    memory reading, where the rank nearest its limit decides for all, and
    rank 0's flags, which the other ranks send as 0). Collective."""
    if process_count() <= 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host["group"])
    return t.tolist()


def agree_on_path(path: str) -> str:
    """Adopt rank 0's ``version_N`` run directory everywhere: each rank's
    own next-free-version scan can race with rank 0 creating it."""
    if process_count() <= 1 or "version_" not in path:
        return path
    base, v = path.rsplit("version_", 1)
    return f"{base}version_{int(_broadcast(int(v)))}"


def ensure_file(path: str) -> None:
    """Make rank 0's file at ``path`` present on every rank: its bytes go
    over the host group and the other ranks (re)write them atomically, for
    machines whose ranks share no run directory. Collective."""
    if process_count() <= 1:
        return
    primary = is_primary()
    data = b""
    if primary:
        with open(path, "rb") as f:
            data = f.read()
    n = torch.tensor([len(data)], dtype=torch.int64)
    dist.broadcast(n, src=0, group=_host["group"])
    buf = torch.zeros(max(int(n), 1), dtype=torch.uint8)
    if primary and data:
        buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=_host["group"])
    if not primary:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(buf[: int(n)].numpy().tobytes())
        os.replace(tmp, path)


def ensure_checkpoint(path_base: str) -> None:
    """``ensure_file`` for a checkpoint's .npz + .json pair."""
    for ext in (".npz", ".json"):
        ensure_file(path_base + ext)


def barrier_timeout(name: str, seconds: float) -> bool:
    """A barrier that gives up after ``seconds`` and returns False.

    For the crash-retry path: only ranks whose run raised reach the retry
    rendezvous; if the failure was local to some ranks, the others never
    join, and a plain barrier would hang. A False result means the run is
    split: the caller raises. The barrier's thread is left behind, blocked;
    the process is expected to end."""
    if process_count() <= 1:
        return True
    done = threading.Event()

    def sync():
        try:
            dist.barrier(group=_host["group"])
            done.set()
        except RuntimeError:
            pass  # the group failed: the wait below times out

    threading.Thread(target=sync, name=f"barrier_timeout:{name}", daemon=True).start()
    return done.wait(timeout=seconds)
