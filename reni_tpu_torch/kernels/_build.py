"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/reni_tpu_torch/<name>-<hash>.so`` at the
repository root, keyed by a hash of the source and the flags, then loaded
with ``ctypes``. The build happens at first use, never at import. A failed
build raises; there is no fallback. Threads may build at once
(``train/precompile.py`` builds in the background): one library name is
built by one thread at a time, into a temporary file of that thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reni_tpu_torch"
# no --use_fast_math: it would turn sinf into __sinf, which has no range
# reduction (SIREN pre-activations reach |x| ~ 200)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_building: dict[str, threading.Lock] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (the hash covers the source, the
    shared headers ``csrc/*.cuh`` and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def name_lock(name: str) -> threading.Lock:
    """The lock one library name is built under (shared with the g++ builds
    of ``render/rasterizer.py`` and ``data/exr.py``)."""
    with _lock:
        return _building.setdefault(name, threading.Lock())


def temporary(out: Path) -> Path:
    """A temporary name beside ``out`` of this process and thread."""
    return out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's report (registers, shared memory, spills) is kept in a
    ``.log`` beside the library. The build notes the trainer's progress
    before and after (``utils/progress.py``)."""
    from reni_tpu_torch.utils import progress

    out = library_path(name)
    if out.exists():
        return out
    with name_lock(name):
        if out.exists():  # another thread built it meanwhile
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = temporary(out)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        progress.note(f"nvcc {name}")
        res = subprocess.run(cmd, capture_output=True, text=True)
        progress.note(f"nvcc {name} done")
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib = _loaded.get(name)
    if lib is None:
        path = build(name)
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
