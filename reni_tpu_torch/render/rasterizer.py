"""Rasterization front end (the port's counterpart of
``reni_tpu/render/rasterizer.py``): the host C++ rasterizer, and a numpy
rasterizer as the tests' oracle.

Produces PyTorch3D-style fragments (pix_to_face, barycentrics, zbuf) for the
reference's rasterizer settings: 1 face a pixel, no blur, screen-space
barycentrics (reference: src/utils/pytorch3d_envmap_shader.py:197-208).

``csrc/rasterizer.cpp`` is built with ``g++ -O3 -shared -fPIC`` (the JAX
package's flags, so the fragments are bitwise its own) at first use into
``build/reni_tpu_torch/rasterizer-<hash>.so`` at the repository root, keyed
by a hash of the source and the flags, and loaded with ``ctypes``. A failed
build raises: unlike the JAX package's ``backend="auto"``, nothing falls
back to numpy unless ``backend="numpy"`` asks for it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from reni_tpu_torch.render.mesh import Mesh, fov_project, look_at

SOURCE = Path(__file__).resolve().parent / "csrc" / "rasterizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reni_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


@dataclasses.dataclass
class Fragments:
    pix_to_face: np.ndarray  # (H, W) int32, -1 = background
    bary_coords: np.ndarray  # (H, W, 3) float32
    zbuf: np.ndarray  # (H, W) float32 (inf = background)


def library_path() -> Path:
    """Where ``csrc/rasterizer.cpp`` builds to (the hash covers the source
    and the flags)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"rasterizer-{digest}.so"


def build() -> Path:
    """Compile the rasterizer unless its library is already built; raises
    RuntimeError with the compiler's output when ``g++`` fails."""
    from reni_tpu_torch.kernels import _build
    from reni_tpu_torch.utils import progress

    out = library_path()
    if out.exists():
        return out
    with _build.name_lock(str(out)):
        if out.exists():  # another thread built it meanwhile
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _build.temporary(out)
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            progress.note("g++ rasterizer")
            res = subprocess.run(cmd, capture_output=True, text=True)
            progress.note("g++ rasterizer done")
        except FileNotFoundError as e:
            raise RuntimeError(f"the rasterizer needs g++: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
        return out


def library() -> ctypes.CDLL:
    """The loaded rasterizer, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rasterize_mesh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ]
            lib.rasterize_mesh.restype = None
            _lib = lib
        return _lib


def rasterize_ndc(
    verts_ndc: np.ndarray,
    faces: np.ndarray,
    height: int,
    width: int,
    znear: float = 1e-8,
    backend: str = "native",
) -> Fragments:
    """Rasterize NDC-space verts (x_ndc, y_ndc, z_view) to fragments, with
    the C++ rasterizer (``backend="native"``) or the numpy one
    (``"numpy"``)."""
    if backend not in ("native", "numpy"):
        raise ValueError(f"backend {backend!r}: 'native' or 'numpy'")
    verts_ndc = np.ascontiguousarray(verts_ndc, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    if faces.size and (faces.min() < 0 or faces.max() >= verts_ndc.shape[0]):
        raise ValueError(f"face indices outside [0, {verts_ndc.shape[0]})")
    if backend == "numpy":
        return _rasterize_numpy(verts_ndc, faces, height, width, znear)
    pix = np.empty((height, width), dtype=np.int32)
    bary = np.empty((height, width, 3), dtype=np.float32)
    zbuf = np.empty((height, width), dtype=np.float32)
    library().rasterize_mesh(
        verts_ndc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        verts_ndc.shape[0], faces.shape[0], height, width, float(np.float32(znear)),
        pix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bary.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        zbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return Fragments(pix, bary, zbuf)


def _rasterize_numpy(
    verts_ndc, faces, height: int, width: int, znear: float, chunk: int = 512
) -> Fragments:
    """Vectorised numpy z-buffer rasterizer (the tests' oracle)."""
    px = 1.0 - (2.0 * np.arange(width) + 1.0) / width  # x_ndc per column
    py = 1.0 - (2.0 * np.arange(height) + 1.0) / height  # y_ndc per row
    pxg, pyg = np.meshgrid(px, py)  # (H, W)
    p = np.stack((pxg, pyg), -1).reshape(-1, 2)  # (P, 2)

    n_pix = height * width
    zbuf = np.full((n_pix,), np.inf, dtype=np.float32)
    pix_to_face = np.full((n_pix,), -1, dtype=np.int32)
    bary = np.zeros((n_pix, 3), dtype=np.float32)

    tv = verts_ndc[faces]  # (F, 3, 3)
    for f0 in range(0, faces.shape[0], chunk):
        t = tv[f0 : f0 + chunk]  # (c, 3, 3)
        a, b, c = t[:, 0, :2], t[:, 1, :2], t[:, 2, :2]
        zs = t[:, :, 2]  # (c, 3)
        # signed area with the same orientation as the edge() helper:
        # area = edge(a, b, c) = cross(c - a, b - a)
        area = (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1]) - (
            c[:, 1] - a[:, 1]
        ) * (b[:, 0] - a[:, 0])
        ok = np.abs(area) > 1e-12
        inv_area = np.where(ok, 1.0 / np.where(ok, area, 1.0), 0.0)

        def edge(u, v):
            d = v - u  # (c, 2)
            return (
                (p[None, :, 0] - u[:, None, 0]) * d[:, None, 1]
                - (p[None, :, 1] - u[:, None, 1]) * d[:, None, 0]
            )  # (c, P)

        w0 = edge(b, c) * inv_area[:, None]
        w1 = edge(c, a) * inv_area[:, None]
        w2 = edge(a, b) * inv_area[:, None]
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[:, None]
        z = w0 * zs[:, 0:1] + w1 * zs[:, 1:2] + w2 * zs[:, 2:3]  # (c, P)
        z = np.where(inside & (z > znear), z, np.inf)
        best = np.argmin(z, axis=0)  # (P,)
        best_z = z[best, np.arange(n_pix)]
        upd = best_z < zbuf
        zbuf[upd] = best_z[upd].astype(np.float32)
        pix_to_face[upd] = (f0 + best[upd]).astype(np.int32)
        bary[upd] = np.stack(
            (
                w0[best[upd], np.where(upd)[0]],
                w1[best[upd], np.where(upd)[0]],
                w2[best[upd], np.where(upd)[0]],
            ),
            -1,
        ).astype(np.float32)

    return Fragments(
        pix_to_face.reshape(height, width),
        bary.reshape(height, width, 3),
        zbuf.reshape(height, width),
    )


def rasterize_world(
    mesh: Mesh,
    image_size: int,
    *,
    dist: float = 2.0,
    elev: float = 0.0,
    azim: float = 0.0,
    fov_deg: float = 60.0,
    backend: str = "native",
) -> tuple[Fragments, np.ndarray]:
    """World mesh + look_at camera -> (fragments, camera eye position).

    The reference's build_renderer set-up: look_at_view_transform(dist,
    elev, azim) and a default FoVPerspectiveCameras
    (pytorch3d_envmap_shader.py:195-217)."""
    r, t, eye = look_at(dist, elev, azim)
    verts_view = mesh.verts @ r + t
    verts_ndc = fov_project(verts_view, fov_deg)
    frags = rasterize_ndc(verts_ndc, mesh.faces, image_size, image_size, backend=backend)
    return frags, eye
