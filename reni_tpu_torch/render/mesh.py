"""Triangle meshes and camera math for the inverse task (the port's own
copy of ``reni_tpu/render/mesh.py``; the port imports nothing of the JAX
package).

Replaces the PyTorch3D pieces the reference leans on (reference:
src/utils/pytorch3d_envmap_shader.py:179-218):

- `load_obj`: OBJ parsing (v / f lines, v//vn and v/vt/vn face syntax,
  negative indices, fan triangulation of polygons);
- `vertex_normals`: area-weighted vertex normals (PyTorch3D's
  accumulate-face-cross-products-then-normalise scheme);
- `rotate_y`: RotateAxisAngle(angle, "Y") on points;
- `look_at`: look_at_view_transform(dist, elev, azim) — world-to-view R, T
  with PyTorch3D's axis conventions (+X left, +Y up, +Z into the screen,
  camera looking at the origin);
- `fov_project`: FoVPerspectiveCameras NDC projection (default fov=60).

All host-side numpy, with the JAX package's operations in its order, so the
results are bitwise its own: meshes and cameras are static inputs; the
differentiable path (``render/shading.py``) consumes only the fragments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Mesh:
    verts: np.ndarray  # (V, 3) float32, world space
    faces: np.ndarray  # (F, 3) int32

    @property
    def face_verts(self) -> np.ndarray:  # (F, 3, 3)
        return self.verts[self.faces]


def load_obj(path: str) -> Mesh:
    """Parse an OBJ file to (verts, triangle faces). Ignores materials,
    textures and normals (normals are recomputed, as the reference's
    pipeline does via Meshes.verts_normals_packed)."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(
        np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)
    )


def vertex_normals(mesh: Mesh) -> np.ndarray:
    """Area-weighted vertex normals: each face's (unnormalised) normal is
    added to its three vertices, then the sums are normalised — PyTorch3D's
    verts_normals_packed semantics."""
    fv = mesh.face_verts
    face_n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = np.zeros_like(mesh.verts)
    for k in range(3):
        np.add.at(vn, mesh.faces[:, k], face_n)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def rotate_y(points: np.ndarray, angle_deg: float) -> np.ndarray:
    """RotateAxisAngle(angle, "Y").transform_points: row-vector convention
    p' = p @ R with R the standard +Y rotation matrix transposed for rows."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    # torch3d transform_points computes p @ M^T with M the column matrix;
    # net effect on row vectors:
    r = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], dtype=np.float32)
    return points @ r


def look_at(
    dist: float, elev_deg: float = 0.0, azim_deg: float = 0.0,
    at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PyTorch3D look_at_view_transform: returns (R, T, eye) with
    view = world @ R + T. Camera eye from spherical angles:
    (d sin(az) cos(el), d sin(el), d cos(el) cos(az))."""
    az, el = math.radians(azim_deg), math.radians(elev_deg)
    eye = np.array(
        [
            dist * math.sin(az) * math.cos(el),
            dist * math.sin(el),
            dist * math.cos(el) * math.cos(az),
        ],
        dtype=np.float64,
    ) + np.asarray(at, dtype=np.float64)
    at = np.asarray(at, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    z_axis = _normalize(at - eye)
    x_axis = _normalize(np.cross(up, z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    # R columns are the camera axes (world @ R -> view coords)
    r = np.stack((x_axis, y_axis, z_axis), axis=1)
    t = -eye @ r
    return r.astype(np.float32), t.astype(np.float32), eye.astype(np.float32)


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v), 1e-12)


def fov_project(
    verts_view: np.ndarray, fov_deg: float = 60.0, znear: float = 1.0
) -> np.ndarray:
    """View-space -> NDC (x, y, z_view). FoVPerspectiveCameras with aspect 1:
    x_ndc = x / (tan(fov/2) z), y_ndc = y / (tan(fov/2) z). z kept as view
    depth for the z-buffer (perspective_correct=False path)."""
    s = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    z = verts_view[:, 2:3]
    xy = s * verts_view[:, :2] / z
    return np.concatenate((xy, z), axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# procedural test meshes (the repo ships no copied assets)
# ---------------------------------------------------------------------------


def make_uv_sphere(n_lat: int = 16, n_lon: int = 32, radius: float = 1.0) -> Mesh:
    verts = []
    for i in range(n_lat + 1):
        phi = math.pi * i / n_lat
        for j in range(n_lon):
            theta = 2 * math.pi * j / n_lon
            verts.append(
                [
                    radius * math.sin(phi) * math.cos(theta),
                    radius * math.cos(phi),
                    radius * math.sin(phi) * math.sin(theta),
                ]
            )
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    return Mesh(
        np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)
    )


def make_torus(
    n_major: int = 24, n_minor: int = 12, r_major: float = 0.7, r_minor: float = 0.3
) -> Mesh:
    verts, faces = [], []
    for i in range(n_major):
        a = 2 * math.pi * i / n_major
        for j in range(n_minor):
            b = 2 * math.pi * j / n_minor
            verts.append(
                [
                    (r_major + r_minor * math.cos(b)) * math.cos(a),
                    r_minor * math.sin(b),
                    (r_major + r_minor * math.cos(b)) * math.sin(a),
                ]
            )
    for i in range(n_major):
        for j in range(n_minor):
            a0 = i * n_minor + j
            a1 = i * n_minor + (j + 1) % n_minor
            b0 = ((i + 1) % n_major) * n_minor + j
            b1 = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            faces.append([a0, a1, b0])
            faces.append([a1, b1, b0])
    return Mesh(
        np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)
    )
