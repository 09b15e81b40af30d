"""The inverse task's scene and renderer in plain NumPy and PyTorch.

``load_obj``, ``vertex_normals``, ``look_at``, ``fov_project`` and
``rasterize`` are frozen copies of the port's ``render/mesh.py`` and of
``render/rasterizer.py``'s numpy rasterizer (itself a copy of PyTorch3D's
settings in the RENI reference code: one face a pixel, no blur, screen-space
barycentrics, a FoV 60 camera at distance 2 looking at the origin). They are
copied so that the reference works the fragments out again without the
program's code; the program rasterizes with its own C++ library.

``shade`` is the Blinn-Phong environment shading of the RENI reference code
(``src/utils/pytorch3d_envmap_shader.py``): every map pixel a directional
light of colour radiance x sin(polar angle), the half vector
normalize(V + L) formed explicitly, diffuse clamp(N.L) and specular
clamp(N.H)^500 with the Blinn-Phong normalisation, over the pixels the mesh
covers, lights in chunks."""

from __future__ import annotations

import math

import numpy as np
import torch


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) float32, triangle faces (F, 3) int32) of an OBJ file."""
    verts, faces = [], []
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
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int32)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, normalised."""
    fv = verts[faces]
    face_n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], face_n)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def _normalize(v):
    return v / np.maximum(np.linalg.norm(v), 1e-12)


def look_at(dist: float, elev_deg: float = 0.0, azim_deg: float = 0.0):
    """(R, T, eye) with view = world @ R + T (PyTorch3D's axes)."""
    az, el = math.radians(azim_deg), math.radians(elev_deg)
    eye = np.array([dist * math.sin(az) * math.cos(el), dist * math.sin(el),
                    dist * math.cos(el) * math.cos(az)], dtype=np.float64)
    up = np.array([0.0, 1.0, 0.0])
    z_axis = _normalize(-eye)
    x_axis = _normalize(np.cross(up, z_axis))
    y_axis = _normalize(np.cross(z_axis, x_axis))
    r = np.stack((x_axis, y_axis, z_axis), axis=1)
    return r.astype(np.float32), (-eye @ r).astype(np.float32), eye.astype(np.float32)


def fov_project(verts_view: np.ndarray, fov_deg: float = 60.0) -> np.ndarray:
    s = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    z = verts_view[:, 2:3]
    return np.concatenate((s * verts_view[:, :2] / z, z), axis=1).astype(np.float32)


def rasterize(verts_ndc, faces, size: int, znear: float = 1e-8, chunk: int = 512):
    """(pix_to_face (H, W) int32, -1 off the mesh; barycentrics (H, W, 3))."""
    px = 1.0 - (2.0 * np.arange(size) + 1.0) / size
    pxg, pyg = np.meshgrid(px, px)
    p = np.stack((pxg, pyg), -1).reshape(-1, 2)
    n_pix = size * size
    zbuf = np.full((n_pix,), np.inf, dtype=np.float32)
    p2f = np.full((n_pix,), -1, dtype=np.int32)
    bary = np.zeros((n_pix, 3), dtype=np.float32)
    tv = verts_ndc[faces]
    for f0 in range(0, faces.shape[0], chunk):
        t = tv[f0: f0 + chunk]
        a, b, c = t[:, 0, :2], t[:, 1, :2], t[:, 2, :2]
        zs = t[:, :, 2]
        area = (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1]) - (c[:, 1] - a[:, 1]) * (b[:, 0] - a[:, 0])
        ok = np.abs(area) > 1e-12
        inv_area = np.where(ok, 1.0 / np.where(ok, area, 1.0), 0.0)

        def edge(u, v):
            d = v - u
            return ((p[None, :, 0] - u[:, None, 0]) * d[:, None, 1]
                    - (p[None, :, 1] - u[:, None, 1]) * d[:, None, 0])

        w0 = edge(b, c) * inv_area[:, None]
        w1 = edge(c, a) * inv_area[:, None]
        w2 = edge(a, b) * inv_area[:, None]
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[:, None]
        z = w0 * zs[:, 0:1] + w1 * zs[:, 1:2] + w2 * zs[:, 2:3]
        z = np.where(inside & (z > znear), z, np.inf)
        best = np.argmin(z, axis=0)
        best_z = z[best, np.arange(n_pix)]
        upd = best_z < zbuf
        cols = np.where(upd)[0]
        zbuf[upd] = best_z[upd].astype(np.float32)
        p2f[upd] = (f0 + best[upd]).astype(np.int32)
        bary[upd] = np.stack((w0[best[upd], cols], w1[best[upd], cols],
                              w2[best[upd], cols]), -1).astype(np.float32)
    return p2f.reshape(size, size), bary.reshape(size, size, 3)


class Scene:
    """The covered pixels' positions and unit normals (float32 on
    ``device``), the camera eye and the image size."""

    def __init__(self, obj_path: str, size: int, device, dist: float = 2.0):
        verts, faces = load_obj(obj_path)
        vn = vertex_normals(verts, faces)
        r, t, eye = look_at(dist)
        p2f, bary = rasterize(fov_project(verts @ r + t), faces, size)
        hit = p2f >= 0
        f = p2f[hit]
        b = bary[hit].astype(np.float64)
        pos = np.einsum("pk,pkc->pc", b, verts[faces[f]].astype(np.float64))
        nrm = np.einsum("pk,pkc->pc", b, vn[faces[f]].astype(np.float64))
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-6)
        self.size = size
        self.index = torch.as_tensor(np.flatnonzero(hit.reshape(-1)), device=device)
        self.positions = torch.as_tensor(pos, dtype=torch.float32, device=device)
        self.normals = torch.as_tensor(nrm, dtype=torch.float32, device=device)
        self.eye = torch.as_tensor(eye, dtype=torch.float32, device=device)

    @property
    def covered(self) -> int:
        return int(self.index.numel())


def shade(scene: Scene, light_dirs: torch.Tensor, colors: torch.Tensor, *, kd: float,
          shininess: float = 500.0, chunk: int = 2048) -> torch.Tensor:
    """Renders (B, H, W, 3), zero off the mesh, of lights ``light_dirs`` (J,
    3) with colours (B, J, 3) (radiance x sin(polar angle))."""
    n, pos = scene.normals, scene.positions
    view = scene.eye[None, :] - pos
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-6)
    out = 0.0
    for j0 in range(0, light_dirs.shape[0], chunk):
        l = light_dirs[j0: j0 + chunk]
        c = colors[:, j0: j0 + chunk]
        ndotl = torch.clamp((n[:, None, :] * l[None]).sum(-1), 0.0, 1.0)
        half = view[:, None, :] + l[None]
        half = half / torch.clamp(torch.linalg.norm(half, dim=-1, keepdim=True), min=1e-6)
        ndoth = torch.clamp((n[:, None, :] * half).sum(-1), 0.0, 1.0)
        spec = ndoth**shininess
        out = out + kd * torch.einsum("pj,bjk->bpk", ndotl, c) + (
            (shininess + 2.0) / (4.0 * (2.0 - math.exp(-shininess / 2.0))) * (1.0 - kd)
            * torch.einsum("pj,bjk->bpk", spec, c))
    img = torch.zeros((colors.shape[0], scene.size * scene.size, 3), dtype=colors.dtype,
                      device=colors.device)
    img = img.index_copy(1, scene.index, out)
    return img.reshape(colors.shape[0], scene.size, scene.size, 3)
