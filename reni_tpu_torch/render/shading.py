"""Differentiable Blinn-Phong environment-map shading (the port's
counterpart of ``reni_tpu/render/shading.py``), in plain PyTorch.

The reference treats every environment-map pixel as a directional light and
shades via dense (B, H, W, J, 3) half-vector einsums (reference:
src/utils/pytorch3d_envmap_shader.py:46-116). As in the JAX package:

1. the half-vector tensor is never built: for unit V, L,
   ``N . normalize(V+L) = (N.V + N.L) / sqrt(2 + 2 V.L)``, three (H, W, J)
   maps.

The render is linear in the light colors, the only input a fit trains, and
every (pixel, light) factor depends on the static scene and the light
directions alone. So:

2. ``make_render_fn``'s render folds the factors into one light-transport
   matrix T = kd clamp(N.L, 0, 1) + norm ks clamp(N.H, 0, 1)^shininess of
   shape (H*W, J) (``transport_matrix``), built in light chunks at its
   first call for a light set and kept: a render is the product T @ colors
   and its backward T^T @ g, each one read of T;
3. where T would pass the memory budget (``LIGHT_BUDGET_BYTES``), the render
   falls back on ``blinn_phong_env_shading``, which forms the factors at
   every call, the light axis in memory-budgeted chunks, each under
   ``torch.utils.checkpoint``, so the backward recomputes a chunk's (H, W,
   chunk) maps instead of storing them (JAX: ``jax.checkpoint`` in a
   ``lax.scan``, at every call).

Pipeline parity:
- pixel positions and normals by barycentric interpolation of face
  attributes (interpolate_face_attributes, shader.py:67-72), zero on
  background;
- diffuse  = clamp(N . L, 0, 1) summed against the light colors
  (shader.py:86-92);
- specular = clamp(N . H, 0, 1)^shininess with half-vectors against the
  camera eye (shader.py:94-111);
- Blinn-Phong normalisation (s+2)/(4(2-e^{-s/2})) (shader.py:112-114);
- output  = kd * diffuse + norm * ks * specular (shader.py:115);
- light colors are the env map **pre-scaled by sineweight**
  (EnvironmentMap, shader.py:33-43).

Precision. The specular power turns a relative error e of N.H into about
``shininess`` x e (500 e at the published shininess), so the three K = 3
dot products (N.L, V.L, N.V) are elementwise multiply-adds, never a matmul
that TF32 could take, whatever ``torch.backends.cuda.matmul.allow_tf32``
says. T holds the factors as those expressions round them, in the colors'
dtype, never narrower. The shading runs in the dtype of the light colors:
float64 colors promote the (float32) geometry and light directions at
entry, where the JAX package keeps them float32. The light sums (H*W x J) x
(J x 3) are matmuls in that dtype (on the product path one matmul over the
kd and ks terms together). The barycentric interpolation is the chain
fma(b2, a2, fma(b1, a1, b0 a0)), each step rounded once (through float64),
the rounding of XLA's dot on the CPU: the port's float32 pixel geometry is
bitwise the JAX package's. Where a light lies within a few thousandths of a
degree of -V (2 + 2 V.L ~ 1e-7), N.H is ill-conditioned in the float32
inputs themselves, in either formulation: a float32 render's largest pixel
error against float64 is then about 1e-4 of the render, its mean about
1e-5 (``chip_smoke.py``'s TF32 guard holds the mean).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from reni_tpu_torch.render.rasterizer import Fragments
from reni_tpu_torch.utils.device import resolve_device
from reni_tpu_torch.utils.profiling import span

LIGHT_BUDGET_BYTES = 2 << 30
"""The render's memory budget: the chunked path's transient (H, W, chunk)
maps, and the largest transport matrix a render keeps."""


def _pow(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """x ** exponent with square-and-multiply for integer exponents (about
    12 multiplies at 500 instead of exp(e log x)). Exact for x >= 0."""
    e = int(exponent)
    if e != exponent or e < 1 or e > 1 << 16:
        return x**exponent
    result = None
    base = x
    while e:
        if e & 1:
            result = base if result is None else result * base
        base = base * base
        e >>= 1
    return result


def _fma_dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k] y[..., k] over a last axis of 3 (x and y broadcast) as
    fma(x2, y2, fma(x1, y1, x0 y0)): each step's product and sum formed in
    float64 and rounded once to x's dtype."""
    acc = x[..., 0] * y[..., 0]
    for k in (1, 2):
        wide = torch.addcmul(acc.double(), x[..., k].double(), y[..., k].double())
        acc = wide.to(x.dtype)
    return acc


def interpolate_face_attributes(
    pix_to_face: torch.Tensor,  # (H, W) int
    bary_coords: torch.Tensor,  # (H, W, 3)
    face_attrs: torch.Tensor,  # (F, 3, C)
) -> torch.Tensor:
    """Barycentric interpolation of per-face-vertex attributes to pixels,
    zero where pix_to_face < 0 (PyTorch3D interpolate_face_attributes)."""
    safe = torch.clamp(pix_to_face, min=0).long()
    vals = _fma_dot3(bary_coords[..., None, :], face_attrs[safe].transpose(-1, -2))
    return vals * (pix_to_face >= 0)[..., None]


def pixel_geometry(
    fragments: Fragments, face_verts: np.ndarray, face_normals: np.ndarray, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world positions and unit normals (both zero on background),
    float32 on ``device`` (default: the card). face_verts / face_normals:
    (F, 3, 3) world space."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    p2f = torch.as_tensor(np.asarray(fragments.pix_to_face), device=dev)
    bary = f32(fragments.bary_coords)
    positions = interpolate_face_attributes(p2f, bary, f32(face_verts))
    normals = interpolate_face_attributes(p2f, bary, f32(face_normals))
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    return positions, normals / torch.clamp(norm, min=1e-6)


def default_light_chunk(h: int, w: int, j_total: int) -> int:
    """Largest light chunk whose (H, W, chunk) float32 intermediates (about
    four live maps) fit ``LIGHT_BUDGET_BYTES``."""
    per_light = h * w * 4 * 4
    return max(128, min(j_total, LIGHT_BUDGET_BYTES // per_light))


def _view_terms(normals, positions, camera_pos, light_dirs, dtype):
    """(N, V, N.V, light_dirs) in ``dtype``; N and V (H, W, 1, 3)."""
    normals, positions, camera_pos, light_dirs = (
        t.to(dtype) for t in (normals, positions, camera_pos, light_dirs))
    view = camera_pos[None, None, :] - positions
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-6)
    ndotv = (normals * view).sum(-1)  # (H, W), chunk-invariant
    return normals[:, :, None, :], view[:, :, None, :], ndotv, light_dirs


def _light_factors(n_, v_, ndotv, dirs, shininess):
    """(N.L, clamp(N.H, 0, 1)^shininess), each (H, W, c), of the lights
    ``dirs`` (c, 3)."""

    def dot(x, d):  # (H, W, 1, 3) . (c, 3) -> (H, W, c), as multiply-adds
        return x[..., 0] * d[:, 0] + x[..., 1] * d[:, 1] + x[..., 2] * d[:, 2]

    ndotl = dot(n_, dirs)
    vdotl = dot(v_, dirs)
    # N.normalize(V+L) = (N.V + N.L) / sqrt(2 + 2 V.L) for unit V, L. fp
    # rounding can push V.L slightly below -1: clamp inside the sqrt (the
    # sqrt of a negative would poison the whole render with NaN)
    inv_norm = 1.0 / torch.sqrt(torch.clamp(2.0 + 2.0 * vdotl, min=1e-12))
    ndoth = torch.clamp((ndotv[..., None] + ndotl) * inv_norm, 0.0, 1.0)
    return ndotl, _pow(ndoth, shininess)


def _norm_factor(shininess: float) -> float:
    """Blinn-Phong's normalisation (s + 2) / (4 (2 - e^{-s/2}))."""
    return (shininess + 2.0) / (4.0 * (2.0 - math.exp(-shininess / 2.0)))


def blinn_phong_env_shading(
    normals: torch.Tensor,  # (H, W, 3) unit, zero on background
    positions: torch.Tensor,  # (H, W, 3) world
    camera_pos: torch.Tensor,  # (3,)
    light_dirs: torch.Tensor,  # (J, 3) unit (env-map pixel directions)
    light_colors: torch.Tensor,  # (B, J, 3) radiance * sineweight
    *,
    kd: float,
    ks: float,
    shininess: float = 500.0,
    chunk: int | None = None,
) -> torch.Tensor:
    """-> (B, H, W, 3) renders, computed in the colors' dtype, the factors
    formed at every call. chunk=None picks a memory-aware size."""
    dtype = light_colors.dtype
    n_, v_, ndotv, light_dirs = _view_terms(normals, positions, camera_pos, light_dirs, dtype)
    j_total = light_dirs.shape[0]
    h, w = ndotv.shape
    if chunk is None:
        chunk = default_light_chunk(h, w, j_total)
    b = light_colors.shape[0]

    def body(dirs, colors):
        # dirs (c, 3), colors (B, c, 3) -> (diffuse, specular) (B, H, W, 3)
        ndotl, spec = _light_factors(n_, v_, ndotv, dirs, shininess)
        diff = torch.einsum("hwj,bjk->bhwk", torch.clamp(ndotl, 0.0, 1.0), colors)
        return diff, torch.einsum("hwj,bjk->bhwk", spec, colors)

    recompute = torch.is_grad_enabled() and light_colors.requires_grad
    diffuse = torch.zeros((b, h, w, 3), dtype=dtype, device=light_colors.device)
    specular = torch.zeros_like(diffuse)
    for j0 in range(0, j_total, chunk):
        args = (light_dirs[j0 : j0 + chunk], light_colors[:, j0 : j0 + chunk])
        diff, spec = checkpoint(body, *args, use_reentrant=False) if recompute else body(*args)
        diffuse = diffuse + diff
        specular = specular + spec
    return kd * diffuse + _norm_factor(shininess) * ks * specular


def transport_matrix(
    normals: torch.Tensor,  # (H, W, 3) unit, zero on background
    positions: torch.Tensor,  # (H, W, 3) world
    camera_pos: torch.Tensor,  # (3,)
    light_dirs: torch.Tensor,  # (J, 3) unit
    *,
    kd: float,
    ks: float,
    shininess: float = 500.0,
    dtype: torch.dtype = torch.float32,
    chunk: int | None = None,
) -> torch.Tensor:
    """-> T (H*W, J) in ``dtype``, kd clamp(N.L, 0, 1) + norm ks clamp(N.H,
    0, 1)^shininess: ``blinn_phong_env_shading``'s render of one map's colors
    (J, 3) is T @ colors. The factors are that function's expressions,
    formed in light chunks (chunk=None: ``default_light_chunk``); background
    rows are zero."""
    n_, v_, ndotv, light_dirs = _view_terms(normals, positions, camera_pos, light_dirs, dtype)
    j_total = light_dirs.shape[0]
    h, w = ndotv.shape
    if chunk is None:
        chunk = default_light_chunk(h, w, j_total)
    spec_weight = _norm_factor(shininess) * ks
    t = torch.empty((h, w, j_total), dtype=dtype, device=ndotv.device)
    for j0 in range(0, j_total, chunk):
        ndotl, spec = _light_factors(n_, v_, ndotv, light_dirs[j0 : j0 + chunk], shininess)
        t[:, :, j0 : j0 + chunk] = kd * torch.clamp(ndotl, 0.0, 1.0) + spec_weight * spec
    return t.view(h * w, j_total)


def make_render_fn(
    fragments: Fragments,
    face_verts: np.ndarray,
    face_normals: np.ndarray,
    camera_pos: np.ndarray,
    *,
    kd: float,
    shininess: float = 500.0,
    chunk: int | None = None,
    device=None,
):
    """Bind the static scene on ``device`` (default: the card); return
    render(envmaps (B, P, 3) *unnormalised*, sineweight (B, P, 3), light_dirs
    (P, 3), rows=None) -> (B, H, W, 3), or with ``rows`` (a slice of H)
    those rows of it: a mesh rank renders its slice of the image.

    The render keeps the transport matrix T of the newest light set it
    rendered (``transport_matrix``, all H*W rows, in the colors' dtype),
    built at the set's first call; a light set of another shape, dtype or
    device, or with other directions, replaces it. A render is then
    T[rows] @ colors, under the span ``render.transport``. Where T's bytes
    would pass ``LIGHT_BUDGET_BYTES``, the render keeps no T and shades
    through ``blinn_phong_env_shading``, under the span ``render.chunked``."""
    positions, normals = pixel_geometry(fragments, face_verts, face_normals, device)
    cam = torch.as_tensor(np.asarray(camera_pos, dtype=np.float32), device=positions.device)
    ks = 1.0 - kd
    h, w = normals.shape[:2]
    held = None  # (key, light_dirs, T) of the newest light set

    def transport(light_dirs, dtype):
        nonlocal held
        key = (tuple(light_dirs.shape), light_dirs.dtype, light_dirs.device, dtype)
        if held is not None and held[0] == key and (
                held[1] is light_dirs or torch.equal(held[1], light_dirs)):
            held = (key, light_dirs, held[2])  # the next call finds it by identity
        else:
            held = None  # free the old T before the new one is built
            held = (key, light_dirs, transport_matrix(
                normals, positions, cam, light_dirs, kd=kd, ks=ks, shininess=shininess,
                dtype=dtype, chunk=chunk))
        return held[2]

    def render(envmaps: torch.Tensor, sineweight: torch.Tensor, light_dirs: torch.Tensor,
               rows: slice = slice(None)):
        nonlocal held
        colors = envmaps * sineweight  # EnvironmentMap pre-scaling
        b, j = colors.shape[:2]
        if h * w * j * colors.element_size() > LIGHT_BUDGET_BYTES:
            held = None
            with span("render.chunked"):
                return blinn_phong_env_shading(
                    normals[rows], positions[rows], cam, light_dirs, colors,
                    kd=kd, ks=ks, shininess=shininess, chunk=chunk,
                )
        with span("render.transport"):
            t = transport(light_dirs, colors.dtype).view(h, w, j)[rows]
            r = t.shape[0]
            flat = colors.permute(1, 0, 2).reshape(j, 3 * b)  # (J, 3B)
            out = t.reshape(r * w, j) @ flat  # (rows * W, 3B)
            return out.view(r, w, b, 3).permute(2, 0, 1, 3).contiguous()

    return render
