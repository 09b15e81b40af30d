"""Equirectangular sphere sampling (counterpart of ``reni_tpu/core/sphere.py``).

Grids are built host-side in numpy at float64, exactly as the JAX package
builds them, and moved to the requested device once, in the requested
dtype. Conventions (reference src/utils/utils.py:30-91):

- pixel-center grids with the y-up direction
  ``d = (sin(phi) sin(theta), cos(phi), -sin(phi) cos(theta))``;
- the sin(polar angle) sampling weight;
- HDR tonemapping (nested 98th-percentile normalisation + sRGB OETF).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from reni_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=32)
def _uv_grid(width: int) -> tuple[np.ndarray, np.ndarray]:
    """Pixel-center (u, v) for a ``width`` x ``width // 2`` map, row-major:
    u = (1..W - 0.5) / (W//2), v = (1..H - 0.5) / (W//2)."""
    height = width // 2
    half = width // 2
    u = (np.arange(1, width + 1, dtype=np.float64) - 0.5) / half
    v = (np.arange(1, height + 1, dtype=np.float64) - 0.5) / half
    v_grid, u_grid = np.meshgrid(v, u, indexing="ij")
    uv = np.stack((u_grid, v_grid), -1).reshape(-1, 2)
    return uv[:, 0], uv[:, 1]


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def get_directions(width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit direction of each pixel, shape ``(1, (width//2) * width, 3)``:
    theta = pi*(u-1), phi = pi*v, d = (sin phi sin theta, cos phi,
    -sin phi cos theta)."""
    u, v = _uv_grid(width)
    theta = np.pi * (u - 1.0)
    phi = np.pi * v
    d = np.stack(
        (
            np.sin(phi) * np.sin(theta),
            np.cos(phi),
            -np.sin(phi) * np.cos(theta),
        ),
        -1,
    )
    return _tensor(d[None], dtype, device)


def get_sineweight(width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``sin(phi)`` per pixel, repeated over RGB: ``(1, (width//2)*width, 3)``."""
    _, v = _uv_grid(width)
    s = np.sin(np.pi * v)
    s = np.repeat(s[:, None], 3, axis=1)
    return _tensor(s[None], dtype, device)


def get_solid_angles(width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Exact solid angle of each pixel, shape ``(H*W,)``:
    dtheta * (cos(phi0) - cos(phi1))."""
    height = width // 2
    dtheta = 2.0 * np.pi / width
    phi_edges = np.linspace(0.0, np.pi, height + 1)
    band = dtheta * (np.cos(phi_edges[:-1]) - np.cos(phi_edges[1:]))
    omega = np.repeat(band[:, None], width, axis=1).reshape(-1)
    return _tensor(omega, dtype, device)


def srgb(imgs: torch.Tensor) -> torch.Tensor:
    """HDR display tonemap of ``(B, C, H, W)`` or ``(C, H, W)``: the nested
    98th-percentile normaliser (quantile over axis 1, three times), then the
    piecewise sRGB OETF."""
    if imgs.ndim == 3:
        imgs = imgs[None]
    q = torch.quantile(imgs, 0.98, dim=1)
    q = torch.quantile(q, 0.98, dim=1)
    q = torch.quantile(q, 0.98, dim=1)
    imgs = imgs / q[:, None, None, None]
    imgs = torch.clamp(imgs, 0.0, 1.0)
    return torch.where(
        imgs <= 0.0031308,
        12.92 * imgs,
        1.055 * torch.pow(torch.abs(imgs), 1.0 / 2.4) - 0.055,
    )


def flatten_image(imgs: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W) -> (B, H*W, C)``."""
    b, c, h, w = imgs.shape
    return imgs.permute(0, 2, 3, 1).reshape(b, h * w, c)


def unflatten_image(flat: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(B, H*W, C) -> (B, C, H, W)``."""
    b, _, c = flat.shape
    return flat.reshape(b, height, width, c).permute(0, 3, 1, 2)


def rotation_y(angle_rad: float) -> np.ndarray:
    """Rotation about the +y (up) axis, acting on row vectors ``d @ R``."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], dtype=np.float64)
