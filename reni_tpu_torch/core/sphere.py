"""Equirectangular sphere sampling (counterpart of ``reni_tpu/core/sphere.py``).

Grids are built host-side in numpy at float64, exactly as the JAX package
builds them, and moved to the requested device once, in the requested
dtype. Conventions (reference src/utils/utils.py:30-91):

- pixel-center grids with the y-up direction
  ``d = (sin(phi) sin(theta), cos(phi), -sin(phi) cos(theta))``;
- the sin(polar angle) sampling weight;
- HDR tonemapping (nested 98th-percentile normalisation + sRGB OETF);
- in-painting masks read from PNG files with a small decoder of their own
  (stdlib ``zlib``; the port does not need PIL) and resized with PIL's
  NEAREST rule.
"""

from __future__ import annotations

import functools
import struct
import zlib

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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(filt: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One PNG scanline (uint8) with its filter undone, given the previous
    unfiltered line. None, Sub and Up run as numpy operations (a sum modulo
    256 along the row or down the column); Average and Paeth depend on the
    pixel just undone, so they go byte by byte."""
    if filt == 0:
        return line
    if filt == 2:
        return line + prev  # uint8 arithmetic wraps modulo 256
    if filt == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if filt not in (3, 4):
        raise ValueError(f"bad PNG filter type {filt}")
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if filt == 3:
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        else:
            up_left = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], up_left)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as uint8 (H, W) (grayscale) or
    (H, W, C): grey, grey + alpha, RGB or RGBA, any of the five filter
    types. Other bit depths, palettes and interlacing raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are read "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})"
        )
    bpp = _PNG_CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    try:
        for y in range(height):
            out[y] = prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    arr = out.reshape(height, width, bpp)
    return arr[..., 0] if bpp == 1 else arr


def _nearest(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index of each output pixel: floor((x + 0.5) *
    n_in / n_out), the pixel centre."""
    src = np.floor((np.arange(n_out) + 0.5) * (n_in / n_out)).astype(np.int64)
    return np.minimum(src, n_in - 1)


def get_mask(width: int, path: str, dtype=torch.float32, device=None) -> torch.Tensor:
    """A mask PNG resized (nearest) to ``(width // 2, width)``, in [0, 1], as
    ``(1, (width//2)*width, 3)``."""
    img = read_png(path)
    height = width // 2
    img = img[_nearest(img.shape[0], height)][:, _nearest(img.shape[1], width)]
    arr = img.astype(np.float64)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.max() > 1.0:
        arr = arr / 255.0
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    arr = arr[..., :3]
    return _tensor(arr.reshape(1, height * width, 3), dtype, device)


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
