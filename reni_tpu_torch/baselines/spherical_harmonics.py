"""Spherical-harmonics environment-map toolkit (analytic baseline): the
port's copy of ``reni_tpu/baselines/spherical_harmonics.py``.

The reference's SH module (src/models/spherical_harmonics.py): real SH
basis evaluation, projection of an equirectangular map onto SH coefficients
with exact solid-angle quadrature (:174-204), reconstruction (:433-437),
Sloan windowing (:207-270), the Ramamoorthi-Hanrahan Lambertian diffuse
convolution (:418-481) and the order / coefficient-count helpers that match
an SH budget to a RENI latent dimension (:811-821). Used for paper
comparisons; not part of the training path.

One basis serves both halves: ``sh_basis_torch`` builds it from the
associated Legendre recurrences (P_m^m, P_{m+1}^m, then the three-term
l-recurrence, with the Condon-Shortley phase) in torch, on any device and
dtype, differentiable with respect to the directions. The numpy host
functions (``sh_basis``, ``project_environment``, ``reconstruct``, ...)
call it in float64 on the CPU; the JAX package's host path calls scipy's
``lpmv`` there instead, and the two agree to about 5e-15 up to order 10.
The ``*_torch`` functions are the differentiable device path (JAX's
``*_jnp``).

Convention: y-up equirectangular directions, polar angle from +y, azimuth
about y; coefficient (l, m) at column l(l+1)+m, m in [-l, l]; the pixel
directions are the float32 grid of ``core.sphere``, the quadrature weights
its float32 solid angles, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reni_tpu_torch.core import sphere


def num_coeffs(lmax: int) -> int:
    """(lmax+1)^2 — reference calcNumSHCoeffs (:811-813)."""
    return (lmax + 1) ** 2


def sh_order_from_budget(ndims: int) -> int:
    """Largest order whose coefficient count fits a RENI latent budget of
    ndims (reference get_sh_order, :816-821)."""
    order = 0
    while num_coeffs(order + 1) <= ndims:
        order += 1
    return order


def sh_basis_torch(lmax: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions (P, 3) -> (P, (lmax+1)^2), in the
    dtype and on the device of ``dirs``; orthonormal under the solid-angle
    measure, differentiable with respect to ``dirs``."""
    x = dirs[:, 1].clamp(-1.0, 1.0)  # cos polar (y-up)
    az = torch.atan2(dirs[:, 0], -dirs[:, 2])  # azimuth matching equirect theta
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))  # sin polar

    cols: list = [None] * num_coeffs(lmax)
    sqrt2 = math.sqrt(2.0)
    pmm = torch.ones_like(x)
    for m in range(lmax + 1):
        if m > 0:
            pmm = pmm * (-(2 * m - 1)) * s  # (-1)^m (2m-1)!! sin^m
        p_prev2 = p_prev1 = None  # P_{l-2}^m, P_{l-1}^m
        for l in range(m, lmax + 1):
            if l == m:
                p = pmm
            elif l == m + 1:
                p = x * (2 * m + 1) * pmm
            else:
                p = (x * (2 * l - 1) * p_prev1 - (l + m - 1) * p_prev2) / (l - m)
            p_prev2, p_prev1 = p_prev1, p
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                cols[l * (l + 1)] = k * p
            else:
                cols[l * (l + 1) + m] = sqrt2 * k * torch.cos(m * az) * p
                cols[l * (l + 1) - m] = sqrt2 * k * torch.sin(m * az) * p
    return torch.stack(cols, dim=-1)


def sh_basis(lmax: int, dirs: np.ndarray) -> np.ndarray:
    """``sh_basis_torch`` in float64 on the CPU, for numpy directions (P,
    3) -> (P, (lmax+1)^2)."""
    d = torch.as_tensor(np.asarray(dirs, dtype=np.float64))
    return sh_basis_torch(lmax, d).numpy()


def _grid(width: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, 3) float32 pixel directions and (P,) float32 solid angles."""
    return (sphere.get_directions(width, device=device)[0],
            sphere.get_solid_angles(width, device=device))


def project_environment(img: np.ndarray, lmax: int) -> np.ndarray:
    """Project an equirect env map (H, W, C) onto SH coefficients
    ((lmax+1)^2, C) with exact solid-angle quadrature (reference
    getCoefficientsFromImage, :174-204)."""
    h, w, c = img.shape
    assert w == 2 * h, "equirectangular maps must be 2:1"
    dirs, omega = (t.numpy() for t in _grid(w, "cpu"))
    basis = sh_basis(lmax, dirs)  # (P, K)
    flat = img.reshape(-1, c)
    return basis.T @ (flat * omega[:, None])


def reconstruct(coeffs: np.ndarray, width: int) -> np.ndarray:
    """SH coefficients (K, C) -> equirect image (width//2, width, C)
    (reference shReconstructSignal, :433-437)."""
    k = coeffs.shape[0]
    lmax = int(math.isqrt(k)) - 1
    assert num_coeffs(lmax) == k, f"{k} is not a square"
    basis = sh_basis(lmax, _grid(width, "cpu")[0].numpy())
    out = basis @ coeffs
    return out.reshape(width // 2, width, coeffs.shape[1])


def sh_representation(img: np.ndarray, n_bands: int) -> np.ndarray:
    """Project + reconstruct at the image's resolution — the reference's
    top-level get_spherical_harmonic_representation (:823-830)."""
    coeffs = project_environment(img, n_bands)
    return reconstruct(coeffs, img.shape[1])


# ---------------------------------------------------------------------------
# differentiable device path (the reference torch port, :690-809)
# ---------------------------------------------------------------------------


def project_environment_torch(img: torch.Tensor, lmax: int) -> torch.Tensor:
    """Differentiable SH projection: (H, W, C) or (P, C) env radiance ->
    ((lmax+1)^2, C) coefficients, exact solid-angle quadrature, in the dtype
    and on the device of ``img``. Gradients flow to ``img`` (e.g. a decoded
    RENI env map)."""
    if img.dim() == 3:
        h, w, c = img.shape
        flat = img.reshape(h * w, c)
    else:
        flat = img
        w = int(math.isqrt(flat.shape[0] * 2))
    dirs, omega = _grid(w, img.device)
    basis = sh_basis_torch(lmax, dirs.to(img.dtype))
    return basis.T @ (flat * omega[:, None])


def reconstruct_torch(coeffs: torch.Tensor, width: int) -> torch.Tensor:
    """Differentiable SH reconstruction: (K, C) -> (width//2, width, C), in
    the dtype and on the device of ``coeffs``."""
    k = coeffs.shape[0]
    lmax = int(math.isqrt(k)) - 1
    assert num_coeffs(lmax) == k, f"{k} is not a square"
    basis = sh_basis_torch(lmax, _grid(width, coeffs.device)[0].to(coeffs.dtype))
    return (basis @ coeffs).reshape(width // 2, width, coeffs.shape[1])


# ---------------------------------------------------------------------------
# windowing & diffuse convolution
# ---------------------------------------------------------------------------


def _per_band(coeffs: np.ndarray):
    lmax = int(math.isqrt(coeffs.shape[0])) - 1
    for l in range(lmax + 1):
        yield l, slice(l * l, (l + 1) * (l + 1))


def window_sloan(coeffs: np.ndarray, window_l: float) -> np.ndarray:
    """Sloan's cosine-lobe style low-pass window: scale band l by
    cos(pi/2 * l / window_l) clipped at 0 (reference applyWindowing
    family, :207-270) — suppresses ringing from hard truncation."""
    out = coeffs.copy()
    for l, sl in _per_band(coeffs):
        w = math.cos(math.pi / 2.0 * l / window_l) if l <= window_l else 0.0
        out[sl] *= max(w, 0.0)
    return out


_A_HAT = [math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0]


def diffuse_convolution(coeffs: np.ndarray) -> np.ndarray:
    """Lambertian BRDF convolution in SH (Ramamoorthi & Hanrahan 2001):
    scale band l by hat{A}_l / pi with hat{A} = [pi, 2pi/3, pi/4, 0, ...]
    for l <= 2 and the closed form for even l > 2."""
    out = coeffs.copy()
    for l, sl in _per_band(coeffs):
        if l < len(_A_HAT):
            a = _A_HAT[l]
        elif l % 2 == 1:
            a = 0.0
        else:
            a = (
                2.0 * math.pi * (-1.0) ** (l // 2 - 1) / (l + 2) / (l - 1)
                * math.factorial(l) / (2**l * math.factorial(l // 2) ** 2)
            )
        out[sl] *= a / math.pi
    return out


def irradiance_map(img: np.ndarray, width: int | None = None) -> np.ndarray:
    """Order-2 irradiance environment map of an env map (the classic 9-coeff
    diffuse lighting approximation)."""
    width = width or img.shape[1]
    coeffs = project_environment(img, 2)
    return reconstruct(diffuse_convolution(coeffs), width)
