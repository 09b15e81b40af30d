"""Polynomial sine/cosine for the SIREN trunk (counterpart of
``reni_tpu/core/fastmath.py``).

``fast_sin`` reduces the argument to [-pi/2, pi/2] with a two-term
Cody-Waite split of pi and evaluates a degree-9 odd polynomial (Cephes
coefficients); ``fast_cos`` uses the same reduction with a degree-10 even
polynomial. Max abs error 3.6e-6 (sin) / 8e-7 (cos) for |x| <= ~1e3.

The same constants and operation order are used by the CUDA device
functions in ``kernels/csrc/siren_fwd.cu``. ``torch.round`` rounds half to
even, as ``jnp.round`` does (the CUDA side uses ``rintf``).
"""

from __future__ import annotations

import numpy as np
import torch

# float32 values, held as Python floats (exact); torch casts a Python scalar
# to the tensor's float32 dtype, so arithmetic matches the float32 constants
_PI_HI = float(np.float32(3.140625))  # high bits of pi (exact in 12 bits)
_PI_LO = float(np.float32(9.67653589793e-4))  # pi - _PI_HI
_INV_PI = float(np.float32(1.0 / np.pi))
# degree-9 odd minimax polynomial for sin on [-pi/2, pi/2] (Cephes sinf)
_S3 = float(np.float32(-1.6666667e-01))
_S5 = float(np.float32(8.3333310e-03))
_S7 = float(np.float32(-1.9840874e-04))
_S9 = float(np.float32(2.7525562e-06))
# degree-10 even Taylor polynomial for cos on [-pi/2, pi/2]
_C2 = float(np.float32(-0.5))
_C4 = float(np.float32(1.0 / 24.0))
_C6 = float(np.float32(-1.0 / 720.0))
_C8 = float(np.float32(1.0 / 40320.0))
_C10 = float(np.float32(-1.0 / 3628800.0))


def _reduce(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, sign): r = x - k*pi in [-pi/2, pi/2], sign = (-1)^k."""
    k = torch.round(x * _INV_PI)
    r = (x - k * _PI_HI) - k * _PI_LO
    half = k * 0.5
    sign = 1.0 - 4.0 * (half - torch.floor(half))
    return r, sign


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) to ~3.6e-6 abs error for |x| <= ~1e3."""
    r, sign = _reduce(x)
    r2 = r * r
    p = ((_S9 * r2 + _S7) * r2 + _S5) * r2 + _S3
    return (r + r * (r2 * p)) * sign


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) to ~8e-7 abs error for |x| <= ~1e3."""
    r, sign = _reduce(x)
    r2 = r * r
    p = (((_C10 * r2 + _C8) * r2 + _C6) * r2 + _C4) * r2 + _C2
    return (1.0 + r2 * p) * sign


def fast_sincos(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin(x), cos(x)) sharing one range reduction."""
    r, sign = _reduce(x)
    r2 = r * r
    ps = ((_S9 * r2 + _S7) * r2 + _S5) * r2 + _S3
    pc = (((_C10 * r2 + _C8) * r2 + _C6) * r2 + _C4) * r2 + _C2
    return (r + r * (r2 * ps)) * sign, (1.0 + r2 * pc) * sign


def _exact_sincos(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.sin(x), torch.cos(x)


def sine_fns(fast: bool):
    """(sin, cos) implementation pair for the ``fast_sine`` knob."""
    return (fast_sin, fast_cos) if fast else (torch.sin, torch.cos)


def sincos_fns(fast: bool):
    """Joint (sin, cos) evaluator for the ``fast_sine`` knob."""
    return fast_sincos if fast else _exact_sincos
