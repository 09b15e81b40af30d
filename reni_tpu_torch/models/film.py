"""FiLM-conditioned decoder apply functions (counterpart of
``reni_tpu/models/film.py``).

The mapping network runs once per image on the per-image invariants; the
first FiLM layer's linear part is decomposed like the concat model's.
Frequencies are scaled ``freq * 15 + 30`` and each trunk layer computes
``sin(freq * (x @ w + b) + phase)``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns
from reni_tpu_torch.models.siren import _output_activation

Params = dict[str, Any]


def apply_mapping_network(
    params: Params, z: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, in) -> (frequencies (B, T*h), phase_shifts (B, T*h))."""
    h = z
    for layer in params["layers"]:
        h = F.leaky_relu(h @ layer["w"] + layer["b"], negative_slope=0.2)
    out = h @ params["last"]["w"] + params["last"]["b"]
    half = out.shape[-1] // 2
    return out[..., :half], out[..., half:]


def _first_film_pre(
    layer: Params, equivariance: str, d_feats: torch.Tensor, proj: torch.Tensor
) -> torch.Tensor:
    """Decomposed pre-activation of the first FiLM layer. The SO2 siren
    input is ordered [|D_xz|, D_y, innerprod]; SO3/None are innerprod."""
    w = layer["w"]
    if equivariance == "SO2":
        a = torch.einsum("bcn,nh->bch", proj, w[2:])  # (B, 2, h)
        pre = torch.matmul(d_feats[..., :2], a)
        pre = pre + d_feats[..., 2:] @ w[:2]
    else:
        a = torch.einsum("bcn,nh->bch", proj, w)
        pre = torch.matmul(d_feats, a)
    return pre + layer["b"]


def apply_film_decomposed(
    params: Params,
    equivariance: str,
    Z: torch.Tensor,
    D: torch.Tensor,
    *,
    hidden_features: int,
    output_activation: str | None,
    fast_sine: bool = False,
) -> torch.Tensor:
    """FiLM decoder forward: Z (B, N, 3), D (B or 1, npix, 3) -> (B, npix, out)."""
    sine, _ = sine_fns(fast_sine)
    parts = encodings.z_parts(equivariance, Z)
    freqs, phases = apply_mapping_network(params["mapping"], parts["bias_feats"])
    freqs = freqs * 15.0 + 30.0
    d_feats = encodings.d_features(equivariance, D)

    h = None
    for i, layer in enumerate(params["layers"]):
        lo, hi = i * hidden_features, (i + 1) * hidden_features
        if i == 0:
            pre = _first_film_pre(layer, equivariance, d_feats, parts["proj"])
        else:
            pre = h @ layer["w"] + layer["b"]
        h = sine(freqs[:, None, lo:hi] * pre + phases[:, None, lo:hi])
    out = h @ params["final"]["w"] + params["final"]["b"]
    return _output_activation(out, output_activation)


def apply_film_concat(
    params: Params,
    siren_in: torch.Tensor,
    mapping_in: torch.Tensor,
    *,
    hidden_features: int,
    output_activation: str | None,
) -> torch.Tensor:
    """Reference-parity forward on pre-built FiLM inputs:
    siren_in (B, npix, s), mapping_in (B, m)."""
    freqs, phases = apply_mapping_network(params["mapping"], mapping_in)
    freqs = freqs * 15.0 + 30.0
    h = siren_in
    for i, layer in enumerate(params["layers"]):
        lo, hi = i * hidden_features, (i + 1) * hidden_features
        pre = h @ layer["w"] + layer["b"]
        h = torch.sin(freqs[:, None, lo:hi] * pre + phases[:, None, lo:hi])
    out = h @ params["final"]["w"] + params["final"]["b"]
    return _output_activation(out, output_activation)
