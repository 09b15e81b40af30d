"""FiLM-conditioned decoder: init and apply functions (counterpart of
``reni_tpu/models/film.py``).

The mapping network runs once per image on the per-image invariants; the
first FiLM layer's linear part is decomposed like the concat model's.
Frequencies are scaled ``freq * 15 + 30`` and each trunk layer computes
``sin(freq * (x @ w + b) + phase)``.

Initialisation follows the JAX package in distribution: mapping-network
linears kaiming-normal (fan-in, leaky-ReLU(0.2) gain) with the last layer's
weight scaled by 0.25; trunk linears U(+-sqrt(6 / in) / 25) with the first
layer U(+-scale / in); the final linear U(+-sqrt(6 / H) / 25); every bias
U(+-1 / sqrt(in)). The numbers are drawn on the CPU from a
``torch.Generator`` in a fixed order: the trunk layers first to last (weight,
then bias), the final layer, then the mapping network's layers first to
last. They are torch's numbers, not JAX's.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns
from reni_tpu_torch.models.siren import _output_activation, _uniform, init_linear

Params = dict[str, Any]


def _kaiming_leaky(generator: torch.Generator, in_features: int, out_features: int) -> Params:
    """Kaiming-normal weight (fan-in, leaky-ReLU(0.2) gain), uniform bias."""
    std = math.sqrt(2.0 / (1.0 + 0.2**2)) / math.sqrt(in_features)
    return {
        "w": std * torch.randn((in_features, out_features), generator=generator),
        "b": _uniform(generator, (out_features,), 1.0 / math.sqrt(in_features)),
    }


def init_mapping_network(
    generator: torch.Generator, in_features: int, hidden_layers: int, hidden_dim: int,
    out_dim: int,
) -> Params:
    """``hidden_layers`` leaky-ReLU layers and a last linear whose weight
    (not its bias) is scaled by 0.25."""
    layers = []
    fan_in = in_features
    for _ in range(hidden_layers):
        layers.append(_kaiming_leaky(generator, fan_in, hidden_dim))
        fan_in = hidden_dim
    last = _kaiming_leaky(generator, fan_in, out_dim)
    return {"layers": layers, "last": {"w": last["w"] * 0.25, "b": last["b"]}}


def init_film_siren(
    generator: torch.Generator,
    siren_in_features: int,
    mapping_in_features: int,
    hidden_features: int,
    siren_hidden_layers: int,
    mapping_layers: int,
    mapping_features: int,
    out_features: int,
    first_layer_init_scale: float = 1.0,
) -> Params:
    """FiLM decoder params on the CPU: a trunk of ``siren_hidden_layers``
    FiLM layers, a final linear, and the mapping network producing
    2 * T * H modulation values."""
    n_trunk = siren_hidden_layers
    bound = math.sqrt(6.0 / hidden_features) / 25.0
    layers = [
        init_linear(
            generator, siren_in_features, hidden_features,
            first_layer_init_scale / siren_in_features,
        )
    ]
    for _ in range(1, n_trunk):
        layers.append(init_linear(generator, hidden_features, hidden_features, bound))
    final = init_linear(generator, hidden_features, out_features, bound)
    mapping = init_mapping_network(
        generator, mapping_in_features, mapping_layers, mapping_features,
        n_trunk * hidden_features * 2,
    )
    return {"layers": layers, "final": final, "mapping": mapping}


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
    # features in D's dtype, then promoted to Z's, as jnp promotes them
    d_feats = encodings.d_features(equivariance, D).to(Z.dtype)

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
