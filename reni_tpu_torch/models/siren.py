"""SIREN trunk init and apply functions (counterpart of
``reni_tpu/models/siren.py``).

Weights follow the JAX package: ``y = x @ w + b`` with ``w`` of shape
(in, out). Parameters are the same nested dict
``{"layers": [{"w", "b"}, ...], "final": {"w", "b"}}`` of tensors.

The first layer is applied *decomposed*: it is linear in the concat
encoding, so its weight splits by input rows into a per-pixel part (width
<= 4) and a per-image part folded into a bias,

    x_concat @ w1 = d_feats @ w_pix(Z) + bias(Z),

and the ``(B, npix, 2N + N^2 + 2)`` concat is never built. First-layer
weights stay in the canonical concat layout (``core.encodings``).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator, shape, bound: float, dtype=torch.float32):
    """U(-bound, bound), drawn on the CPU from ``generator``."""
    return (torch.rand(shape, generator=generator, dtype=dtype) * 2.0 - 1.0) * bound


def init_linear(
    generator: torch.Generator, in_features: int, out_features: int, w_bound: float
) -> Params:
    return {
        "w": _uniform(generator, (in_features, out_features), w_bound),
        "b": _uniform(generator, (out_features,), 1.0 / math.sqrt(in_features)),
    }


def init_siren(
    generator: torch.Generator,
    in_features: int,
    hidden_features: int,
    hidden_layers: int,
    out_features: int,
    last_layer_linear: bool,
    first_omega_0: float,
    hidden_omega_0: float,
    first_layer_init_scale: float = 1.0,
) -> Params:
    """Initialise the SIREN stack on the CPU: 1 first sine layer,
    ``hidden_layers`` hidden sine layers and a final layer. The first-layer
    bound is ``first_layer_init_scale / in``, the others
    ``sqrt(6 / hidden) / hidden_omega_0``; biases ``1 / sqrt(in)``."""
    layers = [
        init_linear(
            generator, in_features, hidden_features, first_layer_init_scale / in_features
        )
    ]
    hidden_bound = math.sqrt(6.0 / hidden_features) / hidden_omega_0
    for _ in range(hidden_layers):
        layers.append(init_linear(generator, hidden_features, hidden_features, hidden_bound))
    final = init_linear(generator, hidden_features, out_features, hidden_bound)
    return {"layers": layers, "final": final}


# ---------------------------------------------------------------------------
# first-layer weight split
# ---------------------------------------------------------------------------


def split_first_layer(
    w1: torch.Tensor, equivariance: str, ndims: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Split the concat-layout first-layer weight into
    (w_innerprod (N, h), w_bias (m, h), w_direct (k, h) | None).

    ``w_direct`` covers the direction-only features (|D_xz| and D_y for
    SO2); None when there are none."""
    n = ndims
    if equivariance == "SO3":
        return w1[:n], w1[n : n + n * n], None
    if equivariance == "SO2":
        w_ip = w1[:n]
        w_g = w1[n : n + n * n]
        w_dn = w1[n + n * n : n + n * n + 1]
        w_zy = w1[n + n * n + 1 : n + n * n + 1 + n]
        w_dy = w1[n + n * n + 1 + n :]
        w_bias = torch.cat((w_g, w_zy), 0)  # matches [G_flat, Z_y]
        w_direct = torch.cat((w_dn, w_dy), 0)  # matches [|D_xz|, D_y]
        return w_ip, w_bias, w_direct
    if equivariance == "None":
        return w1[:n], w1[n:], None
    raise ValueError(f"unknown equivariance {equivariance!r}")


def first_layer_pre(
    layer: Params,
    equivariance: str,
    ndims: int,
    d_feats: torch.Tensor,
    parts: dict,
) -> torch.Tensor:
    """First-layer pre-activation via the decomposed path.

    d_feats: (B or 1, npix, k) from `encodings.d_features`; parts from
    `encodings.z_parts`. Returns (B, npix, hidden)."""
    w_ip, w_bias, w_direct = split_first_layer(layer["w"], equivariance, ndims)
    a = torch.einsum("bcn,nh->bch", parts["proj"], w_ip)  # (B, c, hidden)
    c = a.shape[1]
    pre = torch.matmul(d_feats[..., :c], a)
    if w_direct is not None:
        pre = pre + d_feats[..., c:] @ w_direct
    bias = parts["bias_feats"] @ w_bias + layer["b"]
    return pre + bias[:, None, :]


def _output_activation(x: torch.Tensor, name: str | None) -> torch.Tensor:
    if name == "exp":
        return torch.exp(x)
    if name == "tanh":
        return torch.tanh(x)
    return x


def apply_trunk(
    params: Params,
    h: torch.Tensor,
    last_layer_linear: bool,
    output_activation: str | None,
    hidden_omega_0: float,
    sine=torch.sin,
) -> torch.Tensor:
    """Hidden sine layers + final layer, given first-layer activations h."""
    for layer in params["layers"][1:]:
        h = sine(hidden_omega_0 * (h @ layer["w"] + layer["b"]))
    out = h @ params["final"]["w"] + params["final"]["b"]
    if not last_layer_linear:
        out = sine(hidden_omega_0 * out)
    return _output_activation(out, output_activation)


def apply_siren_decomposed(
    params: Params,
    equivariance: str,
    ndims: int,
    Z: torch.Tensor,
    D: torch.Tensor,
    *,
    last_layer_linear: bool,
    output_activation: str | None,
    first_omega_0: float,
    hidden_omega_0: float,
    fast_sine: bool = False,
) -> torch.Tensor:
    """Decoder forward on Z (B, N, 3) and D (B or 1, npix, 3) via the
    decomposed first layer. Returns (B, npix, out)."""
    sine, _ = sine_fns(fast_sine)
    # features in D's dtype, then promoted to Z's, as jnp promotes them (no
    # cast where they agree: torch.export would pin the tracing device to it)
    d_feats = encodings.d_features(equivariance, D)
    if d_feats.dtype != Z.dtype:
        d_feats = d_feats.to(Z.dtype)
    parts = encodings.z_parts(equivariance, Z)
    pre = first_layer_pre(params["layers"][0], equivariance, ndims, d_feats, parts)
    h = sine(first_omega_0 * pre)
    return apply_trunk(
        params, h, last_layer_linear, output_activation, hidden_omega_0, sine
    )


def apply_siren_concat(
    params: Params,
    x: torch.Tensor,
    *,
    last_layer_linear: bool,
    output_activation: str | None,
    first_omega_0: float,
    hidden_omega_0: float,
) -> torch.Tensor:
    """Reference-parity forward on a pre-built concat encoding x (B, npix, in)."""
    layer0 = params["layers"][0]
    h = torch.sin(first_omega_0 * (x @ layer0["w"] + layer0["b"]))
    return apply_trunk(params, h, last_layer_linear, output_activation, hidden_omega_0)
