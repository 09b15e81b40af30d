"""Operations and bytes of the model's work, counted from its shapes, and
the card's published peaks.

The counts read the work the model needs, whatever implements it: no
padding, no recomputation, no layout of the program's passes. A roofline or
mfu share built on them cannot pass 100% unless the time leaves out work.

``step_flops_per_pixel`` is a frozen copy of ``chip_smoke.py::bwd_flops``
plus the final layer's forward, as ``chip_smoke.py`` counts the train step
(1.6357 / 1.3100 ms at 100 x 8,192 at 989 TFLOP/s for the Zoo's
Cond-by-Concat / FiLM 5 x 256). It is copied so that the yardstick lives
with the benchmark, where a change to the program cannot move it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# direction features of the decomposed first layer (SO2: D_x, D_z, |D_xz|, D_y)
D_FEATURES = {"SO2": 4, "SO3": 3, "None": 3}


def hidden_products(model: dict) -> int:
    """Hidden H x H products of the trunk: FiLM's trunk has one layer fewer
    (``hidden_layers`` counts its first layer)."""
    film = model["conditioning"] == "FiLM"
    return model["hidden_layers"] - 1 if film else model["hidden_layers"]


def bwd_flops(model: dict, weight_grads: bool) -> float:
    """FLOP per pixel of a backward, counted without padding: the forward
    again without its final layer, g @ Wf^T, every dz @ W^T and d^T dz0,
    and with weight gradients h^T dz for each hidden product and h^T g
    (``chip_smoke.py::bwd_flops``)."""
    H = model["hidden_features"]
    k = D_FEATURES[model["equivariance"]]
    n_out = model["out_features"]
    n_mm = hidden_products(model)
    flops = 2 * (k * H + n_mm * H * H)  # forward again
    flops += 2 * n_out * H + 2 * n_mm * H * H + 2 * k * H  # g Wf^T, dz W^T, d^T dz0
    if weight_grads:
        flops += 2 * n_mm * H * H + 2 * H * n_out
    return float(flops)


def step_flops_per_pixel(model: dict, weight_grads: bool = True) -> float:
    """A training step's FLOP per pixel: the forward once, the backward
    (with or without the weight gradients), the final layer's forward."""
    return bwd_flops(model, weight_grads) + 2.0 * model["out_features"] * model["hidden_features"]


def fit_decoder_step(model: dict, batch: int, pixels: int) -> dict:
    """A FIT_DECODER step of ``batch`` maps x ``pixels`` directions: its
    FLOP (bf16 tensor-core work) and its least bytes (the targets read once,
    the weights read and their gradients and Adam's two moments written in
    float32; the latent rows of the batch likewise)."""
    flops = batch * pixels * step_flops_per_pixel(model)
    H, n_mm = model["hidden_features"], hidden_products(model)
    k, n_out, N = D_FEATURES[model["equivariance"]], model["out_features"], model["latent_dim"]
    weights = n_mm * (H * H + H) + H * n_out + n_out + k * H
    nbytes = 4 * batch * pixels * n_out + 4 * 4 * weights + 4 * 4 * 2 * batch * N * 3
    return {"flops": flops, "bytes": float(nbytes),
            "least_s": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)}


def pow_multiplies(exponent: int) -> int:
    """Multiplies of x ** exponent by squaring (``render/shading.py::_pow``):
    the squarings and the products of the set bits."""
    return exponent.bit_length() - 1 + bin(exponent).count("1") - 1


def shading_flops(covered: int, lights: int, batch: int, shininess: int = 500) -> float:
    """FLOP of the Blinn-Phong environment shading forward, and its backward
    into the light colours, over the ``covered`` pixels the rasterizer hits:
    for each (pixel, light) N.L (3 multiplies, 2 adds), its clamp (2), V.L
    (5), the half-vector's inverse norm (multiply, add, clamp, sqrt, divide),
    N.H (add, multiply, clamp 2), its power by squaring, and the diffuse and
    specular light sums (2 x 2 x 3 a map); the backward into the colours is
    the two light sums again. Nothing recomputed is counted."""
    per = 5 + 2 + 5 + 5 + 4 + pow_multiplies(shininess)
    sums = 2 * 2 * 3 * batch
    return float(covered) * lights * (per + 2 * sums)


def fit_inverse_step(model: dict, batch: int, lights: int, covered: int,
                     shininess: int = 500) -> dict:
    """A FIT_INVERSE step: the frozen decoder's forward and its backward into
    the latents at ``batch`` x ``lights`` directions (bf16 tensor-core work),
    and the shading (float32 outside the tensor cores). ``least_s`` takes each
    part at its own precision's peak."""
    dec = batch * lights * step_flops_per_pixel(model, weight_grads=False)
    shade = shading_flops(covered, lights, batch, shininess)
    return {"flops": dec + shade, "decoder_flops": dec, "shading_flops": shade,
            "least_s": dec / PEAK_BF16_FLOPS + shade / PEAK_F32_FLOPS}
