"""RENI's decoder, its FIT_DECODER and FIT_INVERSE losses and Adam, in plain
PyTorch (RENI, Gardner et al., NeurIPS 2022; the reference code's
``src/models/RENI.py`` and ``src/utils/loss_functions.py``).

The SO2-invariant encoding of Cond-by-Concat feeds a linear first layer, so
it is applied here as that layer's rows split by feature, the same sums as
the (B, P, 2N + N^2 + 2) concat without building it: the innerproduct rows
against the per-pixel D_xz, the Gram and Z_y rows as a per-image bias, the
|D_xz| and D_y rows per pixel. ``quant`` computes every product of the trunk
from inputs rounded to a narrower type (the control: per-tensor scaled fp8
e4m3, a float32 sum), and is None for the reference itself.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

def no_tf32() -> None:
    """Float32 products in float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to an fp8 type under one per-tensor scale (its largest
    magnitude onto the type's largest finite value), in float32."""
    amax = x.abs().max().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b from e4m3 operands with a float32 sum; the backward's products
    from e5m2 gradients and the e4m3 operands (the usual fp8 training
    recipe)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return (_sum_to(qg @ qb.transpose(-1, -2), qa.shape),
                _sum_to(qa.transpose(-1, -2) @ qg, qb.shape))


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast product's gradient summed back to its operand's shape."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: the decoder in fp8, the nearest precision
    below the configuration's bf16."""
    return _Fp8Matmul.apply(a, b)


def directions(width: int, device) -> torch.Tensor:
    """(1, W/2 * W, 3) pixel-centre directions of an equirectangular map,
    y up: d = (sin phi sin theta, cos phi, -sin phi cos theta), theta =
    pi (u - 1), phi = pi v, u and v the pixel centres over W/2; float64 on
    the host, then float32 (RENI's ``get_directions``)."""
    h, half = width // 2, width // 2
    u = (np.arange(1, width + 1, dtype=np.float64) - 0.5) / half
    v = (np.arange(1, h + 1, dtype=np.float64) - 0.5) / half
    vg, ug = np.meshgrid(v, u, indexing="ij")
    theta, phi = np.pi * (ug.reshape(-1) - 1.0), np.pi * vg.reshape(-1)
    d = np.stack((np.sin(phi) * np.sin(theta), np.cos(phi), -np.sin(phi) * np.cos(theta)), -1)
    return torch.as_tensor(d[None], dtype=torch.float32, device=device)


def sineweight(width: int, device) -> torch.Tensor:
    """(1, W/2 * W, 3) sin(phi) of each pixel over RGB."""
    h, half = width // 2, width // 2
    v = (np.arange(1, h + 1, dtype=np.float64) - 0.5) / half
    s = np.repeat(np.repeat(np.sin(np.pi * v), width)[:, None], 3, axis=1)
    return torch.as_tensor(s[None], dtype=torch.float32, device=device)


def _mm(a: torch.Tensor, b: torch.Tensor, matmul) -> torch.Tensor:
    return a @ b if matmul is None else matmul(a, b)


def _so2(Z: torch.Tensor, D: torch.Tensor, quant):
    """(per-pixel D_xz (.., P, 2), |D_xz| (.., P, 1), D_y (.., P, 1), Z_xz
    (B, N, 2), the per-image Gram of Z_xz flattened (B, N^2), Z_y (B, N))."""
    d_xz = torch.stack((D[..., 0], D[..., 2]), -1)
    d_n = torch.sqrt(D[..., 0] ** 2 + D[..., 2] ** 2)[..., None]
    z_xz = torch.stack((Z[..., 0], Z[..., 2]), -1)
    gram = _mm(z_xz, z_xz.transpose(1, 2), quant).reshape(Z.shape[0], -1)
    return d_xz, d_n, D[..., 1:2], z_xz, gram, Z[..., 1]


def decode(model: dict, dec: dict, Z: torch.Tensor, D: torch.Tensor, quant=None) -> torch.Tensor:
    """Radiance (B, P, 3) at directions D (1, P, 3) for latents Z (B, N, 3)."""
    N = model["latent_dim"]
    d_xz, d_n, d_y, z_xz, gram, z_y = _so2(Z, D, quant)
    if model["conditioning"] == "FiLM":
        return _decode_film(model, dec, d_xz, d_n, d_y, z_xz, gram, z_y, quant)
    w0, b0 = dec["layers"][0]["w"], dec["layers"][0]["b"]
    w_ip, w_g = w0[:N], w0[N: N + N * N]
    w_dn, w_zy, w_dy = w0[N + N * N: N + N * N + 1], w0[N + N * N + 1: 2 * N + N * N + 1], w0[-1:]
    # innerprod (B, P, N) = D_xz . Z_xz; its product with w_ip, per image
    a = _mm(z_xz.transpose(1, 2), w_ip, quant)  # (B, 2, H)
    pre = _mm(d_xz, a, quant) + _mm(d_n, w_dn, quant) + _mm(d_y, w_dy, quant)
    pre = pre + (_mm(gram, w_g, quant) + _mm(z_y, w_zy, quant) + b0)[:, None, :]
    h = torch.sin(model["first_omega_0"] * pre)
    for layer in dec["layers"][1:]:
        h = torch.sin(model["hidden_omega_0"] * (_mm(h, layer["w"], quant) + layer["b"]))
    out = _mm(h, dec["final"]["w"], quant) + dec["final"]["b"]
    return torch.tanh(out)


def _decode_film(model, dec, d_xz, d_n, d_y, z_xz, gram, z_y, quant):
    H = model["hidden_features"]
    x = torch.cat((gram, z_y), 1)
    for layer in dec["mapping"]["layers"]:
        x = F.leaky_relu(_mm(x, layer["w"], quant) + layer["b"], negative_slope=0.2)
    mod = _mm(x, dec["mapping"]["last"]["w"], quant) + dec["mapping"]["last"]["b"]
    half = mod.shape[-1] // 2
    freqs, phases = mod[:, :half] * 15.0 + 30.0, mod[:, half:]
    w0, b0 = dec["layers"][0]["w"], dec["layers"][0]["b"]
    # siren input [|D_xz|, D_y, innerprod]
    a = _mm(z_xz.transpose(1, 2), w0[2:], quant)
    pre = _mm(d_xz, a, quant) + _mm(d_n, w0[0:1], quant) + _mm(d_y, w0[1:2], quant) + b0
    h = None
    for i, layer in enumerate(dec["layers"]):
        if i:
            pre = _mm(h, layer["w"], quant) + layer["b"]
        cols = slice(i * H, (i + 1) * H)
        h = torch.sin(freqs[:, None, cols] * pre + phases[:, None, cols])
    out = _mm(h, dec["final"]["w"], quant) + dec["final"]["b"]
    return torch.tanh(out)


def weighted_mse(out, target, sw) -> torch.Tensor:
    """Mean over pixels and channels of each map, summed over the batch."""
    se = (out - target) ** 2 * sw
    return se.reshape(se.shape[0], -1).mean(dim=1).sum()


def kld(mu, log_var, z_dims: int) -> torch.Tensor:
    k = -0.5 * (1 + log_var - mu**2 - torch.exp(log_var)).reshape(mu.shape[0], -1).sum(dim=1)
    return (k / z_dims).sum()


def unnormalise(x: torch.Tensor, minmax) -> torch.Tensor:
    """The HDR dataset's log-domain min-max normalisation undone."""
    lo, hi = minmax
    return torch.exp(0.5 * (x + 1.0) * (hi - lo) + lo)


def exp_schedule(lr_start: float, lr_end: float, epochs: int, steps_per_epoch: int
                 ) -> Callable[[int], float]:
    """The exponential LR decay, staircase per epoch, in float32: the LR of
    update ``count`` (the number of earlier updates)."""
    gamma = math.exp(math.log(lr_end / lr_start) / epochs)
    init = torch.tensor(lr_start, dtype=torch.float32)
    rate = torch.tensor(gamma, dtype=torch.float32)

    def lr(count: int) -> float:
        if count <= 0:
            return float(init)
        p = torch.tensor(float(count // steps_per_epoch), dtype=torch.float32)
        return float(init * rate**p)

    return lr


class Adam:
    """Adam over named float32 leaves (eps 1e-8, bias-corrected), holding
    each leaf's moments; ``step(grads, lr)`` updates the leaves in place."""

    def __init__(self, leaves: dict, beta1: float, beta2: float, eps: float = 1e-8):
        self.leaves, self.b1, self.b2, self.eps = leaves, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, p in self.leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict / list tree, paths as ``decoder/layers/0/w``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    return {k: v for key, sub in items for k, v in flatten(sub, f"{prefix}{key}/").items()}


def unflatten_like(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def noise_draws(seed_generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """One step's N(0, 1) VAD noise drawn on the host from the task's
    generator in the latents' dtype, as the trainer draws it."""
    return torch.empty(shape, dtype=dtype).normal_(generator=seed_generator)
