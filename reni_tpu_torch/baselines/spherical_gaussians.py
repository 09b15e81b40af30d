"""Spherical-Gaussian mixture fitting (analytic baseline): the port's copy
of ``reni_tpu/baselines/spherical_gaussians.py``.

The reference's SG module (src/models/spherical_gaussians.py): fit a K-lobe
spherical-Gaussian mixture to an environment map by gradient descent on the
sine-weighted log-domain MSE (:168-198), with tanh-bounded lobe centres on
the sphere and exp-domain amplitudes and sharpness, the lobes initialised on
a 2 x K/2 equirect grid (:149-166). Rendering: L(d) = sum_k a_k
exp(lambda_k (d.mu_k - 1)) (:109-137).

The JAX package fits with optax's Adam under ``lax.scan``; here
``torch.optim.Adam`` at optax's defaults (b1 0.9, b2 0.999, eps 1e-8) in a
Python loop on the map's device: the same update, rounded in another order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.utils.device import resolve_device


class SGParams(NamedTuple):
    raw_axis: torch.Tensor  # (K, 3) unconstrained; axis = tanh-bounded + renorm
    log_sharpness: torch.Tensor  # (K,)
    log_amplitude: torch.Tensor  # (K, C)


def init_lobes(n_lobes: int = 12, n_channels: int = 3, sharpness: float = 8.0,
               dtype=torch.float32, device=None) -> SGParams:
    """Lobe centers on a 2 x (K/2) equirect grid (reference :149-166), on
    ``device`` (default the card)."""
    rows = 2
    cols = n_lobes // rows
    axes = []
    for i in range(rows):
        phi = np.pi * (i + 0.5) / rows
        for j in range(cols):
            theta = 2 * np.pi * (j + 0.5) / cols - np.pi
            axes.append(
                [np.sin(phi) * np.sin(theta), np.cos(phi), -np.sin(phi) * np.cos(theta)]
            )
    axes = np.asarray(axes, dtype=np.float32)
    dev = resolve_device(device)
    return SGParams(
        raw_axis=torch.tensor(np.arctanh(np.clip(axes, -0.99, 0.99)), dtype=dtype, device=dev),
        log_sharpness=torch.full((n_lobes,), float(np.log(sharpness)), dtype=dtype, device=dev),
        log_amplitude=torch.zeros((n_lobes, n_channels), dtype=dtype, device=dev),
    )


def lobe_axes(params: SGParams) -> torch.Tensor:
    a = torch.tanh(params.raw_axis)
    return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-6)


def render_sg(params: SGParams, directions: torch.Tensor) -> torch.Tensor:
    """Evaluate the mixture at unit directions (P, 3) -> (P, C)."""
    mu = lobe_axes(params)  # (K, 3)
    lam = torch.exp(params.log_sharpness)  # (K,)
    amp = torch.exp(params.log_amplitude)  # (K, C)
    cos = directions @ mu.T  # (P, K)
    g = torch.exp(lam[None, :] * (cos - 1.0))  # (P, K)
    return g @ amp


def _fit(params: SGParams, target_log: torch.Tensor, dirs: torch.Tensor, sw: torch.Tensor,
         steps: int, lr: float) -> tuple[SGParams, torch.Tensor]:
    """``steps`` Adam updates of the sine-weighted log-domain MSE from
    ``params`` -> (fitted params, (steps,) loss before each update)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in params]
    p = SGParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(steps, dtype=target_log.dtype, device=target_log.device)
    for i in range(steps):
        out_log = torch.log(torch.clamp(render_sg(p, dirs), min=1e-8))
        loss = (((out_log - target_log) ** 2) * sw).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return SGParams(*(t.detach() for t in leaves)), losses


def fit_environment(envmap: np.ndarray, n_lobes: int = 12, steps: int = 2000,
                    lr: float = 5e-2, device=None) -> tuple[SGParams, np.ndarray]:
    """Fit a K-lobe SG mixture to an equirect env map (H, W, C) on
    ``device`` (default the card), in float32 with float32 directions and
    sine weights, as the JAX package does. Optimises the sine-weighted
    log-domain MSE (reference :176-178). Returns (params, loss history)."""
    h, w, c = envmap.shape
    assert w == 2 * h
    assert n_lobes % 2 == 0, "lobes arranged on a 2-row grid"
    dev = resolve_device(device)
    dirs = sphere.get_directions(w, device=dev)[0]
    sw = sphere.get_sineweight(w, device=dev)[0]
    target = torch.as_tensor(np.asarray(envmap, np.float32).reshape(-1, c), device=dev)
    target_log = torch.log(torch.clamp(target, min=1e-8))
    params, losses = _fit(init_lobes(n_lobes, c, device=dev), target_log, dirs, sw, steps, lr)
    return params, losses.cpu().numpy()


def sg_representation(envmap: np.ndarray, n_lobes: int = 12, steps: int = 2000,
                      device=None) -> np.ndarray:
    """Fit + re-render at the input resolution (the SG analog of
    get_spherical_harmonic_representation)."""
    h, w, c = envmap.shape
    params, _ = fit_environment(envmap, n_lobes, steps, device=device)
    dirs = sphere.get_directions(w, device=params.raw_axis.device)[0]
    with torch.no_grad():
        return render_sg(params, dirs).cpu().numpy().reshape(h, w, c)
