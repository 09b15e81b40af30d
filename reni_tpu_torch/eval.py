"""Evaluation harness (the port's counterpart of ``reni_tpu/eval.py``): the
measured comparisons of the BASELINE.json protocol, in display space.

- ``reconstruction_psnr``: test-set PSNR (and SSIM) after FIT_LATENT: decode
  each latent, unnormalise both sides, tonemap HDR with the reference's
  sRGB, compare in [0, 1];
- ``equivariance_eval``: reconstruct a *rotated* environment map via the
  latent rotation Z @ R_y and compare against the pixel-rolled decode and
  ground truth (an equirectangular map is periodic in azimuth, so a rotation
  by whole columns has an exact ground truth);
- ``inpainting_eval``: PSNR inside (observed) and outside (hallucinated) a
  mask after masked latent fitting;
- ``inverse_recovery_eval``: FIT_INVERSE's recovery through the renderer.

Functions of (model, params, images) on the device of the images; decodes
run without gradients (on the card: the forward kernel). Per-image results
are numpy arrays, means Python floats, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIModel


def _display(flat, res, unnormalise, is_hdr):
    h, w = res
    imgs = sphere.unflatten_image(flat, h, w)
    if unnormalise is not None:
        imgs = unnormalise(imgs)
    if is_hdr:
        imgs = sphere.srgb(imgs)
    return torch.clamp(imgs, 0.0, 1.0)


def psnr_per_image(pred, target) -> np.ndarray:
    mse = torch.mean((pred - target) ** 2, dim=tuple(range(1, pred.ndim)))
    return (10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))).cpu().numpy()


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter2_valid(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 2-D correlation with a 1-D window, 'valid' padding, over
    the last two axes of img (..., H, W). The Gaussian window is symmetric,
    so correlation is convolution (Wang's ssim.m uses filter2)."""
    k = win.shape[0]

    def conv1d(a, axis):
        n = a.shape[axis]
        out = 0.0
        for i in range(k):
            out = out + win[i] * a.narrow(axis, i, n - k + 1)
        return out

    return conv1d(conv1d(img, -2), -1)


def ssim_per_image(pred, target, *, data_range: float = 1.0) -> np.ndarray:
    """Structural similarity (Wang et al. 2004), the paper's second metric:
    11x11 Gaussian window, sigma = 1.5, K1 = 0.01, K2 = 0.03, population
    covariance, 'valid' padding (the reference MATLAB ssim.m, and
    skimage.metrics.structural_similarity(gaussian_weights=True,
    use_sample_covariance=False)); per channel, averaged.

    pred / target: (S, C, H, W) in display space [0, data_range], tensors
    or arrays."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    if pred.shape[-2] < 11 or pred.shape[-1] < 11:
        raise ValueError(
            f"ssim needs images >= 11x11 (the Gaussian window); got "
            f"{pred.shape[-2]}x{pred.shape[-1]}"
        )
    win = _gaussian_window(device=pred.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_x = _filter2_valid(pred, win)
    mu_y = _filter2_valid(target, win)
    xx = _filter2_valid(pred * pred, win) - mu_x * mu_x
    yy = _filter2_valid(target * target, win) - mu_y * mu_y
    xy = _filter2_valid(pred * target, win) - mu_x * mu_y

    s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
    )
    return torch.mean(s, dim=tuple(range(1, s.ndim))).cpu().numpy()


@torch.no_grad()
def reconstruction_psnr(
    model: RENIModel,
    params,
    images: torch.Tensor,
    res: tuple[int, int],
    *,
    unnormalise=None,
    is_hdr: bool = False,
) -> dict:
    """PSNR (and, from 11x11 up, SSIM) of the latent table's decodes against
    the dataset images (S, H*W, 3), normalised as trained on."""
    directions = sphere.get_directions(res[1], device=images.device)
    out = model.apply_idx(params, list(range(images.shape[0])), directions)
    pred = _display(out, res, unnormalise, is_hdr)
    target = _display(images, res, unnormalise, is_hdr)
    per = psnr_per_image(pred, target)
    report = {"psnr_per_image": per, "psnr_mean": float(per.mean())}
    if res[0] >= 11 and res[1] >= 11:
        ssim = ssim_per_image(pred, target)
        report["ssim_per_image"] = ssim
        report["ssim_mean"] = float(ssim.mean())
    return report


@torch.no_grad()
def equivariance_eval(
    model: RENIModel,
    params,
    images: torch.Tensor,
    res: tuple[int, int],
    *,
    columns: int = 8,
    unnormalise=None,
    is_hdr: bool = False,
) -> dict:
    """Rotate the latents by a y-rotation of ``columns`` pixel columns; the
    decodes must equal the column-rolled reconstructions. Returns the PSNR
    of the rotated decode against the rolled decode
    (``self_consistency_psnr``) and against the rolled ground truth
    (``rotated_reconstruction_psnr``)."""
    h, w = res
    directions = sphere.get_directions(w, device=images.device)
    Z = model.latents(params, list(range(images.shape[0])))

    angle = -2.0 * np.pi * columns / w  # d @ R(-a) shifts content left by a
    r = torch.as_tensor(sphere.rotation_y(angle).astype(np.float32), device=Z.device)

    out_rot = model.apply(params, Z @ r.to(Z.dtype), directions)
    out_base = model.apply(params, Z, directions)

    def roll(flat):
        img = flat.reshape(flat.shape[0], h, w, 3)
        return torch.roll(img, columns, dims=2).reshape(flat.shape[0], h * w, 3)

    pred = _display(out_rot, res, unnormalise, is_hdr)
    self_target = _display(roll(out_base), res, unnormalise, is_hdr)
    gt_target = _display(roll(images), res, unnormalise, is_hdr)

    return {
        "self_consistency_psnr": float(psnr_per_image(pred, self_target).mean()),
        "rotated_reconstruction_psnr": float(psnr_per_image(pred, gt_target).mean()),
    }


@torch.no_grad()
def inpainting_eval(
    model: RENIModel,
    params,
    images: torch.Tensor,
    res: tuple[int, int],
    mask: torch.Tensor,
    *,
    unnormalise=None,
    is_hdr: bool = False,
) -> dict:
    """PSNR inside (observed) and outside (hallucinated) the mask after
    masked latent fitting. mask: (1, H*W, 3) with 1 = observed."""
    directions = sphere.get_directions(res[1], device=images.device)
    out = model.apply_idx(params, list(range(images.shape[0])), directions)
    pred = _display(out, res, unnormalise, is_hdr)
    target = _display(images, res, unnormalise, is_hdr)

    m = sphere.unflatten_image(mask.to(pred.device, pred.dtype), *res)  # (1, 3, H, W)
    m = m.expand(pred.shape)

    def masked_psnr(sel):
        err = ((pred - target) ** 2 * sel).sum() / torch.clamp(sel.sum(), min=1.0)
        return float(10.0 * torch.log10(1.0 / torch.clamp(err, min=1e-12)))

    return {
        "observed_psnr": masked_psnr(m),
        "hallucinated_psnr": masked_psnr(1.0 - m),
    }


@torch.no_grad()
def inverse_recovery_eval(
    model: RENIModel,
    params,
    images: torch.Tensor,
    res: tuple[int, int],
    setup,
    *,
    unnormalise=None,
    batch: int = 4,
) -> dict:
    """FIT_INVERSE recovery quality: how well the fitted latents explain the
    scene through the renderer, and how much of the true environment they
    pin down.

    - ``render_correlation``: Pearson correlation between the recovered and
      the ground-truth renders, per map (the observable the task
      optimises);
    - ``envmap_rel_error``: mean relative radiance error of the recovered
      environment maps against the true maps (includes the renderer's null
      space).

    ``setup``: a ``render.inverse.InverseRenderSetup`` (multi-view renders
    are compared view-stacked, as the loss sees them)."""
    if unnormalise is None:
        unnormalise = lambda x: x  # noqa: E731 -- images already in radiance
    S = images.shape[0]
    directions = sphere.get_directions(res[1], device=images.device)
    sw = sphere.get_sineweight(res[1], device=images.device).to(images.dtype)
    render = setup.render_fn(res[1])

    gt = setup.generate_gt_renders(images, unnormalise, res[1]).cpu().numpy()
    corrs, rels = [], []
    for i in range(0, S, batch):
        out = model.apply_idx(params, list(range(i, min(i + batch, S))), directions)
        env = unnormalise(out)
        pred = render(env, sw.expand(env.shape)).cpu().numpy()
        g = gt[i : i + batch]
        for j in range(pred.shape[0]):
            p, t = pred[j].ravel(), g[j].ravel()
            p = p - p.mean()
            t = t - t.mean()
            denom = np.sqrt((p * p).sum() * (t * t).sum())
            corrs.append(float((p * t).sum() / max(denom, 1e-12)))
        true_env = unnormalise(images[i : i + batch]).cpu().numpy()
        env = env.cpu().numpy()
        rels.append(np.abs(env - true_env) / (np.abs(true_env) + 1e-6))
    corrs = np.asarray(corrs)
    rel = float(np.concatenate([r.ravel() for r in rels]).mean())
    return {
        "render_correlation_per_image": corrs,
        "render_correlation_mean": float(corrs.mean()),
        "render_correlation_min": float(corrs.min()),
        "envmap_rel_error": rel,
    }
