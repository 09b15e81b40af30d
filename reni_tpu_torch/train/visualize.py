"""Example-image grids (counterpart of ``reni_tpu/train/visualize.py``): the
reference's LogExampleImagesCallback (src/lightning/callbacks.py:33-140) as
a function.

Modes (TRAINER.LOGGER.IMAGES_TO_SHOW):
- "noise": decode random latent codes z ~ N(0, 1), prior samples;
- "random": reconstruct random dataset rows, above their ground truth;
- a list of indices: reconstruct those rows.

HDR outputs are unnormalised and tonemapped with the reference's sRGB
(98th-percentile normalisation); grids use the torchvision layout. The
random draws come from ``generator`` on the CPU: JAX's distributions, not
its numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.train.logging_utils import make_grid


def _postprocess(flat, res, unnormalise, is_hdr) -> np.ndarray:
    """(B, H*W, 3) model output -> (B, H, W, 3) display image in [0, 1]."""
    h, w = res
    imgs = sphere.unflatten_image(flat, h, w)  # (B, C, H, W)
    if unnormalise is not None:
        imgs = unnormalise(imgs)
    if is_hdr:
        imgs = sphere.srgb(imgs)
    imgs = torch.clamp(imgs, 0.0, 1.0)
    return imgs.permute(0, 2, 3, 1).cpu().numpy()


def _render_grid(renders: torch.Tensor, nrow: int) -> np.ndarray:
    """(B, H, W, 3) linear renders -> a tonemapped grid."""
    shown = sphere.srgb(renders.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return make_grid(np.clip(shown.cpu().numpy(), 0, 1), nrow=nrow)


@torch.no_grad()
def example_images(
    model: RENIModel,
    params,
    res: tuple[int, int],
    *,
    mode="noise",
    n_images: int = 10,
    generator: torch.Generator | None = None,
    dataset_images=None,
    unnormalise=None,
    is_hdr: bool = False,
    mask=None,
    render_fn=None,
    gt_renders=None,
) -> np.ndarray:
    """-> (H', W', 3) grid in [0, 1]. ``dataset_images`` (S, H*W, 3) on the
    decoder's device, or a host array or ``DiskRowSource`` whose rows are
    copied there; ``gt_renders`` (S, H, W, 3) on the decoder's device; ``render_fn``
    (FIT_INVERSE) shows renders of the decodes instead of the maps."""
    width = res[1]
    table = model.latents(params)
    dev = table.device
    directions = sphere.get_directions(width, device=dev)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)

    if mode == "noise":
        z = torch.randn((n_images, model.config.latent_dim, 3), generator=generator)
        out = model.apply(params, z.to(dev, table.dtype), directions)
        if render_fn is not None:
            sw = sphere.get_sineweight(width, device=dev).to(out.dtype)
            out_u = unnormalise(out) if unnormalise is not None else out
            return _render_grid(render_fn(out_u, sw.expand(out_u.shape)), nrow=5)
        return make_grid(_postprocess(out, res, unnormalise, is_hdr))

    total = dataset_images.shape[0]
    if mode == "random":
        idx = torch.randperm(total, generator=generator)[: min(n_images, total)].numpy()
    else:
        idx = np.asarray(mode)[:n_images]

    out = model.apply_idx(params, idx, directions)

    if render_fn is not None and gt_renders is not None:
        # FIT_INVERSE: ground-truth renders above the decodes' renders
        sw = sphere.get_sineweight(width, device=dev).to(out.dtype)
        out_u = unnormalise(out) if unnormalise is not None else out
        renders = render_fn(out_u, sw.expand(out_u.shape))
        gt = gt_renders[torch.as_tensor(idx, device=gt_renders.device)]
        return _render_grid(torch.cat((gt, renders), dim=0), nrow=len(idx))

    if isinstance(dataset_images, torch.Tensor):
        gt = dataset_images[torch.as_tensor(idx, device=dataset_images.device)]
    else:  # a host array or a DiskRowSource (the streaming tiers)
        gt = torch.as_tensor(np.asarray(dataset_images[idx]), device=dev)
    if mask is not None:
        gt = gt * mask
    gt_imgs = _postprocess(gt, res, unnormalise, is_hdr)
    out_imgs = _postprocess(out, res, unnormalise, is_hdr)
    return make_grid(np.concatenate((gt_imgs, out_imgs), axis=0), nrow=len(idx))
