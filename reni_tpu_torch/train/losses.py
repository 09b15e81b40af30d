"""Loss functions with the reference's reduction semantics (counterpart of
``reni_tpu/train/losses.py``; reference src/utils/loss_functions.py).

The conventions change the gradient scale, so they are kept exactly:

- ``weighted_mse``: mean over pixels * channels per sample, **sum over the
  batch**;
- ``kld``: per-sample sum over latent dims, divided by ``z_dims`` (3N in the
  trainer), summed over the batch;
- ``weighted_cosine_similarity``: cosine over the **pixel** axis of a
  (B, P, 3) tensor (torch ``cosine_similarity(..., dim=1)``: one value per
  colour channel), scaled by ``sineweight[:, 0]`` (the first pixel's
  weight); this is how the published models were trained;
- ``cosine_similarity``: 1 - mean cosine over dim 1, for (B, H, W, 3)
  renders in the inverse task.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def weighted_mse(model_output, ground_truth, sineweight, pixels: int | None = None
                 ) -> torch.Tensor:
    """``pixels``: the whole sample's pixel count where the inputs hold a
    slice of it (a mesh's pixel axis): the slices' values then sum to the
    whole's."""
    se = ((model_output - ground_truth) ** 2) * sineweight
    if pixels is not None:
        return (se.reshape(se.shape[0], -1).sum(dim=1) / (pixels * se.shape[-1])).sum()
    return se.reshape(se.shape[0], -1).mean(dim=1).sum()


def kld(mu, log_var, z_dims: int = 1) -> torch.Tensor:
    k = -0.5 * (1 + log_var - mu**2 - torch.exp(log_var)).reshape(mu.shape[0], -1).sum(dim=1)
    return (k / z_dims).sum()


def _cosine_axis1(a, b, pixel_sum=None) -> torch.Tensor:
    """torch.nn.functional.cosine_similarity(a, b, dim=1, eps=1e-20), with
    the JAX package's operation order. Where a and b hold a slice of axis 1
    (a mesh's pixel axis), ``pixel_sum`` sums the three partial sums over
    the slices (``parallel.mesh.ShardView.pixel_sum``)."""
    dot, aa, bb = (a * b).sum(dim=1), (a * a).sum(dim=1), (b * b).sum(dim=1)
    if pixel_sum is not None:
        dot, aa, bb = pixel_sum(torch.stack([dot, aa, bb])).unbind(0)
    na = torch.sqrt(aa)
    nb = torch.sqrt(bb)
    return dot / (torch.clamp(na, min=_EPS) * torch.clamp(nb, min=_EPS))


def weighted_cosine_similarity(model_output, ground_truth, sineweight) -> torch.Tensor:
    cos = _cosine_axis1(model_output, ground_truth)  # (B, 3)
    return (1.0 - (cos * sineweight[:, 0]).mean(dim=1)).sum()


def cosine_similarity(model_output, ground_truth) -> torch.Tensor:
    return 1.0 - _cosine_axis1(model_output, ground_truth).mean()


# -- composite criteria ------------------------------------------------------


def reni_train_loss(inputs, targets, sineweight):
    """AutoDecoder FIT_DECODER loss: weighted MSE only."""
    return weighted_mse(inputs, targets, sineweight)


def reni_vad_train_loss(inputs, targets, sineweight, mu, log_var, *, beta, z_dims):
    """VAD FIT_DECODER loss. Returns (loss, mse, kld)."""
    mse_loss = weighted_mse(inputs, targets, sineweight)
    kld_loss = beta * kld(mu, log_var, z_dims)
    return mse_loss + kld_loss, mse_loss, kld_loss


def reni_test_loss(inputs, targets, sineweight, Z, *, alpha, beta):
    """FIT_LATENT loss. Returns (loss, mse, prior, cosine)."""
    mse_loss = weighted_mse(inputs, targets, sineweight)
    prior_loss = alpha * torch.sum(Z**2)
    cosine_loss = beta * weighted_cosine_similarity(inputs, targets, sineweight)
    return mse_loss + prior_loss + cosine_loss, mse_loss, prior_loss, cosine_loss


def reni_test_loss_inverse(inputs, targets, Z, *, alpha, beta):
    """FIT_INVERSE loss on (B, H, W, 3) renders. Returns (loss, mse, prior, cos)."""
    mse_loss = torch.mean((inputs - targets) ** 2)
    prior_loss = alpha * torch.sum(Z**2)
    cosine_loss = beta * cosine_similarity(inputs, targets)
    return mse_loss + prior_loss + cosine_loss, mse_loss, prior_loss, cosine_loss


# -- batch-masked variants (the ragged-tail zero-masking of the trainer; with
#    an all-ones bmask they are the criteria above) ---------------------------


def reni_test_loss_masked(inputs, targets, sineweight, Z, bmask, *, alpha, beta,
                          pixels: int | None = None, pixel_sum=None):
    """FIT_LATENT loss over a zero-padded batch. ``sineweight`` must already
    include the batch mask (and any in-painting mask); ``Z`` rows of padded
    samples must be zeroed by the caller. The cosine term leaves padded rows
    out (each would add a constant 1). ``pixels`` and ``pixel_sum``: for
    inputs that hold a slice of the pixel axis (``weighted_mse``,
    ``_cosine_axis1``). The cosine's weight is then the first pixel's of the
    slice: the term is counted on the rank whose slice starts at pixel 0."""
    mse_loss = weighted_mse(inputs, targets, sineweight, pixels)
    prior_loss = alpha * torch.sum(Z**2)
    cos_per = 1.0 - (_cosine_axis1(inputs, targets, pixel_sum) * sineweight[:, 0]).mean(dim=1)
    cosine_loss = beta * (cos_per * bmask).sum()
    return mse_loss + prior_loss + cosine_loss, mse_loss, prior_loss, cosine_loss


def reni_test_loss_inverse_masked(inputs, targets, Z, bmask, *, alpha, beta,
                                  n_valid=None, per_sample: int | None = None,
                                  pixel_sum=None):
    """FIT_INVERSE loss over a zero-padded batch of (B, H, W, 3) renders;
    ``reni_test_loss_inverse`` when bmask is all ones. For a rank's block of
    a mesh: ``n_valid``, the whole batch's count of real rows, ``per_sample``,
    a whole render's values, and ``pixel_sum`` for the cosine over the
    render's rows (``_cosine_axis1``)."""
    bm = bmask[:, None, None, None]
    if n_valid is None:
        n_valid = torch.clamp(torch.sum(bmask), min=1.0)
    if per_sample is None:
        per_sample = math.prod(inputs.shape[1:])
    mse_loss = torch.sum(bm * (inputs - targets) ** 2) / (n_valid * per_sample)
    prior_loss = alpha * torch.sum(Z**2)
    cos_flat = _cosine_axis1(inputs * bm, targets * bm, pixel_sum)
    cos_per = 1.0 - cos_flat.reshape(cos_flat.shape[0], -1).mean(dim=1)
    cosine_loss = beta * (cos_per * bmask).sum() / n_valid
    return mse_loss + prior_loss + cosine_loss, mse_loss, prior_loss, cosine_loss


def psnr(prediction, target, max_value: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((prediction - target) ** 2)
    return 10.0 * torch.log10(max_value**2 / mse)
