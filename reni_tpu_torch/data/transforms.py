"""Image transforms with the reference's exact numerics (reference:
src/utils/custom_transforms.py): the port's own copy of
``reni_tpu/data/transforms.py`` (the port imports nothing of the JAX
package).

The HDR path is the load-bearing one: per-image clip to [smallest positive,
largest finite] -> log -> affine scale to [-1, 1] by a *dataset-level*
log-domain min/max (custom_transforms.py:4-12), inverted by
`UnMinMaxNormalise` (:14-21). The dataset min/max discovery pass reproduces
datasets.py:90-101 exactly.

Transforms here are host-side numpy (they run once at dataset load, not in
the train loop); `UnMinMaxNormalise` also takes torch tensors, for undoing
the normalisation of a decode on the card. The bilinear resize is
``torch.nn.functional.interpolate`` on the CPU (half-pixel centres, no
antialias, edges clamped), where the JAX package calls OpenCV's
``INTER_LINEAR``, which the card's machine does not have: the two agree to a
few float32 ulps below the native size and exactly at it
(tests/test_torch_data.py). OpenCV is still imported, at call time, by
``randomrotation`` alone.
"""

from __future__ import annotations

import numpy as np
import torch

class MinMaxNormalise:
    """clip -> log -> scale to [-1, 1] by log-domain (min, max)."""

    def __init__(self, minmax):
        self.minmax = tuple(minmax) if len(minmax) else None

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.minmax is None:
            raise ValueError("minmax not resolved; run dataset min/max discovery")
        img = clip_positive_finite(img)
        img = np.log(img)
        lo, hi = self.minmax
        return 2.0 * (img - lo) / (hi - lo) - 1.0


class UnMinMaxNormalise:
    """Inverse of MinMaxNormalise: rescale -> exp. Works on numpy arrays or
    torch tensors."""

    def __init__(self, minmax):
        self.minmax = tuple(minmax)

    def __call__(self, img):
        lo, hi = self.minmax
        xp = torch if isinstance(img, torch.Tensor) else np
        return xp.exp(0.5 * (img + 1.0) * (hi - lo) + lo)


class Normalise:
    """Channel-wise (x - mean) / std on (..., 3) arrays (LDR path)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return (img - self.mean) / self.std


class UnNormalise:
    """Inverse channel normalisation; accepts channel-last (..., C) or the
    reference's channel-first (B, C, H, W) layout (custom_transforms.py:23-39),
    numpy arrays or torch tensors (autograd passes through: FIT_INVERSE
    unnormalises the decoder's output)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, img):
        c = self.mean.shape[0]
        mean, std = self.mean, self.std
        if isinstance(img, torch.Tensor):
            mean, std = (torch.as_tensor(a, device=img.device) for a in (mean, std))
        if img.ndim == 4 and img.shape[1] == c and img.shape[-1] != c:
            return img * std.reshape(1, c, 1, 1) + mean.reshape(1, c, 1, 1)
        return img * std + mean


def clip_positive_finite(img: np.ndarray) -> np.ndarray:
    """Per-image clip to [min positive value, max finite value]
    (custom_transforms.py:9, datasets.py:95)."""
    positive = img[img > 0.0]
    finite = img[np.isfinite(img)]
    lo = positive.min() if positive.size else np.float32(1e-30)
    hi = finite.max() if finite.size else np.float32(1.0)
    return np.clip(img, lo, hi)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float32 array without antialias, with
    half-pixel centres and clamped edges (torchvision's tensor-mode Resize,
    which the reference uses, and OpenCV's INTER_LINEAR, which the JAX
    package calls). At the native size the image is returned unchanged (a
    copy), as OpenCV does."""
    img = np.asarray(img, dtype=np.float32)
    if img.shape[:2] == (height, width):
        return img.copy()
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(t, size=(height, width), mode="bilinear",
                                          align_corners=False, antialias=False)
    return np.ascontiguousarray(out[0].permute(1, 2, 0).numpy())


def compute_log_minmax(images) -> tuple[float, float]:
    """Dataset min/max discovery in log domain (datasets.py:90-101):
    per-image clip then log; global min of mins / max of maxes."""
    lo, hi = np.inf, -np.inf
    for img in images:
        x = np.log(clip_positive_finite(np.asarray(img)))
        lo = min(lo, float(x.min()))
        hi = max(hi, float(x.max()))
    return lo, hi


def shift_hue(img: np.ndarray, offset: float) -> np.ndarray:
    """HSV hue rotation by ``offset`` turns (torchvision adjust_hue analog,
    vectorised colorsys). Defined for non-negative inputs; values outside
    [0, 1] keep their value/saturation and only rotate in hue."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = np.where(maxc != 0, c / np.where(maxc == 0, 1.0, maxc), 0.0)
    cc = np.where(c == 0, 1.0, c)
    rc, gc, bc = (maxc - r) / cc, (maxc - g) / cc, (maxc - b) / cc
    h = np.where(
        r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(c == 0, 0.0, (h / 6.0) % 1.0)
    h = (h + offset) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    conds = [i.astype(np.int32) % 6 == k for k in range(6)]
    out = np.stack(
        [
            np.select(conds, [v, q, p, p, t, v]),
            np.select(conds, [t, v, v, q, p, p]),
            np.select(conds, [p, p, t, v, v, q]),
        ],
        axis=-1,
    )
    return out.astype(img.dtype)


RANDOM_TRANSFORMS = frozenset(
    {
        "randomhorizontalflip",
        "randomverticalflip",
        "randomcrop",
        "randomrotation",
        "colorjitter",
    }
)


# ---------------------------------------------------------------------------
# registry (name -> transform), mirroring custom_transforms.py:41-71
# ---------------------------------------------------------------------------


def get_transform(name: str, args, rng: np.random.Generator | None = None):
    """name -> host-side transform on (H, W, C) float arrays.

    Random transforms draw from ``rng`` (seeded per dataset load), applied
    once at staging time: the dataset stays resident on the device rather
    than being re-augmented per epoch like the reference's DataLoader."""
    name = name.lower()
    rng = rng if rng is not None else np.random.default_rng(0)
    if name == "resize":
        return lambda img: resize_bilinear(img, args[0], args[1])
    if name == "randomhorizontalflip":
        return lambda img: img[:, ::-1] if rng.random() < 0.5 else img
    if name == "randomverticalflip":
        return lambda img: img[::-1] if rng.random() < 0.5 else img
    if name == "randomcrop":
        size = args if isinstance(args, (list, tuple)) else (args, args)

        def rcrop(img):
            h, w = img.shape[:2]
            th, tw = size
            i = int(rng.integers(0, max(h - th, 0) + 1))
            j = int(rng.integers(0, max(w - tw, 0) + 1))
            return img[i : i + th, j : j + tw]

        return rcrop
    if name == "randomrotation":
        deg = args if np.isscalar(args) else args[0]

        def rrot(img):
            import cv2

            a = float(rng.uniform(-deg, deg))
            h, w = img.shape[:2]
            m = cv2.getRotationMatrix2D((w / 2, h / 2), a, 1.0)
            return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR)

        return rrot
    if name == "colorjitter":
        b, c, s, _h = (list(args) + [0, 0, 0, 0])[:4]
        if _h > 0.5:
            raise ValueError("hue jitter must be <= 0.5 (torchvision semantics)")

        def jitter(img):
            out = img * float(rng.uniform(max(0, 1 - b), 1 + b))
            mean = out.mean()
            out = (out - mean) * float(rng.uniform(max(0, 1 - c), 1 + c)) + mean
            gray = out.mean(axis=-1, keepdims=True)
            out = gray + (out - gray) * float(rng.uniform(max(0, 1 - s), 1 + s))
            if _h:
                out = shift_hue(out, float(rng.uniform(-_h, _h)))
            return out.astype(img.dtype)

        return jitter
    if name == "centercrop":
        size = args if isinstance(args, (list, tuple)) else (args, args)

        def crop(img):
            h, w = img.shape[:2]
            th, tw = size
            i, j = (h - th) // 2, (w - tw) // 2
            return img[i : i + th, j : j + tw]

        return crop
    if name == "grayscale":
        # 3 output channels (torchvision Grayscale(num_output_channels=3)
        # shape contract: the (H, W, 3) pipeline stays intact downstream)
        return lambda img: np.repeat(
            (0.2989 * img[..., :1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]),
            3,
            axis=-1,
        )
    if name == "normalize":
        return Normalise(args[0], args[1])
    if name in ("minmaxnormalise", "minmaxormalise"):  # reference typo alias
        return MinMaxNormalise(args)
    if name == "to_tensor":
        return lambda img: img  # arrays are already float (H, W, C)
    raise ValueError(f"unsupported transform {name!r}")


def transform_builder(transform_config, seed: int = 0):
    """[(name, args), ...] -> composed callable (custom_transforms.py:73-78)."""
    rng = np.random.default_rng(seed)
    fns = [get_transform(n, a, rng) for n, a in transform_config]

    def composed(img):
        for f in fns:
            img = f(img)
        return img

    return composed
