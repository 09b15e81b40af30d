"""Synthetic HDR environment maps (spherical-Gaussian skies): the port's own
copy of ``make_sky`` and of the HDR write loop of
``examples/make_synthetic_dataset.py`` (the port imports nothing of the JAX
package).

    python -m reni_tpu_torch.data.synthetic --out DIR [--train 1000] \
        [--test 21] [--width 128] [--seed 1]

writes Train/ and Test/ folders of equirectangular EXRs: an elevation-graded
ambient sky, a few broad coloured lobes, a small high-intensity sun lobe and
a darker ground hemisphere. ``--train 1000 --test 21 --width 128 --seed 1``
(ZIP, half) are the maps the Zoo was trained and evaluated on
(``data/Zoo/README.md`` "Recipe").

The pixel directions come from ``reni_tpu_torch.core.sphere``, which agrees
with the JAX package's to about 1e-7, not bit for bit; the sun lobe's
exp(400 (d.s - 1)) amplifies that, so the maps agree with the script's to a
tolerance, not bitwise (tests/test_torch_data.py). The random draws are
numpy's, in the script's order, so one seed gives the same skies. LDR maps
(the script's ``--ldr``, which needs PIL) are not ported yet.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from reni_tpu_torch.core import sphere
from reni_tpu_torch.data import exr


def directions(width: int) -> np.ndarray:
    """The (width // 2, width, 3) float32 pixel directions of an
    equirectangular map."""
    return sphere.get_directions(width, device="cpu").numpy()[0].reshape(width // 2, width, 3)


def make_sky(rng: np.random.Generator, width: int = 128,
             dirs: np.ndarray | None = None) -> np.ndarray:
    """One synthetic HDR sky (width//2, width, 3), float32, radiance > 0.
    ``dirs`` (``directions(width)``) may be passed in to build it once for
    many skies."""
    dirs = directions(width) if dirs is None else dirs
    up = dirs[..., 1]  # y-up elevation

    # ambient: horizon-to-zenith gradient with a random tint
    zen = np.asarray(rng.uniform(0.4, 1.2, size=3)) * np.asarray([0.5, 0.7, 1.0])
    hor = np.asarray(rng.uniform(0.3, 1.0, size=3))
    t = np.clip(up, 0.0, 1.0)[..., None]
    img = (1 - t) * hor + t * zen

    # broad SG lobes (clouds / environment bounce)
    for _ in range(rng.integers(3, 7)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        sharp = rng.uniform(2.0, 12.0)
        amp = rng.uniform(0.2, 1.5, size=3)
        img += amp * np.exp(sharp * (dirs @ axis - 1.0))[..., None]

    # sun: sharp, very bright, above the horizon
    sun = rng.normal(size=3)
    sun[1] = abs(sun[1]) + 0.2
    sun /= np.linalg.norm(sun)
    sun_amp = rng.uniform(50.0, 2000.0)
    sun_col = np.asarray([1.0, rng.uniform(0.7, 1.0), rng.uniform(0.4, 0.9)])
    img += sun_amp * sun_col * np.exp(rng.uniform(80, 400) * (dirs @ sun - 1.0))[..., None]

    # ground hemisphere: darker albedo-like color
    ground = np.asarray(rng.uniform(0.05, 0.4, size=3))
    img = np.where(up[..., None] < 0.0, img * 0.15 + ground, img)
    return np.maximum(img, 1e-6).astype(np.float32)


def write_dataset(out: str, train: int, test: int, width: int = 128, seed: int = 0, *,
                  pixel_type: str = "half", compression: str = "ZIP") -> dict:
    """Write ``train`` then ``test`` skies from one generator of ``seed`` as
    ``out/Train/sky_NNNN.exr`` and ``out/Test/sky_NNNN.exr``; returns {split:
    its directory}."""
    rng = np.random.default_rng(seed)
    dirs = directions(width)
    folders = {}
    for split, n in (("Train", train), ("Test", test)):
        d = os.path.join(out, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            exr.write(os.path.join(d, f"sky_{i:04d}.exr"), make_sky(rng, width, dirs),
                      pixel_type=pixel_type, compression=compression)
        folders[split] = d
    return folders


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=100)
    ap.add_argument("--test", type=int, default=21)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pixel_type", default="half", choices=["half", "float"],
                    help="EXR channel type (float = exact f32 roundtrip)")
    ap.add_argument("--compression", default="ZIP",
                    choices=["NONE", "RLE", "ZIPS", "ZIP", "PXR24"])
    args = ap.parse_args(argv)
    folders = write_dataset(args.out, args.train, args.test, args.width, args.seed,
                            pixel_type=args.pixel_type, compression=args.compression)
    for split, n in (("Train", args.train), ("Test", args.test)):
        print(f"{split}: {n} EXRs at {args.width // 2}x{args.width} -> {folders[split]}")


if __name__ == "__main__":
    main()
