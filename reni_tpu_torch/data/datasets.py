"""Environment-map datasets: host decode -> tensors resident on the device.
The port's own copy of the eager path of ``reni_tpu/data/datasets.py`` (the
port imports nothing of the JAX package).

Every image is decoded once on the host, and the whole (small) dataset is
staged to the device at each curriculum resolution, where the train loop
indexes it (``train/tasks.py::fit_task`` takes ``images_at``): no per-step
host-to-device copy. The lazy out-of-core path of the JAX package
(``lazy=True``, ``DiskRowSource``) waits for ROADMAP A-9.

Behavioural parity with the reference:
- `.exr` files listed with natural sort (datasets.py:44-46), decoded to
  float32 RGB by the port's codec (``reni_tpu_torch.data.exr``: NONE, RLE,
  ZIPS, ZIP and PXR24, scanline, tiled and multi-part; the other codecs
  raise until ROADMAP A-6b);
- `.hdr` files through OpenCV or imageio, LDR images through PIL, all
  imported when such a file is read (alpha dropped, LDR scaled to [0, 1],
  datasets.py:141-146);
- `nan_to_num` after transforms (datasets.py:73);
- log-domain dataset min/max discovery when the minmax arg is empty
  (datasets.py:51-62, 90-101);
- resolution doubling = re-resize from the native image (datasets.py:84-88
  mutates the Resize transform; a pyramid is cached instead).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from reni_tpu_torch.data import exr
from reni_tpu_torch.data import transforms as T

_HDR_EXTS = (".exr", ".hdr")
_LDR_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


def _workers() -> int:
    return min(16, os.cpu_count() or 1)


def natsorted(names):
    """Natural sort ('img2' < 'img10'), matching natsort.natsorted."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def read_hdr(path: str) -> np.ndarray:
    """Decode an EXR/HDR file to float32 RGB (H, W, 3).

    .exr goes through the port's codec (``reni_tpu_torch.data.exr``); .hdr
    through OpenCV or imageio, imported here."""
    if path.lower().endswith(".exr"):
        img = exr.read(path)
        if img.shape[-1] > 3:
            img = img[..., :3]
        return np.ascontiguousarray(img, dtype=np.float32)
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    if img is None:
        import imageio.v3 as iio

        img = np.asarray(iio.imread(path))
        if img.ndim == 3 and img.shape[-1] >= 3:
            return img[..., :3].astype(np.float32)
        return np.repeat(img[..., None], 3, axis=-1).astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3][..., ::-1].astype(np.float32)  # BGR -> RGB


def read_ldr(path: str) -> np.ndarray:
    """Decode an LDR image to float32 RGB in [0, 1], dropping alpha (PIL,
    imported here)."""
    from PIL import Image

    img = np.asarray(Image.open(path), dtype=np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.max() > 1.0:
        img = img / 255.0
    return img


class EnvironmentMapDataset:
    """A folder of environment maps, is_hdr selecting the decode path, all
    decoded into host memory at construction.

    Parameters mirror `get_dataset` (reference datasets.py:169-173); the
    transform list uses the reference's [[name, args], ...] config format
    (resize is handled by the pyramid, normalisation by this class).
    """

    def __init__(
        self,
        dataset_path: str,
        is_hdr: bool,
        transform_config=None,
        minmax=None,
        seed: int = 0,
        lazy: bool = False,
    ):
        if lazy:
            raise NotImplementedError(
                "the lazy out-of-core dataset (TPU.STREAM_FROM_DISK) is not ported yet "
                "(ROADMAP A-9)"
            )
        self.dataset_path = dataset_path
        self.is_hdr = is_hdr
        self._seed = seed
        exts = _HDR_EXTS if is_hdr else _LDR_EXTS
        files = [f for f in os.listdir(dataset_path) if f.lower().endswith(exts)]
        self.img_names = natsorted(files)
        if not self.img_names:
            raise FileNotFoundError(f"no {'HDR' if is_hdr else 'LDR'} images in {dataset_path}")
        reader = read_hdr if is_hdr else read_ldr
        paths = [os.path.join(dataset_path, n) for n in self.img_names]
        # decode once, in parallel (the reference's num_workers=cpu_count)
        with ThreadPoolExecutor(max_workers=_workers()) as ex:
            self._native = list(ex.map(reader, paths))

        # resolve normalisation from the transform config
        self.normalise = None
        self.unnormalise = None
        self._extra_config = []  # non-resize, non-normalise entries
        for name, args in transform_config or []:
            lname = name.lower()
            if lname in ("minmaxnormalise", "minmaxormalise"):
                mm = tuple(args) if len(args) else (
                    minmax or T.compute_log_minmax(self._native)
                )
                self.minmax = mm
                self.normalise = T.MinMaxNormalise(mm)
                self.unnormalise = T.UnMinMaxNormalise(mm)
            elif lname == "normalize":
                mean, std = (args if len(args) == 2 and len(args[0]) else ([0.5] * 3, [0.5] * 3))
                self.normalise = T.Normalise(mean, std)
                self.unnormalise = T.UnNormalise(mean, std)
            elif lname == "resize":
                continue  # handled by the resolution pyramid
            else:
                self._extra_config.append((name, args))
        self.has_random_transforms = any(
            n.lower() in T.RANDOM_TRANSFORMS for n, _ in self._extra_config
        )
        self._extra_transforms = self._build_extra(np.random.default_rng(seed))
        self._cache: dict[tuple, torch.Tensor] = {}
        self._host_cache: dict[tuple[int, int], np.ndarray] = {}

    def _build_extra(self, rng):
        return [T.get_transform(n, a, rng) for n, a in self._extra_config]

    def __len__(self) -> int:
        return len(self._native)

    def _stage_img(self, img: np.ndarray, h: int, w: int, extra) -> np.ndarray:
        """The per-image staging pipeline: resize from native -> extra
        transforms -> normalise -> nan_to_num -> flatten."""
        x = T.resize_bilinear(img, h, w)
        for f in extra:
            x = f(x)
        if self.normalise is not None:
            x = self.normalise(x)
        return np.nan_to_num(x).reshape(h * w, 3).astype(np.float32)

    def images_host_at(
        self, resolution: tuple[int, int], epoch: int | None = None
    ) -> np.ndarray:
        """HOST array (S, H*W, 3) of transformed images at a resolution: the
        staging source of ``images_at``.

        Pipeline per image: resize from native (bilinear, no antialias) ->
        extra transforms -> normalise -> nan_to_num -> flatten.

        With ``epoch`` given and random transforms present, the stage is
        rebuilt with an epoch-seeded RNG and not cached: the opt-in
        per-epoch re-augmentation matching the reference's per-__getitem__
        random draws (reference datasets.py:67-74, custom_transforms.py:
        41-71). Without it, random transforms are drawn once at load."""
        res = tuple(resolution)
        reaugment = epoch is not None and self.has_random_transforms
        if not reaugment and res in self._host_cache:
            return self._host_cache[res]
        h, w = res
        extra = (
            self._build_extra(np.random.default_rng((self._seed, epoch)))
            if reaugment
            else self._extra_transforms
        )
        if extra:
            # rng order stability: random transforms draw sequentially
            out = [self._stage_img(img, h, w, extra) for img in self._native]
        else:
            with ThreadPoolExecutor(max_workers=_workers()) as ex:
                out = list(ex.map(lambda im: self._stage_img(im, h, w, extra), self._native))
        arr = np.stack(out).astype(np.float32)
        if not reaugment:
            self._host_cache[res] = arr
        return arr

    def images_at(
        self, resolution: tuple[int, int], epoch: int | None = None, *, device,
        dtype=torch.float32,
    ) -> torch.Tensor:
        """Tensor (S, H*W, 3) on ``device`` in ``dtype``: ``images_host_at``
        staged to the device (and cached there per device and dtype), what
        ``train/tasks.py::fit_task`` takes as ``images_at``. Once a
        resolution is on the device its host stack is dropped."""
        res = tuple(resolution)
        reaugment = epoch is not None and self.has_random_transforms
        key = (res, torch.device(device), dtype)
        if not reaugment and key in self._cache:
            return self._cache[key]
        arr = torch.as_tensor(self.images_host_at(res, epoch)).to(device=device, dtype=dtype)
        if not reaugment:
            self._cache[key] = arr
            self._host_cache.pop(res, None)
        return arr


def get_dataset(
    dataset_name: str,
    dataset_path: str,
    transform_config,
    is_hdr: bool,
    lazy: bool = False,
) -> EnvironmentMapDataset:
    """Factory matching the reference dispatch (datasets.py:169-173)."""
    hdr = dataset_name == "RENI_HDR" or (dataset_name == "CUSTOM" and is_hdr)
    return EnvironmentMapDataset(dataset_path, hdr, transform_config, lazy=lazy)
