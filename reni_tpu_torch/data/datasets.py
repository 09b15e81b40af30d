"""Environment-map datasets: host decode -> tensors on the device. The port's
own copy of ``reni_tpu/data/datasets.py`` (the port imports nothing of the
JAX package).

Three residencies, as in the JAX package:
- resident (the default): every image is decoded once on the host, and the
  whole (small) dataset is staged to the device at each curriculum
  resolution, where the train loop indexes it (``train/tasks.py::fit_task``
  takes ``images_at``): no per-step host-to-device copy;
- host (``TPU.STREAM_DATA``): ``images_host_at`` keeps the staged dataset
  in host memory and the streaming runner copies one batch a step;
- disk (``TPU.STREAM_FROM_DISK``, ``lazy=True``): only the file list is
  kept; ``row_source_at`` gives a ``DiskRowSource`` whose rows decode from
  disk on demand through the native EXR decoder, prefetched on the
  dataset's thread pool (the out-of-core form of the reference's
  DataLoader(num_workers=cpu_count)).

A lazy decode retries once on ``OSError`` or ``ExrError`` (a short read
under memory pressure can re-read clean), never on ``FileNotFoundError``
or ``PermissionError``, which do not go away; the JAX package retries any
``Exception`` once (a difference kept on purpose).

Behavioural parity with the reference:
- `.exr` files listed with natural sort (datasets.py:44-46), decoded to
  float32 RGB by the port's codec (``reni_tpu_torch.data.exr``: every
  non-deep compression of the format, scanline, tiled and multi-part,
  through the native decoder ``data/csrc/exr_decode.cpp``);
- `.hdr` files through OpenCV or imageio, imported when such a file is
  read; `.png` through the port's own numpy + zlib reader, other LDR images
  through PIL, imported when read (alpha dropped, LDR scaled to [0, 1],
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
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from reni_tpu_torch.core import sphere
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
    """Decode an LDR image to float32 RGB in [0, 1], dropping alpha, as the
    JAX package's PIL reader does (a grey image repeated over RGB; divided
    by 255 when its largest value is above 1). A PNG goes through the port's
    numpy + zlib reader (``core.sphere.read_png``: 8-bit grey / RGB / RGBA,
    every filter type, not interlaced), which needs no PIL; other formats
    through PIL, imported here."""
    if path.lower().endswith(".png"):
        img = sphere.read_png(path).astype(np.float32)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path), dtype=np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.max() > 1.0:
        img = img / 255.0
    return img


class EnvironmentMapDataset:
    """A folder of environment maps, is_hdr selecting the decode path:
    decoded into host memory at construction, or with ``lazy`` only listed
    (rows decode on demand).

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
        self.dataset_path = dataset_path
        self.is_hdr = is_hdr
        self._seed = seed
        self.lazy = bool(lazy)
        exts = _HDR_EXTS if is_hdr else _LDR_EXTS
        files = [f for f in os.listdir(dataset_path) if f.lower().endswith(exts)]
        self.img_names = natsorted(files)
        if not self.img_names:
            raise FileNotFoundError(f"no {'HDR' if is_hdr else 'LDR'} images in {dataset_path}")
        self._reader = read_hdr if is_hdr else read_ldr
        self._paths = [os.path.join(dataset_path, n) for n in self.img_names]
        self._pool: ThreadPoolExecutor | None = None  # lazy decodes, made at first use
        self._native = None
        if not self.lazy:
            # decode once, in parallel (the reference's num_workers=cpu_count)
            with ThreadPoolExecutor(max_workers=_workers()) as ex:
                self._native = list(ex.map(self._reader, self._paths))

        # resolve normalisation from the transform config
        self.normalise = None
        self.unnormalise = None
        self._extra_config = []  # non-resize, non-normalise entries
        for name, args in transform_config or []:
            lname = name.lower()
            if lname in ("minmaxnormalise", "minmaxormalise"):
                mm = tuple(args) if len(args) else (minmax or self._discover_log_minmax())
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
        if self.lazy and self.has_random_transforms:
            raise ValueError(
                "lazy (out-of-core) decode cannot reproduce random "
                "transforms: staging draws one sequential RNG over the whole "
                "set, but lazy rows decode out of order — drop the random "
                "transforms or disable TPU.STREAM_FROM_DISK"
            )
        self._extra_transforms = self._build_extra(np.random.default_rng(seed))
        self._cache: dict[tuple, torch.Tensor] = {}
        self._host_cache: dict[tuple[int, int], np.ndarray] = {}

    def _discover_log_minmax(self) -> tuple[float, float]:
        """Dataset min/max discovery (reference datasets.py:90-101). Eager:
        over the decoded set. Lazy: one bounded pass (decode, reduce,
        discard), so that discovery never holds the dataset in memory."""
        if self._native is not None:
            return T.compute_log_minmax(self._native)
        lo, hi = np.inf, -np.inf
        step = 64  # decodes in flight at most
        with ThreadPoolExecutor(max_workers=_workers()) as ex:
            for c in range(0, len(self._paths), step):
                for img in ex.map(self._reader, self._paths[c : c + step]):
                    l, h = T.compute_log_minmax([img])
                    lo, hi = min(lo, l), max(hi, h)
        return lo, hi

    def _build_extra(self, rng):
        return [T.get_transform(n, a, rng) for n, a in self._extra_config]

    def __len__(self) -> int:
        return len(self._paths)

    def close(self) -> None:
        """Stop the lazy decode pool (a later ``row_source_at`` makes a new
        one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _stage_img(self, img: np.ndarray, h: int, w: int, extra) -> np.ndarray:
        """The per-image staging pipeline, shared by the eager whole-set stage
        and the lazy row decode (the same bytes by construction): resize from
        native -> extra transforms -> normalise -> nan_to_num -> flatten."""
        x = T.resize_bilinear(img, h, w)
        for f in extra:
            x = f(x)
        if self.normalise is not None:
            x = self.normalise(x)
        return np.nan_to_num(x).reshape(h * w, 3).astype(np.float32)

    def _read_row(self, i: int) -> np.ndarray:
        """Decode file ``i``, retried once where the fault may be transient
        (``OSError`` other than a missing or forbidden file, ``ExrError``):
        a persistent fault re-raises the first error."""
        try:
            return self._reader(self._paths[i])
        except (FileNotFoundError, PermissionError):
            raise
        except (OSError, exr.ExrError) as first:
            try:
                return self._reader(self._paths[i])
            except (OSError, exr.ExrError):
                raise first from None

    def _stage_row(self, i: int, res: tuple[int, int]) -> np.ndarray:
        """Image ``i`` decoded (lazy) or fetched (eager) and staged at
        ``res``: the bytes of the eager path's ``_stage_img``. Lazy mode has
        only deterministic extra transforms (checked at construction), so a
        row stages the same in any order."""
        img = self._native[i] if self._native is not None else self._read_row(i)
        return self._stage_img(img, res[0], res[1], self._extra_transforms)

    def row_source_at(self, resolution: tuple[int, int]) -> "DiskRowSource":
        """An ndarray-like lazy view (S, H*W, 3) of one resolution stage:
        ``src[rows]`` decodes exactly those files, ``src.prefetch(rows)``
        starts decodes in the background that the next ``src[rows]`` joins
        (``TPU.STREAM_FROM_DISK``)."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=_workers())
        return DiskRowSource(self, tuple(resolution), self._pool)

    def images_host_at(
        self, resolution: tuple[int, int], epoch: int | None = None
    ) -> np.ndarray:
        """HOST array (S, H*W, 3) of transformed images at a resolution: the
        staging source of ``images_at``, and what the streaming runner
        (``TPU.STREAM_DATA``) copies a batch at a time.

        Pipeline per image: resize from native (bilinear, no antialias) ->
        extra transforms -> normalise -> nan_to_num -> flatten.

        With ``epoch`` given and random transforms present, the stage is
        rebuilt with an epoch-seeded RNG and not cached: the opt-in
        per-epoch re-augmentation matching the reference's per-__getitem__
        random draws (reference datasets.py:67-74, custom_transforms.py:
        41-71). Without it, random transforms are drawn once at load.

        In lazy mode the array is built row by row on a pool and not cached,
        and not through ``DiskRowSource``, whose LRU would hold a second
        copy (bounded callers only: evaluation and small splits)."""
        res = tuple(resolution)
        h, w = res
        if self._native is None:
            arr = np.empty((len(self), h * w, 3), np.float32)
            with ThreadPoolExecutor(max_workers=_workers()) as ex:
                for i, row in enumerate(ex.map(lambda i: self._stage_row(i, res),
                                               range(len(self)))):
                    arr[i] = row
            return arr
        reaugment = epoch is not None and self.has_random_transforms
        if not reaugment and res in self._host_cache:
            return self._host_cache[res]
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


class DiskRowSource:
    """ndarray-like view of one resolution stage of a lazy dataset.

    Has what the streaming runner and the image grids use of the (S, H*W, 3)
    host array (``.shape``, ``.dtype``, ``len``, ``src[rows]``), but
    decodes rows from disk on demand. ``prefetch(rows)`` starts decodes on
    the dataset's shared pool (the native decoder releases the GIL) that
    the next ``src[rows]`` joins: the streaming runner prefetches batch b+2
    while batch b+1 is copied and step b runs.

    Recent rows stay in an LRU of ``cache_rows`` rows, which grows to hold
    four requests, so that a request larger than the cache does not evict
    its own rows; ``decodes`` counts the rows actually staged. Driven from
    one thread (the pool runs only the decodes)."""

    def __init__(self, dataset: EnvironmentMapDataset, res, pool: ThreadPoolExecutor,
                 cache_rows: int = 512):
        self._ds = dataset
        self._res = res
        self._pool = pool
        self.shape = (len(dataset), res[0] * res[1], 3)
        self.dtype = np.dtype(np.float32)
        self._cache_rows = cache_rows
        self._cache: OrderedDict[int, Future] = OrderedDict()
        self.decodes = 0

    def __len__(self) -> int:
        return self.shape[0]

    def prefetch(self, rows) -> None:
        for i in np.atleast_1d(np.asarray(rows)).reshape(-1):
            i = int(i)
            if i in self._cache:
                self._cache.move_to_end(i)
            else:
                self.decodes += 1
                self._cache[i] = self._pool.submit(self._ds._stage_row, i, self._res)
        while len(self._cache) > self._cache_rows:
            self._cache.popitem(last=False)

    def __getitem__(self, rows) -> np.ndarray:
        # the ndarray indexing forms: int -> (P, 3); slice -> (n, P, 3);
        # index array -> rows.shape + (P, 3)
        if isinstance(rows, slice):
            rows = np.arange(*rows.indices(self.shape[0]))
        rows = np.asarray(rows)
        flat = np.atleast_1d(rows).reshape(-1)
        self._cache_rows = max(self._cache_rows, 4 * flat.size)
        self.prefetch(flat)  # cache hits are free; misses decode in parallel
        out = np.empty((flat.size,) + self.shape[1:], np.float32)
        for j, i in enumerate(flat):
            out[j] = self._cache[int(i)].result()
        if rows.ndim == 0:
            return out[0]
        return out.reshape(tuple(rows.shape) + self.shape[1:])


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
