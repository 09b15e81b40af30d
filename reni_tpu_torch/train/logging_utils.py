"""Metrics and image logging (counterpart of ``reni_tpu/train/logging_utils.py``):
JSONL always, TensorBoard or wandb when they import.

The metric names are the reference's (``{task}_loss`` etc.). Scalars go to
``metrics.jsonl`` unconditionally; TensorBoard event files through
``torch.utils.tensorboard`` when it imports, wandb when it imports and the
config asks for it. Image grids are written as PNG by a small numpy + zlib
writer (``write_png``): the card's machine has no PIL.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img8: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (no filter, no
    interlace)."""
    img8 = np.ascontiguousarray(img8, dtype=np.uint8)
    h, w, c = img8.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got {img8.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img8.reshape(h, w * 3)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


class MetricLogger:
    def __init__(
        self,
        log_dir: str,
        use_tensorboard: bool = True,
        wandb_config: dict | None = None,
    ):
        """wandb_config: the reference's TRAINER.LOGGER.WANDB block, used
        when the wandb package imports (in place of TensorBoard)."""
        self.log_dir = log_dir
        self._tb = None
        self._wandb = None
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if wandb_config is not None:
            try:
                import wandb

                self._wandb = wandb.init(
                    name=wandb_config.get("NAME"),
                    project=wandb_config.get("PROJECT"),
                    dir=wandb_config.get("SAVE_DIR"),
                    mode="offline" if wandb_config.get("OFFLINE") else "online",
                    config=wandb_config.get("run_config"),
                )
            except Exception:
                self._wandb = None
        if use_tensorboard and self._wandb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log_scalars(self, step: int, scalars: dict) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in scalars.items()}, step=int(step))

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int) -> None:
        """image_hwc: (H, W, 3) float in [0, 1]. Saved as
        ``images/{tag}_{step:06d}.png`` and to TensorBoard / wandb."""
        arr = np.clip(np.asarray(image_hwc), 0.0, 1.0)
        img8 = (arr * 255).astype(np.uint8)
        imgdir = os.path.join(self.log_dir, "images")
        os.makedirs(imgdir, exist_ok=True)
        write_png(os.path.join(imgdir, f"{tag}_{step:06d}.png"), img8)
        if self._tb is not None:
            self._tb.add_image(tag, img8, int(step), dataformats="HWC")
        if self._wandb is not None:
            import wandb

            self._wandb.log({tag: wandb.Image(img8)}, step=int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def make_grid(
    images: np.ndarray, nrow: int = 5, pad: int = 2, pad_value: float = 2.0
) -> np.ndarray:
    """(B, H, W, 3) -> tiled (H', W', 3) grid (torchvision make_grid layout,
    callbacks.py:50,127)."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrows = -(-b // ncol)
    grid = np.full(
        (nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
        pad_value,
        dtype=images.dtype,
    )
    for i in range(b):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y : y + h, x : x + w] = images[i]
    return grid
