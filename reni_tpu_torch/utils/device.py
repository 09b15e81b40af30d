"""Device resolution for the port's entry points.

The port's default device is the card. A caller that wants the CPU (the
tests, a laptop) says so explicitly; a missing card is an error, never a
silent fall back to the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
