"""Carry parameter trees between numpy and the port's tensors.

A tree is the JAX package's nested dict/list layout (``models/reni.py``),
weights ``(in, out)``. ``from_numpy(to_numpy(t))`` and ``to_numpy(from_numpy(a))``
return the same values and dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from reni_tpu_torch.utils.device import resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def from_numpy(tree, device=None):
    """numpy leaves (or anything ``np.asarray`` takes) -> tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    # torch.tensor copies: the tree may hold read-only (e.g. JAX) buffers
    return _map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def to_numpy(tree):
    """Tensor (or array) leaves -> numpy arrays on the host."""
    return _map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree,
    )
