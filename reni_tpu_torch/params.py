"""Carry parameter trees between numpy and the port's tensors.

A tree is the JAX package's nested dict/list layout (``models/reni.py``),
weights ``(in, out)``. ``from_numpy(to_numpy(t))`` and ``to_numpy(from_numpy(a))``
return the same values and dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from reni_tpu_torch.utils.device import resolve_device


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict/list tree; None leaves
    stay None."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree that are not None, in order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of every leaf that is not None, in ``tree_leaves``'s
    order; paths are the checkpoint keys, e.g. ``decoder/layers/0/w``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in tree_items(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_items(v, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def from_numpy(tree, device=None):
    """numpy leaves (or anything ``np.asarray`` takes) -> tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    # torch.tensor copies: the tree may hold read-only (e.g. JAX) buffers
    return map_tree(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def to_numpy(tree):
    """Tensor (or array) leaves -> numpy arrays on the host."""
    return map_tree(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree,
    )
