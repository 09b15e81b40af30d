"""Checkpoint files (counterpart of ``reni_tpu/train/checkpoint.py``).

A checkpoint is ``path.npz`` (path-flattened tree leaves, keys like
``decoder/layers/0/w``) plus ``path.json`` (metadata, with the model config
under ``model_config``) — the same files the JAX package reads and writes,
so checkpoints interchange both ways. Optimizer state and RNG keys are
written by the training slices; this module reads around them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from reni_tpu_torch.models.reni import RENIConfig
from reni_tpu_torch.params import to_numpy

Params = dict[str, Any]

_SEP = "/"


def _flatten(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix[: -len(_SEP)]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _json_path(path: str) -> str:
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    return base + ".json"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(
    path: str,
    params: Params,
    *,
    model_config: RENIConfig | None = None,
    metadata: dict | None = None,
) -> None:
    """Write ``path``.npz (params leaves, tensors or arrays) and ``path``.json
    (metadata + model config)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(_npz_path(path), **_flatten(to_numpy(params)))
    meta = dict(metadata or {})
    if model_config is not None:
        meta["model_config"] = dataclasses.asdict(model_config)
    with open(_json_path(path), "w") as f:
        json.dump(meta, f, indent=2, default=float)


def load_checkpoint(path: str) -> tuple[Params, dict]:
    """-> (params tree of numpy arrays, metadata dict). Optimizer state and
    the RNG key, when present, are skipped. ``params.from_numpy`` moves the
    tree to a device."""
    with np.load(_npz_path(path)) as npz:
        flat = {
            k: npz[k]
            for k in npz.files
            if not (k.startswith(f"__opt__{_SEP}") or k == "__rng__")
        }
    meta = {}
    if os.path.exists(_json_path(path)):
        with open(_json_path(path)) as f:
            meta = json.load(f)
    return _unflatten(flat), meta


def load_model_config(path: str, **overrides) -> RENIConfig:
    """The RENIConfig stored in a checkpoint's metadata."""
    with open(_json_path(path)) as f:
        cfg = dict(json.load(f)["model_config"])
    cfg.update(overrides)
    return RENIConfig(**cfg)
