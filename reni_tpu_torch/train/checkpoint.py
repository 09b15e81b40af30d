"""Checkpoint files (counterpart of ``reni_tpu/train/checkpoint.py``).

A checkpoint is ``path.npz`` (path-flattened tree leaves, keys like
``decoder/layers/0/w``) plus ``path.json`` (metadata, with the model config
under ``model_config``): the same files the JAX package reads and writes,
so checkpoints interchange both ways, optimizer state included.

**Optimizer state** is stored under ``__opt__/`` in optax's flat layout, the
keys the JAX package's ``_flatten`` gives the state of the optimizer that
``reni_tpu/train/optim.py::build_optimizer`` builds (frozen leaves, None in
the trainable partition, have no key; ``<path>`` is a trainable leaf's
checkpoint path, e.g. ``latents/mu``):

=========  ==========================  ================================
optimizer  optax key                    torch state
=========  ==========================  ================================
adam       ``0/0`` (int32)              Adam ``step`` (ScaleByAdamState.count)
adam       ``0/1/<path>``               Adam ``exp_avg`` (mu)
adam       ``0/2/<path>``               Adam ``exp_avg_sq`` (nu)
sgd        ``0/0/<path>``               SGD ``momentum_buffer`` (trace; only
                                        with momentum, else no key)
adagrad    ``0/0/<path>``               ``optim.Adagrad`` ``sum`` (sum_of_squares)
all        ``1/0`` (int32)              ``ScheduledOptimizer.count``
                                        (ScaleByScheduleState.count)
=========  ==========================  ================================

A torch optimizer creates its state at its first step; before it, the
saved state is optax's initial one (zero moments, adagrad's sums 0.1).

**Generator state.** The JAX package keeps every npz key but ``__opt__/*``
and ``__rng__`` as a parameter leaf, so the port's ``torch.Generator`` state
goes into the JSON metadata (``torch_generator_state``, base64), which the
JAX package ignores. A JAX checkpoint's ``__rng__`` key cannot continue in
torch's generator: ``load_generator_state`` returns None for it and the
caller keeps its own seed.

Files are written to a temporary name and renamed into place, so a process
killed while saving leaves the previous file whole.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from typing import Any

import numpy as np

import torch

from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.params import from_numpy, to_numpy
from reni_tpu_torch.train.optim import Adagrad, ScheduledOptimizer

Params = dict[str, Any]

_SEP = "/"
_OPT = f"__opt__{_SEP}"
_GEN_KEY = "torch_generator_state"


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


def _replace_into(path: str, write) -> None:
    """``write(file)`` to a temporary file beside ``path``, then rename it
    to ``path``."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# optimizer state <-> optax's flat layout
# ---------------------------------------------------------------------------


def _opt_layout(optimizer: ScheduledOptimizer) -> tuple[str, list[str]]:
    """(kind, the optax keys of its state but ``1/0``) of ``optimizer``."""
    opt, names = optimizer.optimizer, optimizer.names
    if names is None:
        raise ValueError("the optimizer has no parameter names (build it with names=)")
    if isinstance(opt, torch.optim.Adam):
        return "adam", ["0/0", *(f"0/{i}/{n}" for i in (1, 2) for n in names)]
    if isinstance(opt, Adagrad):
        return "adagrad", [f"0/0/{n}" for n in names]
    if isinstance(opt, torch.optim.SGD):
        if opt.defaults["momentum"]:
            return "sgd", [f"0/0/{n}" for n in names]
        return "sgd", []
    raise ValueError(f"no optax layout for {type(opt).__name__}")


def opt_state_arrays(optimizer: ScheduledOptimizer) -> dict[str, np.ndarray]:
    """``optimizer``'s state in optax's flat layout (module docstring), keys
    without the ``__opt__/`` prefix, values numpy arrays."""
    kind, _ = _opt_layout(optimizer)
    opt = optimizer.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    out = {}

    def host(t):
        return t.detach().cpu().numpy()

    if kind == "adam":
        step = 0
        for name, p in zip(optimizer.names, params):
            st = opt.state.get(p, {})
            zeros = host(torch.zeros_like(p))
            out[f"0/1/{name}"] = host(st["exp_avg"]) if st else zeros
            out[f"0/2/{name}"] = host(st["exp_avg_sq"]) if st else zeros
            step = int(st["step"]) if st else step
        out["0/0"] = np.asarray(step, dtype=np.int32)
    elif kind == "adagrad":
        for name, p in zip(optimizer.names, params):
            st = opt.state.get(p, {})
            out[f"0/0/{name}"] = host(st["sum"] if st else torch.full_like(
                p, opt.defaults["initial_accumulator_value"]))
    elif opt.defaults["momentum"]:
        for name, p in zip(optimizer.names, params):
            buf = opt.state.get(p, {}).get("momentum_buffer")
            out[f"0/0/{name}"] = host(buf if buf is not None else torch.zeros_like(p))
    out["1/0"] = np.asarray(optimizer.count, dtype=np.int32)
    return out


def set_opt_state(optimizer: ScheduledOptimizer, flat: dict) -> None:
    """Restore ``optimizer``'s state from optax's flat layout (keys without
    ``__opt__/``; a port's or a JAX checkpoint's). Raises ValueError when the
    leaves do not match this optimizer's (count, then names)."""
    kind, keys = _opt_layout(optimizer)
    keys = keys + ["1/0"]
    if len(flat) != len(keys):
        raise ValueError(
            f"optimizer state mismatch: checkpoint has {len(flat)} leaves, "
            f"current optimizer expects {len(keys)}"
        )
    missing = sorted(set(keys) - set(flat))
    if missing:
        raise ValueError(f"optimizer state mismatch: the checkpoint lacks {missing[:4]}")
    opt = optimizer.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]

    def like(a, p):
        return torch.as_tensor(np.asarray(a)).to(device=p.device, dtype=p.dtype).clone()

    for name, p in zip(optimizer.names, params):
        if kind == "adam":
            opt.state[p] = {
                # torch keeps the step on the host (float32), as Adam makes it
                "step": torch.tensor(float(flat["0/0"]), dtype=torch.float32),
                "exp_avg": like(flat[f"0/1/{name}"], p),
                "exp_avg_sq": like(flat[f"0/2/{name}"], p),
            }
        elif kind == "adagrad":
            opt.state[p] = {"sum": like(flat[f"0/0/{name}"], p)}
        elif keys != ["1/0"]:
            opt.state[p] = {"momentum_buffer": like(flat[f"0/0/{name}"], p)}
    optimizer.count = int(flat["1/0"])


def read_opt_state(path: str) -> dict[str, np.ndarray] | None:
    """The optimizer state of a checkpoint in optax's flat layout (keys
    without ``__opt__/``), or None if it has none."""
    with np.load(_npz_path(path)) as npz:
        flat = {k[len(_OPT):]: npz[k] for k in npz.files if k.startswith(_OPT)}
    return flat or None


def load_opt_state(path: str, optimizer: ScheduledOptimizer) -> bool:
    """Restore a checkpoint's optimizer state into the live ``optimizer``
    (the JAX package's ``load_opt_state``: the leaves must match). Returns
    False, touching nothing, if the checkpoint carries no optimizer state."""
    flat = read_opt_state(path)
    if flat is None:
        return False
    set_opt_state(optimizer, flat)
    return True


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def save_checkpoint(
    path: str,
    params: Params,
    *,
    model_config: RENIConfig | None = None,
    metadata: dict | None = None,
    opt_state: dict | None = None,
    generator: torch.Generator | None = None,
) -> None:
    """Write ``path``.npz (params leaves, tensors or arrays; with
    ``opt_state``, an ``opt_state_arrays`` dict, under ``__opt__/``) and
    ``path``.json (metadata + model config; with ``generator``, its state).
    The optimizer and generator state make a mid-task resume exact."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = _flatten(to_numpy(params))
    if opt_state is not None:
        flat.update({_OPT + k: np.asarray(v) for k, v in opt_state.items()})
    _replace_into(_npz_path(path), lambda f: np.savez(f, **flat))
    meta = dict(metadata or {})
    if model_config is not None:
        meta["model_config"] = dataclasses.asdict(model_config)
    if generator is not None:
        meta[_GEN_KEY] = base64.b64encode(generator.get_state().numpy().tobytes()).decode()
    text = json.dumps(meta, indent=2, default=float)
    _replace_into(_json_path(path), lambda f: f.write(text.encode()))


def load_checkpoint(path: str) -> tuple[Params, dict]:
    """-> (params tree of numpy arrays, metadata dict). Optimizer state and
    the RNG key, when present, are skipped. ``params.from_numpy`` moves the
    tree to a device."""
    with np.load(_npz_path(path)) as npz:
        flat = {
            k: npz[k]
            for k in npz.files
            if not (k.startswith(_OPT) or k == "__rng__")
        }
    meta = {}
    if os.path.exists(_json_path(path)):
        with open(_json_path(path)) as f:
            meta = json.load(f)
    return _unflatten(flat), meta


def load_generator_state(path: str) -> torch.Tensor | None:
    """The ``torch.Generator`` state saved with a checkpoint (for
    ``Generator.set_state``), or None: no state saved, or a JAX checkpoint,
    whose ``__rng__`` key torch's generator cannot continue."""
    _, meta = _meta_only(path)
    if _GEN_KEY not in meta:
        return None
    raw = np.frombuffer(base64.b64decode(meta[_GEN_KEY]), dtype=np.uint8)
    return torch.from_numpy(raw.copy())


def load_train_state(path: str, state) -> None:
    """Restore a checkpoint's optimizer state into ``state.optimizer`` and
    its generator state into ``state.generator`` (a ``tasks.TrainState``;
    the loader ``fit_task``'s ``initial_opt_state`` takes). A JAX checkpoint
    has no generator state: its PRNG key (``__rng__``) cannot continue in a
    torch generator, so the generator stays as seeded, with a note."""
    load_opt_state(path, state.optimizer)
    gen = load_generator_state(path)
    if gen is not None:
        state.generator.set_state(gen)
        return
    with np.load(_npz_path(path)) as npz:
        if "__rng__" in npz.files:
            print(f"[reni_tpu_torch] {path} holds a JAX PRNG key, which a torch "
                  "generator cannot continue: the random stream restarts from the "
                  "run's seed (TRAINER.SEED)", flush=True)


def load_model_config(path: str, **overrides) -> RENIConfig:
    """The RENIConfig stored in a checkpoint's metadata."""
    _, meta = _meta_only(path)
    cfg = dict(meta["model_config"])
    cfg.update(overrides)
    return RENIConfig(**cfg)


def _meta_only(path: str) -> tuple[None, dict]:
    with open(_json_path(path)) as f:
        return None, json.load(f)


def find_latest(path: str) -> str:
    """Resolve ``path`` to a concrete checkpoint for ``--resume``.

    A file path passes through. A directory (a run dir or its checkpoints/
    subdir) resolves to the newest checkpoint, preferring the ``*_latest``
    files the trainer overwrites at every periodic save, so a crash loses at
    most EVERY_N_EPOCHS epochs even when best-K retention deleted newer
    checkpoints."""
    if os.path.exists(_json_path(path)):
        return path
    cands = []
    for root in (path, os.path.join(path, "checkpoints")):
        if os.path.isdir(root):
            cands += [
                os.path.join(root, f[: -len(".json")])
                for f in os.listdir(root)
                if f.endswith(".json")
                and os.path.exists(_npz_path(os.path.join(root, f[: -len(".json")])))
            ]
    if not cands:
        raise FileNotFoundError(f"no checkpoints found under {path!r}")
    latest = [c for c in cands if c.endswith("_latest")]
    pool = latest or cands
    return max(pool, key=lambda c: os.path.getmtime(_json_path(c)))


def save_fit_result(
    path: str, params: Params, *, model_config: RENIConfig, task: str, metrics: dict
) -> None:
    """Write a task's result with the metadata the JAX package records for
    it (``task``, ``epoch``: epochs run, ``loss``: the last epoch's loss, as
    in ``data/Zoo/*/latents_test.json``); JAX ``load_checkpoint`` reads it."""
    key = f"{task.lower()}_loss"
    save_checkpoint(
        path, params, model_config=model_config,
        metadata={"task": task, "epoch": int(len(metrics[key])),
                  "loss": float(metrics[key][-1])},
    )


def load_decoder_only(
    path: str, model: RENIModel, dataset_size: int, generator: torch.Generator,
    device=None,
) -> Params:
    """Decoder weights from the checkpoint on ``device`` (default: the card)
    and a fresh latent table sized for the new dataset: the fixed_decoder
    partial restore."""
    saved, _ = load_checkpoint(path)
    return {
        "decoder": from_numpy(saved["decoder"], device),
        "latents": model.init_latents(generator, dataset_size, device=device),
    }
