"""Training tasks (counterpart of ``reni_tpu/train/tasks.py``): FIT_LATENT.

The JAX package runs each resolution stage as one compiled ``lax.scan`` over
epochs of a ``lax.scan`` over batches; here a plain Python loop runs the
same steps in the same order: the whole dataset resident on the device,
sequential fixed batches (the reference's DataLoader does not shuffle) with
a zero-masked ragged tail, one step function per resolution stage of the
multi-resolution curriculum, and per-epoch metrics that are means over the
epoch's batches.

Padded rows contribute exactly zero to every loss term (their sineweight
rows, Z rows and per-sample cosine term are multiplied by the batch mask),
which reproduces the reference's drop_last=False sum-over-batch semantics.

FIT_DECODER and FIT_INVERSE, the mesh, streaming, callbacks and resume arrive
with later slices (ROADMAP.md Queue A); their arguments raise here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.params import map_tree, tree_leaves
from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.train import losses
from reni_tpu_torch.train.optim import (
    OptimConfig,
    ScheduledOptimizer,
    build_optimizer,
    merge_params,
    partition_params,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Per-task training hyperparameters (configs/default.py:24-83).
    ``from_config`` (a reference-format config tree) arrives with the port's
    config module."""

    task: str = "FIT_DECODER"  # FIT_DECODER | FIT_LATENT | FIT_INVERSE
    optim: OptimConfig = OptimConfig()
    batch_size: int = 1
    epochs: int = 2400
    multi_res_training: bool = True
    initial_resolution: tuple[int, int] = (16, 32)
    final_resolution: tuple[int, int] = (64, 128)
    curriculum: tuple[int, ...] = (800, 1600)
    # FIT_DECODER
    kld_weighting: float = 1e-4
    # FIT_LATENT / FIT_INVERSE
    cosine_similarity_weight: float = 1e-4
    prior_loss_weight: float = 1e-7
    apply_mask: bool = False
    mask_path: str | None = None
    # FIT_INVERSE
    render_resolution: int = 128
    object_path: str | None = None
    kd_value: float = 0.5
    azimuths: tuple[float, ...] = (0.0,)
    elevations: tuple[float, ...] = (0.0,)

    def effective_curriculum(self) -> tuple[int, ...]:
        """Curriculum epochs; when None/empty, resolution doublings are
        evenly spaced across the epochs (configs/default.py:37)."""
        if self.curriculum:
            return tuple(self.curriculum)
        h0, h1 = self.initial_resolution[0], self.final_resolution[0]
        n = int(round(math.log2(h1 / h0)))
        if n <= 0:
            return ()
        return tuple(self.epochs * (i + 1) // (n + 1) for i in range(n))

    def validate(self):
        """The reference's config asserts (RENI_module.py:360-361)."""
        if self.multi_res_training:
            cur = self.effective_curriculum()
            h0, h1 = self.initial_resolution[0], self.final_resolution[0]
            if cur:
                assert max(cur) < self.epochs
            assert len(cur) >= math.log2(h1 / h0)

    def resolution_stages(self) -> list[tuple[tuple[int, int], int]]:
        """[(resolution, n_epochs)], doubling at each curriculum epoch."""
        if not self.multi_res_training:
            return [(tuple(self.final_resolution), self.epochs)]
        stages = []
        res = tuple(self.initial_resolution)
        prev = 0
        for c in self.effective_curriculum():
            if c > self.epochs:
                break
            stages.append((res, c - prev))
            res = (res[0] * 2, res[1] * 2)
            prev = c
        stages.append((res, self.epochs - prev))
        return [(r, n) for r, n in stages if n > 0]


@dataclasses.dataclass
class TrainState:
    """Trainable leaves (tensors that require grad), frozen leaves, the
    optimizer over the trainable ones, and the task's random generator."""

    trainable: Params
    frozen: Params
    optimizer: ScheduledOptimizer
    generator: torch.Generator

    @property
    def params(self) -> Params:
        return merge_params(self.trainable, self.frozen)


def init_train_state(
    model: RENIModel, params: Params, optim_cfg: OptimConfig, generator: torch.Generator
) -> TrainState:
    """Partition ``params`` by ``model.trainable_mask``: trainable leaves are
    copied (the caller's tree is not updated in place) and require grad."""
    trainable, frozen = partition_params(params, model.trainable_mask(params))
    trainable = map_tree(lambda t: t.detach().clone().requires_grad_(True), trainable)
    frozen = map_tree(lambda t: t.detach(), frozen)
    optimizer = build_optimizer(optim_cfg, tree_leaves(trainable))
    return TrainState(trainable, frozen, optimizer, generator)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------


def make_batches(dataset_size: int, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Sequential fixed batches with a zero-masked ragged tail.

    Returns (idx (nb, B) int32, mask (nb, B) f32)."""
    nb = -(-dataset_size // batch_size)
    idx = np.zeros((nb * batch_size,), dtype=np.int32)
    idx[:dataset_size] = np.arange(dataset_size, dtype=np.int32)
    mask = np.zeros((nb * batch_size,), dtype=np.float32)
    mask[:dataset_size] = 1.0
    return idx.reshape(nb, batch_size), mask.reshape(nb, batch_size)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_fit_latent_step(
    model: RENIModel,
    directions: torch.Tensor,
    sineweight: torch.Tensor,
    *,
    alpha: float,
    beta: float,
) -> Callable:
    """One FIT_LATENT update (frozen decoder; deterministic mu/Z latents).
    Batch = (imgs (B, P, 3), idx (B,), bmask (B,)); returns (state, metrics
    of 0-d tensors). ``sineweight`` should already include the in-painting
    mask if any (RENI_module.py:92-94)."""

    def step(state: TrainState, batch):
        imgs, idx, bmask = batch
        sw = sineweight * bmask[:, None, None]
        params = state.params
        Z = model.latents(params, idx) * bmask[:, None, None]
        out = model.apply(params, Z, directions)
        loss, mse, prior, cos = losses.reni_test_loss_masked(
            out, imgs, sw, Z, bmask, alpha=alpha, beta=beta
        )
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        metrics = {"loss": loss, "mse_loss": mse, "prior_loss": prior, "cosine_loss": cos}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# stage runner and task loop
# ---------------------------------------------------------------------------


def run_stage(
    step_fn: Callable, state: TrainState, images: torch.Tensor, n_epochs: int,
    batch_size: int,
) -> tuple[TrainState, dict]:
    """``n_epochs`` epochs of sequential batches of ``step_fn``.

    images: (S, P, 3) on the training device. Returns (state, metrics) with
    metrics values of shape (n_epochs,): each epoch's mean over its batches
    (RENI_module.py:148-163)."""
    idx, bmask = make_batches(images.shape[0], batch_size)
    dev = images.device
    idx_b = torch.as_tensor(idx, dtype=torch.long, device=dev)
    bmask_b = torch.as_tensor(bmask, dtype=images.dtype, device=dev)
    epochs = []
    for _ in range(n_epochs):
        ms = []
        for b in range(idx_b.shape[0]):
            state, m = step_fn(state, (images[idx_b[b]], idx_b[b], bmask_b[b]))
            ms.append(m)
        epochs.append({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})
    metrics = {k: torch.stack([e[k] for e in epochs]).cpu().numpy() for k in epochs[0]}
    return state, metrics


# fit_task arguments of the JAX package that later slices bring, with the
# value that leaves them off
_LATER = {
    "mesh": (None, "Queue A-11 (parallel/mesh.py)"),
    "shard_latents": (False, "Queue A-11 (parallel/mesh.py)"),
    "stream": (False, "Queue A-9 (streaming tiers)"),
    "stream_chunk": (1, "Queue A-9 (streaming tiers)"),
    "stream_dtype": (None, "Queue A-9 (streaming tiers)"),
    "precompile": (False, "Queue A-13 (left out until the card needs it)"),
    "reaugment": (False, "Queue A-6 (datasets and transforms)"),
    "callback": (None, "Queue A-4 (segment callbacks, checkpoints, resume)"),
    "callback_every": (None, "Queue A-4 (segment callbacks, checkpoints, resume)"),
    "start_epoch": (0, "Queue A-4 (segment callbacks, checkpoints, resume)"),
    "initial_opt_state": (None, "Queue A-4 (segment callbacks, checkpoints, resume)"),
}


def fit_task(
    model: RENIModel,
    params: Params,
    task_cfg: TaskConfig,
    images_at: Callable[[tuple[int, int]], torch.Tensor],
    generator: torch.Generator,
    *,
    mask_path: str | None = None,
    step_builder: Callable | None = None,
    mesh=None,
    callback_every: int | None = None,
    callback: Callable | None = None,
    start_epoch: int = 0,
    initial_opt_state=None,
    reaugment: bool = False,
    shard_latents: bool = False,
    stream: bool = False,
    stream_chunk: int = 1,
    stream_dtype=None,
    precompile: bool = False,
) -> tuple[Params, dict]:
    """Run a whole task with its multi-resolution curriculum (the resident
    single-device path of the JAX ``fit_task``).

    images_at(res) -> (S, H*W, 3) normalised images at that resolution, on
    the training device and in the training dtype (that of the latents).
    Directions, sineweights and the mask are built in float32, as the JAX
    package builds them; the sineweight is then cast to that dtype. ``step_builder(model,
    directions, sineweight, res)`` replaces the task's step function. The
    remaining arguments are those of later slices and raise
    NotImplementedError unless left at their defaults.

    Returns (params, metrics dict of (epochs,) arrays under the reference's
    keys ``{task}_{name}``)."""
    given = dict(
        mesh=mesh, shard_latents=shard_latents, stream=stream, stream_chunk=stream_chunk,
        stream_dtype=stream_dtype, precompile=precompile, reaugment=reaugment,
        callback=callback, callback_every=callback_every, start_epoch=start_epoch,
        initial_opt_state=initial_opt_state,
    )
    for name, value in given.items():
        off, where = _LATER[name]
        if value != off:
            raise NotImplementedError(f"fit_task({name}=...) is not ported yet: {where}")
    task_cfg.validate()
    if step_builder is None and task_cfg.task != "FIT_LATENT":
        raise NotImplementedError(
            f"task {task_cfg.task} is not ported yet (FIT_DECODER: Queue A-2; "
            "FIT_INVERSE: Queue A-8)"
        )
    batch_size = task_cfg.batch_size
    stages = task_cfg.resolution_stages()
    n_images = images_at(tuple(stages[0][0])).shape[0]
    optim_cfg = dataclasses.replace(
        task_cfg.optim, epochs=task_cfg.epochs, steps_per_epoch=-(-n_images // batch_size)
    )
    state = init_train_state(model, params, optim_cfg, generator)
    table = model.latents(state.params)
    dev, dtype = table.device, table.dtype

    all_metrics = []
    for res, n_epochs in stages:
        width = res[1]
        directions = sphere.get_directions(width, device=dev)
        sineweight = sphere.get_sineweight(width, device=dev)
        if task_cfg.apply_mask and mask_path:
            sineweight = sineweight * sphere.get_mask(width, mask_path, device=dev)
        # the directions stay float32: the decoder computes their features
        # in float32 and promotes them, as the JAX package does
        sineweight = sineweight.to(dtype)
        if step_builder is not None:
            step_fn = step_builder(model, directions, sineweight, res)
        else:
            step_fn = make_fit_latent_step(
                model, directions, sineweight,
                alpha=task_cfg.prior_loss_weight, beta=task_cfg.cosine_similarity_weight,
            )
        state, metrics = run_stage(step_fn, state, images_at(tuple(res)), n_epochs, batch_size)
        all_metrics.append(metrics)

    merged = {
        f"{task_cfg.task.lower()}_{k}": np.concatenate([m[k] for m in all_metrics])
        for k in all_metrics[0]
    }
    return map_tree(lambda t: t.detach(), state.params), merged
