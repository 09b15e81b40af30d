"""Training tasks (counterpart of ``reni_tpu/train/tasks.py``): FIT_DECODER,
FIT_LATENT and FIT_INVERSE.

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

FIT_DECODER's MSE term runs through the train-step kernel of the model's
conditioning (``kernels/siren_step.py``: ``fused_step_mse`` for
Cond-by-Concat, ``fused_film_step_mse`` for FiLM; value and every gradient
in one call) where ``RENIModel.fused_step_reason`` allows it, else through
``RENIModel.apply`` and autograd; a note says which route a shape took.

FIT_INVERSE's step (``make_fit_inverse_step``) decodes, unnormalises,
renders (``reni_tpu_torch/render``) and takes the render loss; its scene and
ground-truth renders come from ``render/inverse.py::fit_inverse``, which
passes ``fit_task`` the step builder.

``fit_task`` runs each stage in segments between callbacks (checkpoints,
images, the deadline) and resumes a task mid-way from a checkpoint's epoch,
optimizer state and generator state, bit for bit the uncut run. The mesh
and streaming arrive with later slices (ROADMAP.md Queue A); their
arguments raise here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.params import map_tree, tree_items
from reni_tpu_torch.models.reni import RENIModel, _note_trunk_path
from reni_tpu_torch.train import losses
from reni_tpu_torch.train.checkpoint import set_opt_state
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
    """Per-task training hyperparameters (configs/default.py:24-83)."""

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

    @classmethod
    def from_config(cls, config, task: str) -> "TaskConfig":
        """Build from a reference-format config tree (``utils/config.py``):
        config.RENI[task] (configs/default.py:24-83; key spellings kept,
        INITAL_RESOLUTION included)."""
        t = config.RENI[task]
        optim = OptimConfig(
            lr_start=float(t.LR_START),
            lr_end=float(t.LR_END),
            optimizer=t.OPTIMIZER,
            beta1=float(t.OPTIMIZER_BETA_1),
            beta2=float(t.OPTIMIZER_BETA_2),
            scheduler_type=t.SCHEDULER_TYPE,
            scheduler_step_size=int(t.SCHEDULER_STEP_SIZE),
            scheduler_gamma=float(t.SCHEDULER_GAMMA),
            epochs=int(t.EPOCHS),
        )
        kwargs = dict(
            task=task,
            optim=optim,
            batch_size=int(t.BATCH_SIZE),
            epochs=int(t.EPOCHS),
            multi_res_training=bool(t.MULTI_RES_TRAINING),
            initial_resolution=tuple(t.INITAL_RESOLUTION),
            final_resolution=tuple(t.FINAL_RESOLUTION),
            curriculum=tuple(t.CURRICULUM or ()),
        )
        if task == "FIT_DECODER":
            kwargs["kld_weighting"] = float(t.KLD_WEIGHTING)
        else:
            kwargs["cosine_similarity_weight"] = float(t.COSINE_SIMILARITY_WEIGHT)
            kwargs["prior_loss_weight"] = float(t.PRIOR_LOSS_WEIGHT)
        if task == "FIT_LATENT":
            kwargs["apply_mask"] = bool(t.APPLY_MASK)
            kwargs["mask_path"] = t.MASK_PATH
        if task == "FIT_INVERSE":
            kwargs["render_resolution"] = int(t.RENDER_RESOLUTION)
            kwargs["object_path"] = t.OBJECT_PATH
            kwargs["kd_value"] = float(t.KD_VALUE)
            kwargs["azimuths"] = tuple(float(a) for a in t.AZIMUTHS)
            kwargs["elevations"] = tuple(float(e) for e in t.ELEVATIONS)
        return cls(**kwargs)

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
    names, leaves = zip(*tree_items(trainable))
    optimizer = build_optimizer(optim_cfg, leaves, list(names))
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


def make_fit_decoder_step(
    model: RENIModel,
    directions: torch.Tensor,
    sineweight: torch.Tensor,
    *,
    kld_weighting: float,
    latent_noise: Callable | None = None,
) -> Callable:
    """One FIT_DECODER update (decoder and latents train). Batch = (imgs
    (B, P, 3), idx (B,), bmask (B,)); returns (state, metrics of 0-d tensors).

    A VAD samples its latents with noise from the state's generator, or from
    ``latent_noise(shape)`` when given (the tests feed the noise JAX drew);
    mu and log_var of padded rows are masked out of the KLD term, which stays
    outside the kernel. Where ``model.fused_step_reason`` is None the MSE
    term and all its gradients come from the train-step kernel
    (Cond-by-Concat or FiLM, ``RENIModel.fused_train_mse``); otherwise
    from ``model.apply`` and autograd (on the card, with ``use_pallas``, the
    forward and backward kernels). Both routes compute the same loss."""
    cfg = model.config
    z_dims = 3 * cfg.latent_dim

    def step(state: TrainState, batch):
        imgs, idx, bmask = batch
        B, npix = imgs.shape[0], directions.shape[1]
        reason = model.fused_step_reason(B, npix, directions.shape[0])
        where = f"on {imgs.device.type} for B={B}, npix={npix}"
        if reason is None:
            _note_trunk_path(f"fused train step {where}")
        elif cfg.use_pallas:
            _note_trunk_path(
                f"FIT_DECODER through RENIModel.apply and autograd (train-step kernel "
                f"declined: {reason}) {where}"
            )
        params = state.params
        metrics = {}
        if cfg.is_variational:
            noise = None if latent_noise is None else latent_noise((B, cfg.latent_dim, 3))
            Z, mu, log_var = model.sample_latent(params, idx, state.generator, noise=noise)
            mu = mu * bmask[:, None, None]
            log_var = log_var * bmask[:, None, None]
        else:
            Z = model.latents(params, idx)
        if reason is None:
            mse = model.fused_train_mse(params, Z, directions, imgs, sineweight, bmask)
        else:
            out = model.apply(params, Z, directions)
            mse = losses.weighted_mse(out, imgs, sineweight * bmask[:, None, None])
        loss = mse
        if cfg.is_variational:
            kl = kld_weighting * losses.kld(mu, log_var, z_dims)
            loss = mse + kl
            metrics = {"mse_loss": mse, "kld_loss": kl}
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        metrics = {"loss": loss, **metrics}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


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


def make_fit_inverse_step(
    model: RENIModel,
    directions: torch.Tensor,
    sineweight: torch.Tensor,
    render_fn: Callable,
    unnormalise: Callable,
    *,
    alpha: float,
    beta: float,
) -> Callable:
    """One FIT_INVERSE update: decode -> unnormalise -> differentiable render
    -> loss against the ground-truth renders (RENI_module.py:107-112,
    386-396); the optimizer moves only the trainable latents.

    render_fn: (envmaps (B, P, 3), sineweight (B, P, 3)) -> (B, H, W, 3).
    Batch = (gt_renders (B, H, W, 3), idx (B,), bmask (B,)); returns (state,
    metrics of 0-d tensors)."""

    def step(state: TrainState, batch):
        gt_renders, idx, bmask = batch
        sw = sineweight * bmask[:, None, None]
        params = state.params
        Z = model.latents(params, idx) * bmask[:, None, None]
        out = model.apply(params, Z, directions)
        render = render_fn(unnormalise(out), sw)
        loss, mse, prior, cos = losses.reni_test_loss_inverse_masked(
            render, gt_renders, Z, bmask, alpha=alpha, beta=beta
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
}


def fit_task(
    model: RENIModel,
    params: Params,
    task_cfg: TaskConfig,
    images_at: Callable[..., torch.Tensor],
    generator: torch.Generator,
    *,
    mask_path: str | None = None,
    step_builder: Callable | None = None,
    latent_noise: Callable | None = None,
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
    the training device and in the training dtype (that of the latents);
    with ``reaugment`` it is called as images_at(res, epoch) every epoch
    (the reference's per-item random augmentation). Directions, sineweights
    and the mask are built in float32, as the JAX package builds them; the
    sineweight is then cast to that dtype. ``step_builder(model, directions,
    sineweight, res)`` replaces the task's step function.
    ``latent_noise(shape)`` replaces the generator's noise in FIT_DECODER's
    latent sampling.

    ``callback(state, epoch, metrics, res)`` runs every ``callback_every``
    epochs and at each stage's end (``epoch`` the completed count, ``metrics``
    the segment's per-epoch arrays); a truthy return stops the task. With
    ``RENI_TPU_CKPT_WALL_S`` set, a stage's segments start at one epoch and
    adapt (powers of two, at most ``callback_every``) so that callbacks come
    about that many seconds apart.

    Mid-task resume: ``start_epoch`` epochs are skipped, and
    ``initial_opt_state`` restores the optimizer: an optax-layout dict
    (``checkpoint.read_opt_state``) or a loader called with the fresh
    ``TrainState`` (``checkpoint.load_train_state``: the optimizer state
    into its optimizer, the generator state into its generator). The
    optimizer's step count keeps
    the LR schedule exact. The mesh and streaming arguments raise
    NotImplementedError unless left at their defaults.

    Returns (params, metrics dict of (epochs run,) arrays under the
    reference's keys ``{task}_{name}``)."""
    given = dict(
        mesh=mesh, shard_latents=shard_latents, stream=stream, stream_chunk=stream_chunk,
        stream_dtype=stream_dtype, precompile=precompile,
    )
    for name, value in given.items():
        off, where = _LATER[name]
        if value != off:
            raise NotImplementedError(f"fit_task({name}=...) is not ported yet: {where}")
    task_cfg.validate()
    if step_builder is None and task_cfg.task not in ("FIT_DECODER", "FIT_LATENT"):
        raise ValueError(
            f"task {task_cfg.task}: provide step_builder (FIT_INVERSE is built by "
            "reni_tpu_torch.render.inverse.fit_inverse)"
        )
    batch_size = task_cfg.batch_size
    stages = task_cfg.resolution_stages()
    n_images = images_at(tuple(stages[0][0])).shape[0]
    optim_cfg = dataclasses.replace(
        task_cfg.optim, epochs=task_cfg.epochs, steps_per_epoch=-(-n_images // batch_size)
    )
    state = init_train_state(model, params, optim_cfg, generator)
    if initial_opt_state is not None:
        if callable(initial_opt_state):
            initial_opt_state(state)
        else:
            set_opt_state(state.optimizer, initial_opt_state)
    table = model.latents(state.params)
    dev, dtype = table.device, table.dtype

    def make_step(res):
        width = res[1]
        directions = sphere.get_directions(width, device=dev)
        sineweight = sphere.get_sineweight(width, device=dev)
        if task_cfg.apply_mask and mask_path:
            sineweight = sineweight * sphere.get_mask(width, mask_path, device=dev)
        # the directions stay float32: the decoder computes their features
        # in float32 and promotes them, as the JAX package does
        sineweight = sineweight.to(dtype)
        if step_builder is not None:
            return step_builder(model, directions, sineweight, res)
        if task_cfg.task == "FIT_DECODER":
            return make_fit_decoder_step(
                model, directions, sineweight, kld_weighting=task_cfg.kld_weighting,
                latent_noise=latent_noise,
            )
        return make_fit_latent_step(
            model, directions, sineweight,
            alpha=task_cfg.prior_loss_weight, beta=task_cfg.cosine_similarity_weight,
        )

    # (res, epochs to run, completed epochs before them) after the resume skip
    plan, off = [], 0
    for res, n in stages:
        skip = min(max(0, start_epoch - off), n)
        plan.append((tuple(res), n - skip, off + skip))
        off += n

    wall_target = float(os.environ.get("RENI_TPU_CKPT_WALL_S", "0") or 0)
    all_metrics = []
    stop = False
    for res, n_epochs, epoch_offset in plan:
        if n_epochs <= 0:  # the stage was done before start_epoch
            continue
        step_fn = make_step(res)
        if reaugment:
            for done in range(1, n_epochs + 1):
                images = images_at(res, epoch_offset + done - 1)
                state, metrics = run_stage(step_fn, state, images, 1, batch_size)
                all_metrics.append(metrics)
                if callback is not None and callback_every and (
                    done % callback_every == 0 or done == n_epochs
                ):
                    stop = bool(callback(state, epoch_offset + done, metrics, res))
                    if stop:
                        break
        elif callback is None or not callback_every:
            state, metrics = run_stage(step_fn, state, images_at(res), n_epochs, batch_size)
            all_metrics.append(metrics)
        else:
            images = images_at(res)
            # with a wall target the first segment of a stage is one epoch
            # (its speed is unknown yet), then segments adapt to the target
            done, seg = 0, 1 if wall_target else min(callback_every, n_epochs)
            while done < n_epochs:
                seg = min(seg, n_epochs - done)
                t0 = time.monotonic()
                state, metrics = run_stage(step_fn, state, images, seg, batch_size)
                done += seg
                all_metrics.append(metrics)
                stop = bool(callback(state, epoch_offset + done, metrics, res))
                if wall_target and done < n_epochs:
                    per_epoch = max((time.monotonic() - t0) / seg, 1e-9)
                    ideal = max(1, int(wall_target / per_epoch))
                    seg = min(callback_every, 1 << (ideal.bit_length() - 1))
                if stop:
                    break
        if stop:
            break

    if not all_metrics:
        raise ValueError(
            f"nothing to train: start_epoch={start_epoch} >= epochs={task_cfg.epochs} "
            "(the resume checkpoint already completed this task; raise EPOCHS to "
            "continue it)"
        )
    merged = {
        f"{task_cfg.task.lower()}_{k}": np.concatenate([m[k] for m in all_metrics])
        for k in all_metrics[0]
    }
    return map_tree(lambda t: t.detach(), state.params), merged
