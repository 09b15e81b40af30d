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
passes ``fit_task`` the step builder. On one card it replays one captured
CUDA graph of the whole update (``GraphedStep``), so that the card, not the
host's enqueue, paces it.

``fit_task`` runs each stage in segments between callbacks (checkpoints,
images, the deadline) and resumes a task mid-way from a checkpoint's epoch,
optimizer state and generator state, bit for bit the uncut run. With
``stream`` the dataset stays on the host (an array, or a ``DiskRowSource``
that decodes from disk) and ``streaming_stage_runner`` copies it to the
card a batch (or ``stream_chunk`` batches) at a time, overlapped with the
steps: the same steps on the same values as the resident tier. With a
``mesh`` (``parallel/mesh.py``) every rank runs these steps on its block of
each batch and the ranks sum their gradients (ROADMAP Queue A-11).
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
from reni_tpu_torch.models.reni import (
    RENIModel,
    _mesh_suffix,
    _note_trunk_path,
    draw_noise,
    reparameterise,
)
from reni_tpu_torch.parallel import multihost
from reni_tpu_torch.parallel.mesh import (
    PixelSlice,
    active_view,
    batch_local_positions,
    chunk_gather,
    kernel_mesh,
    pad_batch_to,
    shard_for_stage,
    sharded_stage_runner,
    stream_chunk_layout,
)
from reni_tpu_torch.params import map_tree, tree_items, tree_leaves
from reni_tpu_torch.train import losses
from reni_tpu_torch.train.checkpoint import set_opt_state
from reni_tpu_torch.train.optim import (
    OptimConfig,
    ScheduledOptimizer,
    build_optimizer,
    merge_params,
    partition_params,
)
from reni_tpu_torch.utils.graphs import add_launches, keeping, launch_counts, take_launches
from reni_tpu_torch.utils.profiling import GraphTimer, graph_marks, span

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


def _block(view, B: int, directions: torch.Tensor, sineweight: torch.Tensor):
    """(rows, directions, sineweight) of this rank's block of a batch of
    ``B`` on a mesh (``view``: ``parallel.mesh.active_view()``): its rows
    and its slice of the pixel axis; everything without one."""
    if view is None:
        return slice(None), directions, sineweight
    rows = view.rows(B)
    d = directions[rows] if directions.shape[0] == B and B > 1 else directions
    return rows, d[:, view.pix], sineweight[:, view.pix]


def _latent_rows(model: RENIModel, params: Params, idx, view, names) -> list[torch.Tensor]:
    """The latent tables ``names`` at this rank's rows of the batch ``idx``
    (a row-sharded table's through ``ShardView.latent_rows``)."""
    tables = [params["latents"][n] for n in names]
    if view is None:
        idx = model._as_index(idx, tables[0].device)
        return [t[idx] for t in tables]
    return view.latent_rows(tables, idx)


def _counted(view, metrics: dict, pixels: tuple, images: tuple) -> dict:
    """On a mesh, the terms this rank does not count zeroed: ``pixels``
    (pixel partials) on a replica of a pixel axis that does not divide,
    ``images`` (per-image terms) off pixel coordinate 0."""
    if view is None:
        return metrics
    for names, counts in ((pixels, view.counts_pixels), (images, view.counts_images)):
        if not counts:
            metrics.update({k: metrics[k] * 0.0 for k in names if k in metrics})
    return metrics


def _update(state: TrainState, loss: torch.Tensor, metrics: dict, view) -> dict:
    """Backward, on a mesh the one all-reduce of the gradient bucket and the
    metric partials (``ShardView.reduce``), then the optimizer's step."""
    state.optimizer.zero_grad()
    with span("task.backward", loss):
        loss.backward()
    if view is not None:
        metrics = view.reduce(tree_leaves(state.trainable), metrics)
    state.optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


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
    forward and backward kernels). Both routes compute the same loss.

    On a mesh (a stage runner's ``parallel.mesh.kernel_mesh``) imgs is this
    rank's block (its rows, its pixels) and idx, bmask are the whole
    batch's: the step decodes its block through the kernels, draws the whole
    batch's noise in the single-device order and keeps its rows, counts the
    KLD on pixel coordinate 0, and sums the gradients over the mesh."""
    cfg = model.config
    z_dims = 3 * cfg.latent_dim

    def step(state: TrainState, batch):
        imgs, idx, bmask = batch
        view = active_view()
        B, npix = idx.shape[0], directions.shape[1]
        reason = model.fused_step_reason(B, npix, directions.shape[0])
        where = f"on {imgs.device.type} for B={B}, npix={npix}"
        if reason is None:
            _note_trunk_path(f"fused train step{_mesh_suffix()} {where}")
        elif cfg.use_pallas:
            _note_trunk_path(
                f"FIT_DECODER through RENIModel.apply and autograd (train-step kernel "
                f"declined: {reason}) {where}"
            )
        rows, d, sw = _block(view, B, directions, sineweight)
        pixels = None if view is None else npix
        bm = bmask[rows]
        params = state.params
        if cfg.is_variational:
            shape = (B, cfg.latent_dim, 3)
            mu, log_var = _latent_rows(model, params, idx, view, ("mu", "log_var"))
            noise = (draw_noise(shape, mu.dtype, mu.device, state.generator)
                     if latent_noise is None else latent_noise(shape))
            Z = reparameterise(mu, log_var, noise[rows])
            mu = mu * bm[:, None, None]
            log_var = log_var * bm[:, None, None]
        else:
            (Z,) = _latent_rows(model, params, idx, view, ("Z",))
        if reason is None:
            mse = model.fused_train_mse(params, Z, d, imgs, sw, bm, pixels=pixels)
        else:
            out = model.apply(params, Z, d)
            mse = losses.weighted_mse(out, imgs, sw * bm[:, None, None], pixels)
        terms = {"mse_loss": mse}
        if cfg.is_variational:
            terms["kld_loss"] = kld_weighting * losses.kld(mu, log_var, z_dims)
        terms = _counted(view, terms, ("mse_loss",), ("kld_loss",))
        if cfg.is_variational:
            loss = terms["mse_loss"] + terms["kld_loss"]
            metrics = {"loss": loss, **terms}
        else:
            loss = terms["mse_loss"]
            metrics = {"loss": loss}
        return state, _update(state, loss, metrics, view)

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
    mask if any (RENI_module.py:92-94). On a mesh as FIT_DECODER's step:
    the cosine term's pixel sums go over the pixel axis, and the prior and
    the cosine count on pixel coordinate 0."""
    names = ("Z",) if not model.config.is_variational else ("mu",)

    def step(state: TrainState, batch):
        imgs, idx, bmask = batch
        view = active_view()
        rows, d, sw = _block(view, idx.shape[0], directions, sineweight)
        bm = bmask[rows]
        sw = sw * bm[:, None, None]
        params = state.params
        (Z,) = _latent_rows(model, params, idx, view, names)
        Z = Z * bm[:, None, None]
        out = model.apply(params, Z, d)
        _, mse, prior, cos = losses.reni_test_loss_masked(
            out, imgs, sw, Z, bm, alpha=alpha, beta=beta,
            pixels=None if view is None else directions.shape[1],
            pixel_sum=None if view is None else view.pixel_sum,
        )
        metrics = _counted(view, {"mse_loss": mse, "prior_loss": prior, "cosine_loss": cos},
                           ("mse_loss",), ("prior_loss", "cosine_loss"))
        loss = metrics["mse_loss"] + metrics["prior_loss"] + metrics["cosine_loss"]
        return state, _update(state, loss, {"loss": loss, **metrics}, view)

    return step


@dataclasses.dataclass
class _Graph:
    """One captured update of a ``GraphedStep``: the graph's timer (which
    replays it), its static inputs (the batch's tensors), its output (the
    metrics stacked, under ``names``), the state's tensors it reads
    (``anchors``), the caches' operands it holds (``kept``) and what its
    capture added to the kernels' launch counters (``launched``,
    ``utils/graphs.py::take_launches``), which each replay adds."""

    timer: GraphTimer
    inputs: tuple
    out: torch.Tensor
    names: tuple
    anchors: tuple
    kept: list
    launched: tuple = ()

    def holds(self, anchors: tuple) -> bool:
        return len(anchors) == len(self.anchors) and all(
            a is b for a, b in zip(anchors, self.anchors))


_SEEN, _EAGER = "seen", "eager"  # a key's eager first call ran / its capture raised


class GraphedStep:
    """A train step that replays one captured CUDA graph of the whole update
    (ROADMAP B-6): FIT_INVERSE's on one card. ``eager(state, batch)`` is the
    step as it runs without a graph; ``body(state, batch)`` its forward on
    one card, (loss, metrics). Per key (the batch tensors' shapes, dtypes and
    device; the direction grid is the step's own), calls go:

    1. the first runs ``eager``, a real update, after making the Adam
       capturable (``ScheduledOptimizer.make_capturable``; its eager steps
       and the replays then do the same arithmetic). It fills what the
       capture must find: Adam's moments, cuBLAS's workspace, the decoder's
       stacked and packed weights, the render's transport matrix;
    2. the second captures the update (``body``, the backward and Adam's
       step, with zero_grad(set_to_none) inside) and replays it once: the
       capture runs nothing, so that replay is the call's one update;
    3. each later one copies its batch into the graph's inputs, writes the
       update's LR into the LR tensor, replays, adds the launches the
       capture's calls counted (and took back) to the kernels' counters,
       and returns copies of the metrics, which the next replay does not
       overwrite.

    A graph holds what it reads: the caches' operands (``utils/graphs.py``),
    and the state's tensors, which each call checks by identity: a state
    with other tensors (another state, a restored optimizer) starts its key
    again at 1. Off the card, under a mesh (``parallel.mesh.active_view``),
    with an optimizer other than Adam, or where the capture raises, the step
    runs ``eager`` and says why once. Spans: ``task.graph_capture`` around a
    capture, ``task.graph_replay`` (device events) around a replay, and in
    a profiler session, under it, the spans the capture opened
    (``utils/profiling.py::GraphTimer``)."""

    def __init__(self, eager: Callable, body: Callable):
        self.eager, self.body = eager, body
        self.graphs: dict = {}

    def why_eager(self, state: TrainState, batch) -> str | None:
        if not all(t.is_cuda for t in batch):
            return "not on a CUDA device"
        if active_view() is not None:
            return "a mesh is active"
        opt = state.optimizer.optimizer
        if type(opt) is not torch.optim.Adam:
            return f"{type(opt).__name__} has no capturable form here"
        return None

    @staticmethod
    def anchors(state: TrainState) -> tuple:
        opt = state.optimizer
        trained = tree_leaves(state.trainable)
        moments = [t for p in trained for t in opt.optimizer.state.get(p, {}).values()
                   if isinstance(t, torch.Tensor)]
        return (opt, opt.lr, *trained, *tree_leaves(state.frozen), *moments)

    def __call__(self, state: TrainState, batch):
        why = self.why_eager(state, batch)
        if why is not None:
            _note_trunk_path(f"the FIT_INVERSE step runs eagerly: {why}")
            return self.eager(state, batch)
        key = tuple((t.shape, t.dtype, t.device) for t in batch)
        entry = self.graphs.get(key)
        if isinstance(entry, _Graph) and not entry.holds(self.anchors(state)):
            entry = None
        if entry is None:
            state.optimizer.make_capturable(batch[0].device)
            self.graphs[key] = _SEEN
            return self.eager(state, batch)
        if entry is _SEEN:
            try:
                entry = self.capture(state, batch)
            except Exception as e:  # any capture that raises leaves the key eager
                self.graphs[key] = _EAGER
                _note_trunk_path(f"the FIT_INVERSE step runs eagerly at {key}: its CUDA "
                                 f"graph capture raised {type(e).__name__}: {e}")
                return self.eager(state, batch)
            self.graphs[key] = entry
        if entry is _EAGER:
            return self.eager(state, batch)
        return state, self.replay(entry, state, batch)

    def capture(self, state: TrainState, batch) -> _Graph:
        """Capture the update on ``batch`` (its copy the graph's inputs)."""
        inputs = tuple(t.clone() for t in batch)
        opt = state.optimizer.optimizer
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # GraphTimer reads its nodes
        marks, kept, counted = [], [], launch_counts()
        try:
            with span("task.graph_capture"):
                with keeping(kept), graph_marks(marks), torch.cuda.graph(graph):
                    opt.zero_grad(set_to_none=True)
                    loss, metrics = self.body(state, inputs)
                    with span("task.backward", loss):
                        loss.backward()
                    opt.step()
                    out = torch.stack([v.detach() for v in metrics.values()])
                graph.instantiate()
        finally:  # the capture's calls launched nothing, raised or not
            launched = take_launches(counted)
        return _Graph(GraphTimer(graph, marks), inputs, out, tuple(metrics), self.anchors(state),
                      kept, launched)

    @staticmethod
    def replay(g: _Graph, state: TrainState, batch) -> dict:
        for dst, src in zip(g.inputs, batch):
            dst.copy_(src)
        with span("task.graph_replay", g.out):
            state.optimizer.step(g.timer.replay)
        add_launches(g.launched)
        return dict(zip(g.names, g.out.clone().unbind()))


def make_fit_inverse_step(
    model: RENIModel,
    directions: torch.Tensor,
    sineweight: torch.Tensor,
    render_fn: Callable,
    unnormalise: Callable,
    *,
    alpha: float,
    beta: float,
) -> "GraphedStep":
    """One FIT_INVERSE update: decode -> unnormalise -> differentiable render
    -> loss against the ground-truth renders (RENI_module.py:107-112,
    386-396); the optimizer moves only the trainable latents.

    render_fn: (envmaps (B, P, 3), sineweight (B, P, 3)) -> (B, H, W, 3),
    and with ``rows=`` a slice of H (``InverseRenderSetup.render_fn``).
    Batch = (gt_renders (B, H, W, 3), idx (B,), bmask (B,)); returns (state,
    metrics of 0-d tensors). On a mesh gt_renders is this rank's block: its
    rows of the batch and, where H divides the pixel axis, its slice of H,
    which it renders from the whole decoded light set of its rows. The step
    is a ``GraphedStep``: on one card a replay of one captured CUDA graph of
    the update, else the eager step (its ``eager``)."""

    names = ("Z",) if not model.config.is_variational else ("mu",)

    def forward(state: TrainState, batch, view=None):
        gt_renders, idx, bmask = batch
        rows = slice(None) if view is None else view.rows(idx.shape[0])
        bm = bmask[rows]
        sw = sineweight * bm[:, None, None]
        params = state.params
        (Z,) = _latent_rows(model, params, idx, view, names)
        Z = Z * bm[:, None, None]
        out = model.apply(params, Z, directions)
        kw = {}
        if view is not None:
            kw = dict(n_valid=torch.clamp(torch.sum(bmask), min=1.0),
                      per_sample=view.extent * math.prod(gt_renders.shape[2:]),
                      pixel_sum=view.pixel_sum)
        if view is not None and view.split:
            render = render_fn(unnormalise(out), sw, rows=view.pix)
        else:
            render = render_fn(unnormalise(out), sw)
        _, mse, prior, cos = losses.reni_test_loss_inverse_masked(
            render, gt_renders, Z, bm, alpha=alpha, beta=beta, **kw
        )
        metrics = _counted(view, {"mse_loss": mse, "prior_loss": prior, "cosine_loss": cos},
                           ("mse_loss",), ("prior_loss", "cosine_loss"))
        loss = metrics["mse_loss"] + metrics["prior_loss"] + metrics["cosine_loss"]
        return loss, {"loss": loss, **metrics}

    def step(state: TrainState, batch):
        view = active_view()
        loss, metrics = forward(state, batch, view)
        return state, _update(state, loss, metrics, view)

    return GraphedStep(step, forward)


# ---------------------------------------------------------------------------
# stage runner and task loop
# ---------------------------------------------------------------------------


_UPLOADED: dict = {}  # (device, dtype): the last batches' index and mask and their copies


def _batches_on(idx: np.ndarray, bmask: np.ndarray, device: torch.device,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``idx`` (long) and ``bmask`` (``dtype``) on ``device``: the copies of
    the previous call's, where its arrays were equal. An upload from
    pageable host memory synchronises the stream, and every runner call on
    the card would start with two."""
    last = _UPLOADED.get((device, dtype))
    if last is not None and np.array_equal(last[0], idx) and np.array_equal(last[1], bmask):
        return last[2]
    out = (torch.as_tensor(idx, dtype=torch.long, device=device),
           torch.as_tensor(bmask, dtype=dtype, device=device))
    _UPLOADED[(device, dtype)] = (idx, bmask, out)
    return out


def run_stage(
    step_fn: Callable, state: TrainState, images: torch.Tensor, n_epochs: int,
    batch_size: int,
) -> tuple[TrainState, dict]:
    """``n_epochs`` epochs of sequential batches of ``step_fn``.

    images: (S, P, 3) on the training device. Returns (state, metrics) with
    metrics values of shape (n_epochs,): each epoch's mean over its batches
    (RENI_module.py:148-163). Spans (``utils/profiling.py``): the call
    (``task.call``), the batches' index and mask on the device
    (``task.upload``: uploaded where they changed, ``_batches_on``),
    each step (``task.step``) and the metrics' one synchronise
    (``task.readback``: one copy to the host a dtype, as a runner call
    that ends idle waits on each)."""
    with span("task.call", images):
        with span("task.upload", images):
            idx, bmask = make_batches(images.shape[0], batch_size)
            idx_b, bmask_b = _batches_on(idx, bmask, images.device, images.dtype)
        epochs = []
        for _ in range(n_epochs):
            ms = []
            for b in range(idx_b.shape[0]):
                with span("task.step", images):
                    state, m = step_fn(state, (images[idx_b[b]], idx_b[b], bmask_b[b]))
                ms.append(m)
            epochs.append({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})
        with span("task.readback"):
            stacked = {k: torch.stack([e[k] for e in epochs]) for k in epochs[0]}
            host = {}
            for dtype in {t.dtype for t in stacked.values()}:
                keys = [k for k, t in stacked.items() if t.dtype == dtype]
                host.update(zip(keys, torch.stack([stacked[k] for k in keys]).cpu().numpy()))
            metrics = {k: host[k] for k in stacked}
    return state, metrics


def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k`` (>= 1)."""
    for d in range(min(n, max(1, k)), 0, -1):
        if n % d == 0:
            return d
    return 1


_NUMPY_TO_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


class _CastRows:
    """ndarray-like view casting rows to a narrower dtype at fetch time
    (``TPU.STREAM_DTYPE: bfloat16``): half the bytes a streamed batch copies.
    The cast rounds to nearest even, as the JAX package's ml_dtypes cast
    does. Wraps a host ndarray or a ``DiskRowSource`` (``prefetch`` passes
    through); rows come back as a CPU tensor of ``dtype``."""

    def __init__(self, source, dtype: torch.dtype):
        self._src = source
        self.shape = source.shape
        self.dtype = dtype
        pre = getattr(source, "prefetch", None)
        if pre is not None:
            self.prefetch = pre

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self._src[rows])).to(self.dtype)


def _gather_into(source, rows: np.ndarray, out: torch.Tensor) -> None:
    """``source[rows]`` into the CPU tensor ``out`` (pinned on the card's
    path), cast to its dtype."""
    if isinstance(source, np.ndarray) and out.dtype == _NUMPY_TO_TORCH.get(source.dtype):
        np.take(source, rows, axis=0, out=out.numpy())
        return
    got = source[rows]
    out.copy_(got if isinstance(got, torch.Tensor) else torch.from_numpy(np.asarray(got)))


class _Stager:
    """The streaming runner's two staging slots. On the card each slot is a
    pinned host buffer and a device buffer: ``put`` gathers rows into the
    pinned buffer, once its previous copy has finished, and copies it to the
    device buffer with ``non_blocking=True`` on a side stream, which first
    waits for the step that last read that device buffer; ``get`` makes the
    compute stream wait on the copy's event (the host does not wait) and
    widens to the staging dtype; ``release`` records the event after the
    steps that read the slot. Off the card (a CPU device) a slot is a plain
    tensor, gathered and cast the same way."""

    def __init__(self, shape, copy_dtype: torch.dtype, stage_dtype: torch.dtype,
                 device: torch.device):
        self.stage_dtype = stage_dtype
        self.on_card = device.type == "cuda"
        self._next = 0
        # pin_memory raises where pinning fails: no pageable fallback
        self.host = [torch.empty(shape, dtype=copy_dtype, pin_memory=self.on_card)
                     for _ in range(2)]
        if self.on_card:
            self.dev = [torch.empty(shape, dtype=copy_dtype, device=device) for _ in range(2)]
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]
            self.compute = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def put(self, source, rows: np.ndarray, n_valid: int | None = None) -> int:
        """Stage ``source[rows]``; with ``n_valid``, only the first
        ``n_valid`` rows are fetched and the rest (a mesh rank's padded
        rows, which the step masks) are zeros."""
        slot, self._next = self._next, self._next ^ 1
        if self.on_card:
            self.copied[slot].synchronize()  # the pinned buffer's last copy is done
        host = self.host[slot]
        if n_valid is None or n_valid == len(rows):
            _gather_into(source, rows, host)
        else:
            host[n_valid:].zero_()
            if n_valid:
                _gather_into(source, rows[:n_valid], host[:n_valid])
        if not self.on_card:
            return slot
        with torch.cuda.stream(self.side):
            self.side.wait_event(self.freed[slot])
            self.dev[slot].copy_(self.host[slot], non_blocking=True)
            self.copied[slot].record(self.side)
        return slot

    def get(self, slot: int) -> torch.Tensor:
        if self.on_card:
            self.compute.wait_event(self.copied[slot])
            buf = self.dev[slot]
        else:
            buf = self.host[slot]
        return buf if buf.dtype == self.stage_dtype else buf.to(self.stage_dtype)

    def release(self, slot: int) -> None:
        if self.on_card:
            self.freed[slot].record(self.compute)

    def close(self) -> None:
        if self.on_card:  # the buffers are freed only after the side stream's work
            self.compute.wait_stream(self.side)


def streaming_stage_runner(device, chunk: int = 1, stream_dtype=None, mesh=None,
                           shard_latents: bool = False) -> Callable:
    """A drop-in for ``run_stage`` that keeps the dataset on the HOST (an
    ndarray from ``images_host_at``, or a ``DiskRowSource``) and copies a
    batch a step to ``device``, for datasets larger than the card's memory
    (``TPU.STREAM_DATA``, ``TPU.STREAM_FROM_DISK``). Semantics are those of
    ``run_stage``: the step function gets the same ``(images[rows], idx,
    bmask)`` in the same dtype (the host source's, in which the resident
    tier stages) on the same device, with the same zero-masked ragged tail
    and the same metrics; only the residency of the images differs.

    Each batch is gathered into a pinned buffer, copied to the card with
    ``non_blocking=True`` on a side CUDA stream, and the compute stream waits
    on the copy's event (``_Stager``: two pinned and two device buffers).
    As in the JAX package, the host prefetches batch b+2 (a disk source
    starts its decodes) and stages batch b+1 while step b runs; with one
    batch an epoch the single staged batch is reused.

    ``chunk`` (``TPU.STREAM_CHUNK``) K > 1 stages K batches a copy, K the
    largest divisor of the batches an epoch that is <= ``chunk`` (chunks
    stay epoch-aligned); the K steps then take slices of the staged chunk.
    The JAX package runs those K steps as one compiled ``lax.scan`` to save
    dispatches; torch has no scan to compile, so here K only sets how many
    batches one copy moves. ``stream_dtype=torch.bfloat16``
    (``TPU.STREAM_DTYPE``) rounds the rows to bf16 on the host, copies bf16
    and widens on the card to the staging dtype.

    With a ``mesh`` (``parallel.mesh``) the batch is padded to the data axis
    and each rank stages, and from a ``DiskRowSource`` decodes, only its own
    rows of each batch or chunk (``batch_local_positions``; a chunk laid out
    data-shard-major by ``stream_chunk_layout``) and its pixels where they
    divide the pixel axis; a rank's padded rows are zeros, not decodes. The
    steps run under ``kernel_mesh`` as the resident sharded runner's do,
    ``shard_latents`` row-shards the latent tables for the stage and a model
    axis shards the decoder (``parallel.mesh.shard_for_stage``). The model
    ranks of a data coordinate stage the same rows, so each decodes them
    from disk."""
    device = torch.device(device)
    notes: set = set()

    def note(msg: str) -> None:
        if msg not in notes:  # the runner re-enters every callback segment
            notes.add(msg)
            print(msg)

    def run(step_fn, state, images, n_epochs, batch_size):
        if isinstance(images, torch.Tensor):
            images = images.cpu().numpy()
        elif getattr(images, "prefetch", None) is None:
            images = np.asarray(images)
        npix = images.shape[1]
        stage_dtype = _NUMPY_TO_TORCH[np.dtype(images.dtype)]
        if mesh is not None:
            batch_size = pad_batch_to(batch_size, mesh.n_data)
            if mesh.pixels(npix) != slice(None):
                images = PixelSlice(images, mesh.pixels(npix))
        if stream_dtype is not None and stream_dtype != stage_dtype:
            images = _CastRows(images, stream_dtype)
        copy_dtype = images.dtype if isinstance(images.dtype, torch.dtype) else stage_dtype
        pre = getattr(images, "prefetch", None) or (lambda rows: None)
        idx, bmask = make_batches(images.shape[0], batch_size)
        nb = idx.shape[0]
        K = _largest_divisor_leq(nb, chunk) if nb > 1 else 1
        if chunk > 1 and K == 1 and nb > 1:
            note(f"[reni_tpu_torch] TPU.STREAM_CHUNK={chunk}: no divisor of the {nb} "
                 "batches/epoch in range — unchunked streaming (one copy per optimizer step)")
        elif K > 1 and K != chunk:
            note(f"[reni_tpu_torch] TPU.STREAM_CHUNK={chunk}: using {K} (largest divisor of "
                 f"the {nb} batches/epoch — epoch-aligned chunks, one copy a chunk)")
        n_chunks = nb // K
        # each chunk's rows in staging order, and how many lead real rows
        rows, valid = [], []
        for c in range(n_chunks):
            r, m = idx[c * K : (c + 1) * K], bmask[c * K : (c + 1) * K]
            if mesh is None:
                rows.append(r.reshape(-1))
                valid.append(None)
                continue
            perm = stream_chunk_layout(mesh, r)[0]
            mperm = stream_chunk_layout(mesh, m)[0]
            pos = batch_local_positions(mesh, K * batch_size)
            local = perm if pos is None else perm[pos]
            rows.append(local)
            # padded rows sit at the end of an epoch's last batch, so at the
            # end of a rank's block
            valid.append(int((mperm if pos is None else mperm[pos]).sum()))
        per_rank = batch_size if mesh is None else batch_size // mesh.n_data
        idx_d = torch.as_tensor(idx, dtype=torch.long, device=device)
        bmask_d = torch.as_tensor(bmask, dtype=stage_dtype, device=device)
        stager = _Stager((K * per_rank,) + tuple(images.shape[1:]), copy_dtype, stage_dtype,
                         device)

        def put(c: int) -> int:
            return stager.put(images, rows[c], valid[c])

        def prefetch(c: int) -> None:
            pre(rows[c] if valid[c] is None else rows[c][: valid[c]])

        gather = shard_for_stage(state, mesh, shard_latents) if mesh is not None else None
        prefetch(0)
        slot = put(0)
        if n_chunks > 1:
            prefetch(1)
        epochs = []
        try:
            with kernel_mesh(mesh, npix, getattr(gather, "sharded", ())):
                for e in range(n_epochs):
                    ms = []
                    for c in range(n_chunks):
                        buf = stager.get(slot)
                        for k in range(K):
                            b = c * K + k
                            imgs = buf if K == 1 else chunk_gather(
                                buf, slice(k * per_rank, (k + 1) * per_rank))
                            state, m = step_fn(state, (imgs, idx_d[b], bmask_d[b]))
                            ms.append(m)
                        stager.release(slot)
                        if n_chunks > 1 and not (e == n_epochs - 1 and c == n_chunks - 1):
                            # the steps above are in flight on the card: start the
                            # decodes of the chunk after next, then stage the next
                            prefetch((c + 2) % n_chunks)
                            slot = put((c + 1) % n_chunks)
                    epochs.append({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]})
        finally:
            stager.close()
        if gather is not None:
            gather()
        metrics = {k: torch.stack([e[k] for e in epochs]).cpu().numpy() for k in epochs[0]}
        return state, metrics

    return run


def _stream_dtype(value) -> torch.dtype | None:
    """``fit_task(stream_dtype=)``: None or torch.float32 (no cast), or
    torch.bfloat16."""
    if value is None or value == torch.float32:
        return None
    if value == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"stream_dtype must be float32 or bfloat16, got {value!r}")


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
    precompile=False,
) -> tuple[Params, dict]:
    """Run a whole task with its multi-resolution curriculum (the JAX
    ``fit_task``).

    images_at(res) -> (S, H*W, 3) normalised images at that resolution, on
    the training device and in the training dtype (that of the latents);
    with ``stream`` a host source instead (``images_host_at`` or
    ``row_source_at``), which ``streaming_stage_runner`` copies to the
    latents' device a batch at a time (``stream_chunk`` batches a copy,
    ``stream_dtype`` bfloat16 to halve the bytes); with ``reaugment`` it is
    called as images_at(res, epoch) every epoch (the reference's per-item
    random augmentation). Directions, sineweights
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
    optimizer's step count keeps the LR schedule exact.

    ``precompile`` (True, or a ``train.precompile.Precompiler``) builds the
    native libraries the task's stages load in a background thread before
    the first stage (``precompile.task_builds``; the process's default
    precompiler for True): a build that finishes first saves the inline build at first
    use, a failed one is logged and the inline build raises as without it.
    The training itself is the same, bit for bit.

    With a ``mesh`` of more than one rank (``parallel.mesh.make_mesh``; every
    rank calls ``fit_task`` with the same arguments) the batch is padded to
    the data axis and each rank trains on its block
    (``parallel.mesh.sharded_stage_runner``, or the streaming runner's mesh
    half); ``shard_latents`` row-shards the latent tables over the data axis
    for each stage. The returned params are whole on every rank.
    ``RENI_TPU_CKPT_WALL_S`` is read on rank 0 and broadcast, and each
    adapted segment length is rank 0's, so that every rank makes the same
    segments (and the same collectives).

    Returns (params, metrics dict of (epochs run,) arrays under the
    reference's keys ``{task}_{name}``)."""
    stream_dtype = _stream_dtype(stream_dtype)
    if mesh is not None and mesh.size == 1:
        mesh = None  # one rank: the single-device runners
    if mesh is not None and not mesh.groups:
        raise ValueError(
            f"a mesh of {mesh.size} ranks without process groups is a layout: build it with "
            f"parallel.mesh.make_mesh in each of WORLD_SIZE={mesh.size} ranks")
    task_cfg.validate()
    if step_builder is None and task_cfg.task not in ("FIT_DECODER", "FIT_LATENT"):
        raise ValueError(
            f"task {task_cfg.task}: provide step_builder (FIT_INVERSE is built by "
            "reni_tpu_torch.render.inverse.fit_inverse)"
        )
    batch_size = task_cfg.batch_size
    if mesh is not None:
        batch_size = pad_batch_to(batch_size, mesh.n_data)
    stages = task_cfg.resolution_stages()
    first = images_at(tuple(stages[0][0]))
    n_images = first.shape[0]
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
    if precompile:
        from reni_tpu_torch.train import precompile as pc

        pool = precompile if isinstance(precompile, pc.Precompiler) else pc.default_pool()
        pool.launch(pc.task_builds(model.config, task_cfg.task, dev,
                                   from_disk=getattr(first, "prefetch", None) is not None))
    del first
    stage_runner = run_stage
    if stream:
        stage_runner = streaming_stage_runner(dev, chunk=stream_chunk, stream_dtype=stream_dtype,
                                              mesh=mesh, shard_latents=shard_latents)
    elif mesh is not None:
        stage_runner = sharded_stage_runner(mesh, shard_latents=shard_latents)

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

    # rank 0's value on every rank, before any branch on it (a rank that
    # read its own could segment differently and mispair the collectives)
    wall_target = float(multihost.agree_on_str(os.environ.get("RENI_TPU_CKPT_WALL_S", "0"))
                        or 0)
    all_metrics = []
    stop = False
    for res, n_epochs, epoch_offset in plan:
        if n_epochs <= 0:  # the stage was done before start_epoch
            continue
        step_fn = make_step(res)
        if reaugment:
            for done in range(1, n_epochs + 1):
                images = images_at(res, epoch_offset + done - 1)
                state, metrics = stage_runner(step_fn, state, images, 1, batch_size)
                all_metrics.append(metrics)
                if callback is not None and callback_every and (
                    done % callback_every == 0 or done == n_epochs
                ):
                    stop = bool(callback(state, epoch_offset + done, metrics, res))
                    if stop:
                        break
        elif callback is None or not callback_every:
            state, metrics = stage_runner(step_fn, state, images_at(res), n_epochs, batch_size)
            all_metrics.append(metrics)
        else:
            images = images_at(res)
            # with a wall target the first segment of a stage is one epoch
            # (its speed is unknown yet), then segments adapt to the target
            done, seg = 0, 1 if wall_target else min(callback_every, n_epochs)
            while done < n_epochs:
                seg = min(seg, n_epochs - done)
                t0 = time.monotonic()
                state, metrics = stage_runner(step_fn, state, images, seg, batch_size)
                done += seg
                all_metrics.append(metrics)
                stop = bool(callback(state, epoch_offset + done, metrics, res))
                if wall_target and done < n_epochs:
                    per_epoch = max((time.monotonic() - t0) / seg, 1e-9)
                    ideal = max(1, int(wall_target / per_epoch))
                    seg = min(callback_every, 1 << (ideal.bit_length() - 1))
                    seg = int(multihost.agree_on_str(str(seg)))
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
