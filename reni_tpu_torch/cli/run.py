"""Config-driven multi-task trainer (counterpart of ``reni_tpu/cli/run.py``).

Usage:
    python -m reni_tpu_torch.cli.run --cfg_path cfg.json            # the card
    python -m reni_tpu_torch.cli.run --cfg_path cfg.yaml --device cpu
    python -m reni_tpu_torch.cli.run --cfg_path cfg.json --retries 2

A ``.json`` config needs no PyYAML (the card's machine has none). Behaviour
of the reference's run.py:29-138, as the JAX package has it:
- auto experiment naming from hyperparameters, ``version_N`` run dirs;
- the three generators (init, fit, images) from ``TRAINER.SEED``;
- task-order asserts: FIT_DECODER first unless a checkpoint is given;
- per-task checkpoints every EVERY_N_EPOCHS, at every curriculum stage's end
  and after ``RENI_TPU_CKPT_WALL_S`` seconds, keeping the best 2 by
  ``{task}_loss`` plus ``{task}_latest``, and ``{task}_final``;
- the best FIT_DECODER checkpoint chains into the later tasks;
- FIT_DECODER trains on ``Train/``, the other tasks on ``Test/``;
- ``--resume`` (params, optimizer state, generator state: bit for bit the
  uncut run) and ``--retries`` (in-process retries, and adoption of the
  newest incomplete run of the same config by a relaunched process);
- ``TRAINER.MAX_RUNTIME`` (hours), image grids;
- ``--profile DIR`` (``utils/profiling.py::trace``): a torch.profiler
  Chrome trace of the run, ``DIR/reni_tpu_torch.trace.json``, which turns
  the port's spans on (``task.*``, ``model.step``, ``render.*``,
  ``kernels.*``, ``mesh.reduce``: each layer's host range on the trace's
  timeline), and their host and device times, ``DIR/reni_tpu_torch.spans.json``;
- the streaming tiers: ``TPU.STREAM_DATA`` keeps the staged dataset in host
  memory and copies a batch a step (``train/tasks.py::
  streaming_stage_runner``), ``TPU.STREAM_FROM_DISK`` keeps only the file
  list (``lazy=True``; rows decode from disk a batch at a time) and implies
  STREAM_DATA, ``TPU.STREAM_CHUNK`` copies K batches at a time and
  ``TPU.STREAM_DTYPE: bfloat16`` copies bf16; FIT_INVERSE ignores
  STREAM_DATA with a note, as in JAX;
- multi-process runs: one process a rank, started by torchrun or with its
  variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``; ``parallel/multihost.py``), on ``--mesh
  DATAxPIXEL[xMODEL]`` or ``TPU.MESH`` (DATA -1: ``WORLD_SIZE / (PIXEL x
  MODEL)``) and ``TPU.SHARD_LATENTS``: each rank on ``cuda:LOCAL_RANK``,
  rank 0 alone writing metrics, images and checkpoints, a barrier between
  tasks, the chained checkpoint's bytes sent to every rank, and rank 0's
  ``version_N``, MAX_RUNTIME verdict, ``RENI_TPU_CKPT_WALL_S`` and retry plan
  adopted by all. A MODEL axis shards the decoder tensor-parallel
  (``parallel/tp.py``) and turns ``TPU.USE_PALLAS`` off, with a line: the
  kernels take whole weights, as JAX's do;
- the fault machinery of ``utils/chiplock.py``: the chip lock, held across
  every retry (a lock not acquired forbids relaunch adoption), and the stop
  file, honoured at each segment (force-save, exit 115); the hang watchdog
  (``RENI_TPU_HANG_EXIT_S``: no progress for that long exits 114); the
  planned restart ``RENI_TPU_RSS_EXIT_GB`` (the largest RSS over the ranks
  above it: checkpoint, exit 114). An outer loop reruns the command with
  ``--retries``, which adopts the run (README);
- ``TPU.PRECOMPILE``: the native libraries of the chain's later tasks, and
  of each task's stages, build in background threads
  (``train/precompile.py``).

Differences from the JAX trainer: ``TB.LOG_GRAPH`` writes
``{task}_graph.txt`` (the ``torch.export`` graph of the plain decoder
forward at one latent x width 32) where JAX writes StableHLO; a resumed
FIT_INVERSE continues at its checkpoint's epoch with its optimizer state
(JAX restarts it at epoch 0 from the checkpoint's latents); a relaunch that
resumes a task finds the task's kept checkpoints, so best-2 retention and
the chained best FIT_DECODER checkpoint are those of the uncut run; fault
events go to the run's own ``metrics.jsonl`` by path, not through a
module-level log (the watchdog's thread reads the run dir main noted);
``TRAINER.LOGGER_TYPE`` other than tensorboard or wandb writes no
TensorBoard file (JAX writes one whatever it says); ``TPU.PRECOMPILE``
builds libraries where JAX compiles XLA programs, on a mesh and while
streaming too.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import sys
import threading
import time
import traceback
from datetime import datetime, timezone

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.data.datasets import get_dataset
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.parallel import multihost
from reni_tpu_torch.parallel.mesh import make_mesh
from reni_tpu_torch.params import from_numpy, map_tree
from reni_tpu_torch.serve import PlainDecoder
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.train import tasks
from reni_tpu_torch.train.logging_utils import MetricLogger
from reni_tpu_torch.train.optim import build_schedule
from reni_tpu_torch.train import precompile as pc
from reni_tpu_torch.train.visualize import example_images
from reni_tpu_torch.utils import chiplock, profiling, progress
from reni_tpu_torch.utils.config import experiment_name, get_cfg_defaults

# -- hang watchdog -----------------------------------------------------------
#
# A rank stuck in a collective whose peer died, or a launch that never
# returns, raises nothing that --retries could catch. The recovery is at the
# process level: a daemon thread watches the trainer's progress notes
# (utils/progress.py: task set-up, each segment, the lock wait, every native
# build) and, when RENI_TPU_HANG_EXIT_S seconds pass without one, logs a
# hang_exit event and exits 114; an outer loop reruns the command, which
# resumes from the newest checkpoint as after a crash. Off unless set.

_note_progress = progress.note
_WATCH = {"log_dir": None}  # the run dir main() noted, for the watchdog's event


def _arm_hang_watchdog() -> None:
    hang_s = float(os.environ.get("RENI_TPU_HANG_EXIT_S", "0") or 0)
    if hang_s <= 0:
        return
    _note_progress("startup")

    def watch():
        while True:
            time.sleep(min(hang_s / 4, 60.0))
            idle = progress.idle_s()
            if idle > hang_s:
                what = progress.PROGRESS["what"]
                if _WATCH["log_dir"]:
                    _log_event(_WATCH["log_dir"], "hang_exit", idle_s=round(idle), last=what)
                print(f"[reni_tpu_torch] HANG: no trainer progress for {idle:.0f} s "
                      f"(> RENI_TPU_HANG_EXIT_S={hang_s:.0f}); last progress: {what!r}. "
                      "Exiting 114; rerun with --retries (or let a supervisor rerun) to "
                      "continue from the newest checkpoint.", file=sys.stderr, flush=True)
                os._exit(114)

    threading.Thread(target=watch, daemon=True, name="hang-watchdog").start()


def _rss_gb() -> float:
    """This process's resident memory in GB (0 where /proc is missing)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except OSError:
        return 0.0


def _log_event(log_dir: str, event: str, **fields) -> None:
    """Append a fault-history record (retries, relaunch adoptions) to the
    run's ``metrics.jsonl`` (rank 0's), so that a chain's log says what it
    survived."""
    if not multihost.is_primary():
        return
    rec = {"event": event,
           "time": datetime.now(timezone.utc).isoformat(timespec="seconds")}
    rec.update(fields)
    try:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass  # fault logging must never take the trainer down


def _kept(ckdir: str, task: str) -> list[tuple[int, float, str]]:
    """(epoch, loss, path) of the ``{task}_epoch=N`` checkpoints in
    ``ckdir``, by epoch."""
    pat = re.compile(rf"{re.escape(task.lower())}_epoch=(\d+)\.json$")
    out = []
    for name in sorted(os.listdir(ckdir)) if os.path.isdir(ckdir) else []:
        if pat.match(name):
            path = os.path.join(ckdir, name[: -len(".json")])
            out.append((int(pat.match(name).group(1)), float(ckpt._meta_only(path)[1]["loss"]),
                        path))
    return out


def _copy_into(src: str, dst: str) -> None:
    tmp = f"{dst}.tmp{os.getpid()}"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class _BestTracker:
    """save_top_k=2 checkpointing by monitored loss (reference run.py:79-84),
    plus a ``{task}_latest`` checkpoint overwritten at every save (the
    analog of Lightning's ``last.ckpt``): a crash loses at most the epochs
    since the last save. ``write=False`` (ranks other than 0) keeps the
    bookkeeping, which the all-reduced losses make the same on every rank,
    and joins the collective fetch, but writes no file."""

    def __init__(self, save_dir: str, task: str, model_config, keep: int = 2,
                 write: bool = True):
        self.save_dir = save_dir
        self.task = task
        self.model_config = model_config
        self.keep = keep
        self.write = write
        self.saved: list[tuple[float, str]] = []

    def _path(self, epoch: int) -> str:
        return os.path.join(self.save_dir, f"{self.task.lower()}_epoch={epoch:04d}")

    def adopt(self, upto_epoch: int) -> None:
        """Take over the kept checkpoints of a run this one resumes (epochs
        up to ``upto_epoch``), as the uncut run's tracker holds them."""
        self.saved = [(loss, path) for epoch, loss, path in _kept(self.save_dir, self.task)
                      if epoch <= upto_epoch]
        self.saved.sort(key=lambda t: t[0])

    def maybe_save(self, params, epoch: int, loss: float, opt_state=None, generator=None):
        path = self._path(epoch)
        params = ckpt.fetch_tree(params)  # collective: every rank fetches
        if self.write:
            ckpt.save_checkpoint(
                path,
                params,
                model_config=self.model_config,
                metadata={"task": self.task, "epoch": epoch, "loss": float(loss)},
                opt_state=opt_state,
                generator=generator,
            )
            latest = os.path.join(self.save_dir, f"{self.task.lower()}_latest")
            _copy_into(path + ".npz", latest + ".npz")
            _copy_into(path + ".json", latest + ".json")
        self.saved.append((float(loss), path))
        self.saved.sort(key=lambda t: t[0])
        while len(self.saved) > self.keep:
            _, worst = self.saved.pop()
            for ext in (".npz", ".json") if self.write else ():
                try:
                    os.remove(worst + ext)
                except OSError:
                    pass

    @property
    def best_path(self) -> str | None:
        return self.saved[0][1] if self.saved else None


def _generators(seed: int) -> tuple[torch.Generator, torch.Generator, int]:
    """The run's generators for initialisation and fitting, and the seed of
    the image grids' generator (re-seeded for every grid, so that a resumed
    run shows the same images), all from ``TRAINER.SEED``."""
    init_seed, fit_seed, img_seed = np.random.SeedSequence(seed).generate_state(3)
    return (torch.Generator().manual_seed(int(init_seed)),
            torch.Generator().manual_seed(int(fit_seed)), int(img_seed))


def _deadline_reached(deadline: float | None) -> bool:
    """Rank 0's verdict on every rank (collective in a multi-process run):
    a rank that stopped alone would leave the others in a collective."""
    return multihost.agree_on_flag(deadline is not None and time.time() > deadline)


def _segment_checks(deadline: float | None, stop_file: str | None,
                    rss: bool = False) -> tuple[bool, float, bool]:
    """The checks at a segment's end in one collective (an all-reduce MAX):
    rank 0's TRAINER.MAX_RUNTIME verdict, the largest RSS over the ranks in
    GB (0 unless ``rss``) and rank 0's chip-preemption verdict
    (``utils/chiplock.py``). Every rank adopts rank 0's verdicts (the other
    ranks send 0): a rank that stopped alone would leave the others in a
    collective. Called at the same points on every rank whatever its own
    RENI_TPU_STOP_FILE says, so the all-reduces stay paired."""
    primary = multihost.is_primary()
    late, largest, stop = multihost.max_over_ranks([
        primary and deadline is not None and time.time() > deadline,
        _rss_gb() if rss else 0.0,
        primary and chiplock.yield_requested(stop_file)])
    return late > 0, largest, stop > 0


class _NoLogger:
    """The logger of ranks other than 0: the run directory, no files."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def log_scalars(self, step: int, scalars: dict) -> None:
        pass

    def log_image(self, tag: str, image_hwc, step: int) -> None:
        pass

    def close(self) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class StreamSettings:
    """The ``TPU.STREAM_*`` keys, validated (``stream_settings``)."""

    stream: bool = False  # STREAM_DATA, or implied by STREAM_FROM_DISK
    from_disk: bool = False  # STREAM_FROM_DISK
    chunk: int = 1  # STREAM_CHUNK
    dtype: torch.dtype | None = None  # STREAM_DTYPE: None (float32) or bfloat16


def stream_settings(config) -> StreamSettings:
    """Read and validate ``TPU.STREAM_*`` as the JAX trainer does (its
    messages): STREAM_FROM_DISK implies STREAM_DATA; STREAM_CHUNK >= 1;
    STREAM_DTYPE float32 or bfloat16."""
    tpu = config.TPU
    from_disk = bool(tpu.get("STREAM_FROM_DISK", False))
    stream = bool(tpu.get("STREAM_DATA", False)) or from_disk
    chunk = int(tpu.get("STREAM_CHUNK", 1))
    if chunk < 1:
        raise SystemExit(f"TPU.STREAM_CHUNK must be >= 1, got {chunk}")
    sd = str(tpu.get("STREAM_DTYPE", "float32")).lower()
    if sd not in ("float32", "bfloat16"):
        raise SystemExit(f"TPU.STREAM_DTYPE must be float32 or bfloat16, got {sd!r}")
    return StreamSettings(stream, from_disk, chunk, torch.bfloat16 if sd == "bfloat16" else None)


def run_task(
    config,
    task: str,
    dataset,
    logger: MetricLogger,
    chkpt_path: str | None,
    device: torch.device,
    deadline: float | None = None,
    resume_path: str | None = None,
    mesh=None,
    precompile=False,
):
    """Train one task of the chain; returns (params, metrics, the path of
    the checkpoint a later task should load: the best kept one, else the
    final one). With a ``mesh`` every rank calls it; rank 0 alone writes.
    ``precompile``: a ``train.precompile.Precompiler`` building the task's
    libraries in the background (``TPU.PRECOMPILE``), or False."""
    _note_progress(f"{task} setup")
    primary = multihost.is_primary()
    st = stream_settings(config)
    if st.dtype is not None and not st.stream:
        print("[reni_tpu_torch] TPU.STREAM_DTYPE ignored without TPU.STREAM_DATA", flush=True)
    if st.chunk > 1 and not st.stream:
        print("[reni_tpu_torch] TPU.STREAM_CHUNK ignored without TPU.STREAM_DATA", flush=True)
    model_cfg = _model_config(config, task, mesh)
    if mesh is not None and mesh.n_model > 1 and bool(config.TPU.USE_PALLAS) and primary:
        print(f"[reni_tpu_torch] {task}: TPU.USE_PALLAS off on the model axis "
              f"(model={mesh.n_model}): the kernels take whole weights; the tensor-parallel "
              "plain decoder (parallel/tp.py) trains", flush=True)
    model = RENIModel(model_cfg)
    g_init, g_fit, img_seed = _generators(int(config.TRAINER.SEED))

    start_epoch, opt_loader = 0, None
    if resume_path is not None:
        # mid-task resume: full params + optimizer state + generator state
        saved, meta = ckpt.load_checkpoint(resume_path)
        params = from_numpy(saved, device)
        start_epoch = int(meta.get("epoch", 0))
        opt_loader = functools.partial(ckpt.load_train_state, resume_path)
    elif chkpt_path is not None:
        params = ckpt.load_decoder_only(chkpt_path, model, len(dataset), g_init, device)
    else:
        params = model.init(g_init, len(dataset), device=device)

    task_cfg = tasks.TaskConfig.from_config(config, task)
    # the LR logged per epoch (reference run.py:86 LearningRateMonitor): the
    # schedule decays per epoch and counts from 0, so the 1-based epoch e
    # trained at schedule(e - 1)
    lr_schedule = build_schedule(
        dataclasses.replace(task_cfg.optim, epochs=task_cfg.epochs, steps_per_epoch=1)
    )

    if primary and bool(config.TRAINER.LOGGER.TB.get("LOG_GRAPH", False)):
        _dump_model_graph(model, params, logger.log_dir, task)

    save_dir = os.path.join(logger.log_dir, config.TRAINER.CHKPTS.SAVE_DIR)
    tracker = _BestTracker(save_dir, task, model_cfg, write=primary)
    shard_latents = mesh is not None and bool(config.TPU.get("SHARD_LATENTS", False))
    if resume_path is not None:
        tracker.adopt(start_epoch)
    every = int(config.TRAINER.CHKPTS.EVERY_N_EPOCHS)
    save_on = bool(config.TRAINER.CHKPTS.SAVE)
    log_images = bool(config.TRAINER.LOGGER.LOG_IMAGES)
    img_every = int(config.TRAINER.LOGGER.EPOCHS_BETWEEN_EXAMPLES)
    n_images = int(config.TRAINER.LOGGER.NUMBER_OF_IMAGES)
    cb_every = min(every, img_every) if log_images else every
    is_hdr = bool(config.DATASET[config.DATASET.NAME].IS_HDR)
    images_at = functools.partial(dataset.images_at, device=device)
    # what fit_task and the grids read: the staged dataset on the device,
    # in host memory (STREAM_DATA), or rows decoded from disk
    # (STREAM_FROM_DISK; a grid decodes its handful of files)
    if st.from_disk:
        stage_images_at = lambda res, epoch=None: dataset.row_source_at(res)  # noqa: E731
    elif st.stream:
        stage_images_at = dataset.images_host_at
    else:
        stage_images_at = images_at

    # chip preemption, honoured at segment boundaries (force-save, exit 115,
    # a supervisor loop resumes once the preemptor releases the chip lock)
    stop_file = chiplock.trainer_stop_path(device)
    # RENI_TPU_RSS_EXIT_GB: a planned restart once the largest RSS over the
    # ranks passes the bound (checkpoint, exit 114, the relaunch resumes
    # with fresh processes); 0/unset = off. Rank 0's bound for every rank
    rss_exit_gb = float(multihost.agree_on_str(os.environ.get("RENI_TPU_RSS_EXIT_GB", "0"))
                        or 0)

    # beyond every N epochs, a save at each curriculum stage's end and once
    # RENI_TPU_CKPT_WALL_S seconds passed since the last one (0/unset: off);
    # rank 0's value and rank 0's clock decide for every rank
    wall_save_s = float(multihost.agree_on_str(os.environ.get("RENI_TPU_CKPT_WALL_S", "0"))
                        or 0)
    last_save_t = [time.monotonic()]
    stage_ends, off = set(), 0
    for _, n in task_cfg.resolution_stages():
        off += n
        stage_ends.add(off)

    def log_epoch(epoch, metrics_chunk) -> float:
        logged = {f"{task.lower()}_{k}": float(np.asarray(v)[-1])
                  for k, v in metrics_chunk.items()}
        logged[f"{task.lower()}_lr"] = float(lr_schedule(epoch - 1))
        logger.log_scalars(epoch, logged)
        return logged[f"{task.lower()}_loss"]

    def save(state_now, epoch, loss):
        tracker.maybe_save(state_now.params, epoch, loss,
                           opt_state=ckpt.opt_state_arrays(state_now.optimizer),
                           generator=state_now.generator)
        last_save_t[0] = time.monotonic()

    def callback(state_now, epoch, metrics_chunk, res):
        _note_progress(f"{task} epoch {epoch} @ {res}")
        loss = log_epoch(epoch, metrics_chunk)
        saved = save_on and multihost.agree_on_flag(epoch % every == 0 or epoch in stage_ends or (
            wall_save_s > 0 and time.monotonic() - last_save_t[0] > wall_save_s))
        if saved:
            save(state_now, epoch, loss)
        late, rss, stop = _segment_checks(deadline, stop_file, rss=rss_exit_gb > 0)
        if late:
            # TRAINER.MAX_RUNTIME exceeded: stop after this segment
            return True
        if rss > rss_exit_gb > 0:
            if save_on and not saved:
                save(state_now, epoch, loss)
            _log_event(logger.log_dir, "rss_exit", rss_gb=round(rss, 1), epoch=epoch)
            if primary:
                print(f"[reni_tpu_torch] RSS {rss:.1f} GB (the largest over the ranks above "
                      f"RENI_TPU_RSS_EXIT_GB={rss_exit_gb:g}): checkpointed, exiting 114 for a "
                      "fresh-process resume", flush=True)
            os._exit(114)
        if stop:
            if save_on and not saved:
                save(state_now, epoch, loss)  # off-schedule: the yield loses no epoch
            _log_event(logger.log_dir, "chip_yield", task=task, epoch=epoch)
            chiplock.honor_yield(stop_file, primary=primary, what=f"{task} trainer")
        if primary and log_images and epoch % img_every == 0:
            grid = example_images(
                model, state_now.params, res,
                mode=config.TRAINER.LOGGER.IMAGES_TO_SHOW, n_images=n_images,
                generator=torch.Generator().manual_seed(img_seed),
                dataset_images=stage_images_at(res), unnormalise=dataset.unnormalise,
                is_hdr=is_hdr,
            )
            logger.log_image(f"{task.lower()}_images", grid, epoch)
        return False

    fit_kw = dict(start_epoch=start_epoch, initial_opt_state=opt_loader, mesh=mesh,
                  shard_latents=shard_latents, precompile=precompile)
    if task == "FIT_INVERSE":
        from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse

        if st.stream:
            # inverse fits run on small test splits; their memory is the
            # render targets, not the maps: streaming buys nothing
            print("[reni_tpu_torch] TPU.STREAM_DATA ignored for FIT_INVERSE", flush=True)

        def inverse_callback(state_now, epoch, metrics_chunk, res):
            # renders are logged at the task's end; scalars and resumable
            # checkpoints as in the other tasks
            _note_progress(f"{task} epoch {epoch}")
            loss = log_epoch(epoch, metrics_chunk)
            if save_on and epoch % every == 0:
                save(state_now, epoch, loss)
            late, _, stop = _segment_checks(deadline, stop_file)
            if late:
                return True
            if stop:
                if save_on and epoch % every != 0:
                    save(state_now, epoch, loss)
                _log_event(logger.log_dir, "chip_yield", task=task, epoch=epoch)
                chiplock.honor_yield(stop_file, primary=primary, what=f"{task} trainer")
            return False

        inv_setup = InverseRenderSetup(
            task_cfg.object_path,
            render_resolution=task_cfg.render_resolution,
            kd=task_cfg.kd_value,
            azimuths=task_cfg.azimuths,
            elevations=task_cfg.elevations,
            device=device,
        )
        params, metrics = fit_inverse(
            model, params, task_cfg, images_at, dataset.unnormalise, g_fit,
            setup=inv_setup, callback_every=every, callback=inverse_callback, **fit_kw,
        )
        if primary and log_images:
            # the ground-truth renders above the recovered ones
            res = task_cfg.resolution_stages()[-1][0]
            gt = inv_setup.generate_gt_renders(images_at(res), dataset.unnormalise, res[1])
            grid = example_images(
                model, params, res, mode="random", n_images=n_images,
                generator=torch.Generator().manual_seed(img_seed),
                dataset_images=images_at(res), unnormalise=dataset.unnormalise,
                is_hdr=is_hdr, render_fn=inv_setup.render_fn(res[1]), gt_renders=gt,
            )
            logger.log_image(f"{task.lower()}_images", grid, task_cfg.epochs)
    else:
        dcfg = config.DATASET[config.DATASET.NAME]
        reaugment = bool(dcfg.get("REAUGMENT_PER_EPOCH", False)) and dataset.has_random_transforms
        params, metrics = tasks.fit_task(
            model, params, task_cfg, stage_images_at, g_fit,
            mask_path=task_cfg.mask_path if task_cfg.apply_mask else None,
            callback_every=cb_every, callback=callback, reaugment=reaugment,
            stream=st.stream, stream_chunk=st.chunk, stream_dtype=st.dtype, **fit_kw,
        )

    final = os.path.join(save_dir, f"{task.lower()}_final")
    if primary:
        ckpt.save_checkpoint(
            final, params, model_config=model_cfg,
            metadata={"task": task, "epoch": task_cfg.epochs,
                      "loss": float(metrics[f"{task.lower()}_loss"][-1])},
        )
    return params, metrics, tracker.best_path or final


def _apply_precision(config) -> None:
    """TPU.PRECISION / TRAINER.MIXED_PRECISION -> torch's float32 matmul
    precision. The default, bfloat16, is the kernels' own matmul input
    (``RENIConfig.pallas_trunk``) and leaves the float32 matmuls at
    "highest": the shading's light sums must not take TF32 (PERF.md section
    2). ``tensorfloat32`` selects "high" (TF32), ``float32`` "highest".
    TRAINER.MIXED_PRECISION (the reference's AMP flag) selects bfloat16."""
    precision = str(config.TPU.PRECISION).lower()
    if bool(config.TRAINER.MIXED_PRECISION):
        precision = "bfloat16"
    torch.set_float32_matmul_precision("high" if precision == "tensorfloat32" else "highest")


def _mesh_dims(config, mesh: str | None) -> tuple[int, int, int]:
    """(DATA, PIXEL, MODEL) of a ``--mesh`` spec (DATAxPIXEL[xMODEL]) or,
    without one, of TPU.MESH; DATA -1 stands for ``WORLD_SIZE / (PIXEL x
    MODEL)``."""
    if mesh:
        dims = [int(x) for x in mesh.lower().split("x")]
        return dims[0], dims[1] if len(dims) > 1 else 1, dims[2] if len(dims) > 2 else 1
    return (int(config.TPU.MESH.DATA), int(config.TPU.MESH.PIXEL),
            int(config.TPU.MESH.get("MODEL", 1)))


def _model_config(config, task: str, mesh=None) -> RENIConfig:
    """The task's model config; on a model axis without ``use_pallas``, as
    JAX's run_task makes it (the kernels take whole weights)."""
    cfg = RENIConfig.from_reni_cfg(config.RENI, task, tpu_cfg=config.get("TPU"))
    if mesh is not None and mesh.n_model > 1 and cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)
    return cfg


def _resolve_mesh(config, mesh: str | None, device: torch.device):
    """The run's mesh (``parallel.mesh.make_mesh``: ``--mesh`` or TPU.MESH,
    DATA -1 meaning ``WORLD_SIZE / (PIXEL x MODEL)``; a 1x1x1 mesh of
    several ranks puts them all on 'data', as JAX's ``global_mesh``), or
    None for one rank. A mesh of another size than ``WORLD_SIZE`` raises,
    naming both."""
    nd, npix, nm = _mesh_dims(config, mesh)
    if nd * npix * nm == 1:
        if multihost.process_count() == 1:
            return None
        nd = -1  # several ranks and no mesh asked for: every rank on 'data'
    m = make_mesh(n_data=nd, n_pixel=npix, n_model=nm, device=device)
    return m if m.size > 1 else None


def _dump_model_graph(model: RENIModel, params, log_dir: str, task: str) -> None:
    """TB.LOG_GRAPH: the reference logs the model graph to TensorBoard
    (run.py:55); here ``{task}_graph.txt`` holds the ``torch.export`` graph
    of the plain decoder forward (``use_pallas`` off: PyTorch operations,
    no kernel; the serving artifact's module, ``serve.PlainDecoder``) at one
    latent x width 32, its weights buffers."""
    decoder = map_tree(lambda t: t.detach(), params["decoder"])
    Z = model.latents(params, [0]).detach()
    D = sphere.get_directions(32, device=Z.device)
    with torch.no_grad():
        ep = torch.export.export(PlainDecoder(model.config, decoder), (Z, D))
    with open(os.path.join(log_dir, f"{task.lower()}_graph.txt"), "w") as f:
        f.write(str(ep))


def _experiment_runs(config) -> tuple[str | None, str]:
    """(newest existing version dir or None, next free version dir) of this
    config's experiment: the one ``version_N`` scan, shared by fresh-dir
    selection and relaunch adoption."""
    save_dir = config.TRAINER.LOGGER.TB.SAVE_DIR
    name = (
        experiment_name(config)
        if config.TRAINER.LOGGER.TB.NAME == "auto"
        else config.TRAINER.LOGGER.TB.NAME
    )
    version, last = 0, None
    while os.path.exists(os.path.join(save_dir, name, f"version_{version}")):
        last = os.path.join(save_dir, name, f"version_{version}")
        version += 1
    return last, os.path.join(save_dir, name, f"version_{version}")


def _config_fingerprint(config) -> str:
    return json.dumps(config.to_dict(), sort_keys=True, default=str)


def main(config, resume=None, log_dir=None, profile_dir=None, device=None, mesh=None,
         backend=None):
    """Run ``config.RENI.TASKS`` in order; returns ({task: (params, metrics)},
    log_dir). ``device`` defaults to the card (raises without one). Under
    torchrun's variables every rank runs ``main`` (``multihost.initialize``,
    with ``backend``: NCCL on the card and gloo on the CPU unless given) on
    the mesh ``mesh`` ("DxP[xM]", or TPU.MESH)."""
    multihost.initialize(backend=backend, device=device)
    device = multihost.rank_device(device)
    primary = multihost.is_primary()
    from_disk = stream_settings(config).from_disk  # validates TPU.STREAM_* before any work
    run_mesh = _resolve_mesh(config, mesh, device)
    _apply_precision(config)
    if log_dir is None:
        log_dir = multihost.agree_on_path(_experiment_runs(config)[1])
    _WATCH["log_dir"] = log_dir
    wandb_cfg = None
    if config.TRAINER.LOGGER_TYPE == "wandb":
        wandb_cfg = dict(config.TRAINER.LOGGER.WANDB)
        wandb_cfg["run_config"] = config.to_dict()
    # the resolved-config record, and the identity check that gates relaunch
    # adoption (_find_resumable_run); the first writer wins: retries re-enter
    # with a trimmed TASKS list that must not overwrite it
    fingerprint = os.path.join(log_dir, "config.json")
    if primary and not os.path.exists(fingerprint):
        os.makedirs(log_dir, exist_ok=True)
        with open(fingerprint, "w") as f:
            f.write(_config_fingerprint(config))

    tasks_list = list(config.RENI.TASKS)
    load_path = config.TRAINER.CHKPTS.LOAD_PATH
    if resume is not None:
        resume = ckpt.find_latest(resume)  # a directory resolves to its newest checkpoint
        _, rmeta = ckpt._meta_only(resume)
        rtask = rmeta.get("task")
        if not (tasks_list and tasks_list[0] == rtask):
            raise AssertionError(
                f"--resume checkpoint is for task {rtask!r}; put that task first "
                f"in RENI.TASKS (got {tasks_list})")
        if load_path is None:
            # the resume checkpoint carries full params, decoder included
            load_path = resume
    if len(tasks_list) > 1 and load_path is None and tasks_list[0] != "FIT_DECODER":
        raise AssertionError(
            "FIT_DECODER must run first unless TRAINER.CHKPTS.LOAD_PATH is set")
    if tasks_list and tasks_list[0] != "FIT_DECODER" and load_path is None:
        raise AssertionError(
            "non-FIT_DECODER first task requires TRAINER.CHKPTS.LOAD_PATH or --resume")

    deadline = None
    max_hours = float(config.TRAINER.MAX_RUNTIME or 0)
    if max_hours > 0:
        deadline = time.time() + max_hours * 3600.0

    # TRAINER.LOGGER_TYPE: tensorboard, or wandb (TensorBoard when wandb does
    # not import); any other value keeps metrics.jsonl alone. Rank 0 logs.
    if primary:
        logger = MetricLogger(
            log_dir, use_tensorboard=config.TRAINER.LOGGER_TYPE in ("tensorboard", "wandb"),
            wandb_config=wandb_cfg)
    else:
        logger = _NoLogger(log_dir)
    # TPU.PRECOMPILE: the libraries of the chain's later tasks build in the
    # background from the start (each task's own: fit_task)
    pool = pc.Precompiler() if bool(config.TPU.get("PRECOMPILE", False)) else False
    if pool and primary:
        print("[reni_tpu_torch] TPU.PRECOMPILE: later tasks' libraries build in background",
              flush=True)
    trace_stack = contextlib.ExitStack()
    chkpt_path = load_path
    results = {}
    try:
        if profile_dir:
            trace_stack.enter_context(profiling.trace(profile_dir))
        for i, task in enumerate(tasks_list):
            if _deadline_reached(deadline):
                break
            if pool:
                for later in tasks_list[i + 1:]:
                    pool.launch(pc.task_builds(_model_config(config, later, run_mesh),
                                               later, device, from_disk=from_disk))
            t0 = time.perf_counter()
            dcfg = config.DATASET[config.DATASET.NAME]
            split = "Train" if task == "FIT_DECODER" else "Test"
            split_path = os.path.join(dcfg.PATH, split)
            if not os.path.isdir(split_path):
                split_path = dcfg.PATH  # flat dataset layout
            # STREAM_FROM_DISK: only the file list in host memory; rows decode
            # on demand (prefetched) through the native EXR decoder
            dataset = get_dataset(config.DATASET.NAME, split_path, dcfg.TRANSFORMS, dcfg.IS_HDR,
                                  lazy=from_disk)
            try:
                params, metrics, best = run_task(
                    config, task, dataset, logger, chkpt_path, device, deadline=deadline,
                    resume_path=resume if i == 0 else None, mesh=run_mesh, precompile=pool,
                )
            finally:
                dataset.close()
            # no rank reads the chained checkpoint before rank 0 has written it
            multihost.barrier(f"task_end_{i}_{task}")
            results[task] = (params, metrics)
            if task == "FIT_DECODER":
                chkpt_path = multihost.agree_on_str(best)
                if i + 1 < len(tasks_list):
                    # ranks without rank 0's run directory get its bytes
                    multihost.ensure_checkpoint(chkpt_path)
            loss = metrics[f"{task.lower()}_loss"]
            if primary:
                print(f"[reni_tpu_torch] {task}: {len(loss)} epochs, last loss {loss[-1]:.6g}, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        # also on the exception path: a profiler left running would fail
        # every --retries attempt and lose the crashed run's trace
        trace_stack.close()
        logger.close()
    if pool and primary:
        rep = pool.report()
        print(f"[reni_tpu_torch] TPU.PRECOMPILE: built {rep['built']}, already built "
              f"{rep['present']}, failed {rep['failed']}", flush=True)
    return results, log_dir


def _auto_resume_plan(config, log_dir: str):
    """(tasks_list, resume, load_path) to continue a crashed run from its
    newest checkpoint: the crash-retry policy behind ``--retries``.

    A task whose newest checkpoint reached its EPOCHS (or is ``_final``) is
    complete: the chain restarts at the next task, whose decoder source is
    the task's best kept checkpoint for FIT_DECODER (the one the uncut chain
    would pass on), else that newest checkpoint. Otherwise the task itself
    resumes mid-way (params + optimizer state + generator state)."""
    ckdir = os.path.join(log_dir, config.TRAINER.CHKPTS.SAVE_DIR)
    try:
        latest = ckpt.find_latest(ckdir)
    except (FileNotFoundError, OSError):
        return list(config.RENI.TASKS), None, config.TRAINER.CHKPTS.LOAD_PATH
    _, meta = ckpt._meta_only(latest)
    rtask = meta.get("task")
    tasks_list = list(config.RENI.TASKS)
    task_epochs = int(config.RENI[rtask].EPOCHS) if rtask in config.RENI else 0
    complete = latest.endswith("_final") or (int(meta.get("epoch", 0)) >= task_epochs > 0)
    source = latest
    kept = _kept(ckdir, rtask) if complete and rtask == "FIT_DECODER" else []
    if kept:
        # the least loss, the earliest epoch on a tie: the tracker's best
        source = min(kept, key=lambda k: k[1])[2]
    if rtask not in tasks_list:
        # the newest checkpoint belongs to a task outside the (possibly
        # already trimmed) list: a complete one is the decoder source, a
        # partial one is not loaded at all
        return tasks_list, None, source if complete else config.TRAINER.CHKPTS.LOAD_PATH
    i = tasks_list.index(rtask)
    if complete:
        return tasks_list[i + 1 :], None, source
    return tasks_list[i:], latest, None


def _find_resumable_run(config):
    """(log_dir, plan) of the newest existing run of this experiment whose
    chain is incomplete, or (None, None) to start fresh: the relaunch half
    of crash recovery. A process that died (killed, out of memory) is rerun
    by an outer loop; with ``--retries > 0`` and no ``--resume`` the new
    process adopts the previous attempt's run dir and newest checkpoint.

    Adoption requires the same config: a run whose stored ``config.json``
    differs is never adopted (with an explicit ``TB.NAME`` the directory
    name encodes no hyperparameters)."""
    last, _ = _experiment_runs(config)
    if last is None:
        return None, None
    stored = os.path.join(last, "config.json")
    if os.path.exists(stored):
        with open(stored) as f:
            if f.read() != _config_fingerprint(config):
                print(f"[relaunch] {last} was trained with a different config: "
                      "starting fresh instead of adopting it", flush=True)
                return None, None
    plan = _auto_resume_plan(config, last)
    tasks_list, resume, load_path = plan
    if not tasks_list:
        return None, None  # the previous run completed the whole chain
    untouched = (list(tasks_list) == list(config.RENI.TASKS) and resume is None
                 and load_path == config.TRAINER.CHKPTS.LOAD_PATH)
    if untouched:
        return None, None  # no checkpoints there: nothing to adopt
    return last, plan


def run_with_retries(config, resume=None, retries: int = 0, profile_dir=None, device=None,
                     mesh=None, backend=None):
    """Drive ``main`` with crash retries: after an exception, resume from the
    newest checkpoint in the same run dir (at most EVERY_N_EPOCHS epochs are
    repeated). With ``retries > 0`` and no ``resume``, a fresh process first
    adopts the newest incomplete run of the same config
    (``_find_resumable_run``), so an outer relaunch loop recovers a killed
    process like an in-process retry. Retries and adoptions are logged as
    events in the run's ``metrics.jsonl``.

    In a multi-process run (``backend`` as for ``main``) rank 0 decides the
    adoption and the resume plan for every rank, whose files it sends them;
    a retry waits at most 300 s for every rank at its rendezvous and raises
    if one does not come (the failure was local: the run is split).

    The chip lock (``utils/chiplock.py``) is held across every retry: a
    preemptor the run yielded to blocks its relaunched successor until it
    is done. A lock that is engaged but not acquired (its wait timed out)
    forbids adoption: its holder may be training the very run."""
    multihost.initialize(backend=backend, device=device)
    lock_path = chiplock.trainer_lock_path(multihost.rank_device(device))
    with chiplock.hold_chip_lock(lock_path, what="cli.run", progress_cb=_note_progress) as got:
        return _run_with_retries_locked(
            config, resume=resume, retries=retries, profile_dir=profile_dir, device=device,
            mesh=mesh, backend=backend, allow_adopt=lock_path is None or got)


def _run_with_retries_locked(config, resume=None, retries: int = 0, profile_dir=None,
                             device=None, mesh=None, backend=None, allow_adopt: bool = True):
    log_dir = None
    if retries > 0 and resume is None and not allow_adopt:
        print("[relaunch] chip lock is held by another live job: not adopting its run "
              "directory; starting fresh", flush=True)
    if retries > 0 and resume is None and allow_adopt:
        found = _find_resumable_run(config) if multihost.is_primary() else (None, None)
        blob = multihost.agree_on_str(json.dumps(found) if found[0] else "")
        if blob:
            log_dir, (tasks_list, resume, load_path) = json.loads(blob)
            for path in (resume, load_path):
                if path:
                    multihost.ensure_checkpoint(path)
            config = config.clone()
            config.RENI.TASKS = tasks_list
            config.TRAINER.CHKPTS.LOAD_PATH = load_path
            print(f"[relaunch] adopting {log_dir}: tasks={tasks_list} resume={resume} "
                  f"load_path={load_path}", flush=True)
            _log_event(log_dir, "relaunch_adopt", tasks=tasks_list, resume=resume)
    if log_dir is None:
        log_dir = multihost.agree_on_path(_experiment_runs(config)[1])
    attempt = 0
    while True:
        try:
            return main(config, resume=resume, log_dir=log_dir, profile_dir=profile_dir,
                        device=device, mesh=mesh, backend=backend)
        except Exception:
            if attempt >= retries:
                raise
            attempt += 1
            traceback.print_exc()
            plan = _auto_resume_plan(config, log_dir)
            if multihost.process_count() > 1:
                if not multihost.barrier_timeout("retry_rendezvous", 300.0):
                    print("[retry] run split: not every rank reached the retry point within "
                          "300 s; aborting", flush=True)
                    raise
                plan = tuple(json.loads(multihost.agree_on_str(json.dumps(list(plan)))))
            tasks_list, resume, load_path = plan
            for path in (resume, load_path):
                if path:
                    multihost.ensure_checkpoint(path)
            if not tasks_list:
                raise  # everything already completed; surface the error
            config = config.clone()
            config.RENI.TASKS = tasks_list
            config.TRAINER.CHKPTS.LOAD_PATH = load_path
            print(f"[retry {attempt}/{retries}] resuming tasks={tasks_list} resume={resume} "
                  f"load_path={load_path}", flush=True)
            _log_event(log_dir, "retry", attempt=attempt, tasks=tasks_list, resume=resume)


def cli(argv=None) -> int:
    """Console entry point (``reni-tpu-torch`` / ``python -m
    reni_tpu_torch.cli.run``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", type=str, default="configs/experiment.yaml",
                        help="YAML or JSON config (JSON needs no PyYAML)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; cpu to run without one)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh as DATAxPIXEL[xMODEL], e.g. 4x2 or 2x1x2 (one rank "
                             "a device, WORLD_SIZE ranks; DATA -1: WORLD_SIZE / (PIXEL x "
                             "MODEL)); MODEL shards the decoder tensor-parallel")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the run and the port's "
                             "spans (reni_tpu_torch.spans.json) into this dir")
    parser.add_argument("--resume", type=str, default=None,
                        help="mid-task resume from a periodic checkpoint (params + optimizer "
                             "state + generator state + epoch) or a run directory (its newest "
                             "checkpoint); the checkpoint's task must be first in RENI.TASKS")
    parser.add_argument("--retries", type=int, default=0,
                        help="crash retries: on failure, resume from the run's newest "
                             "checkpoint; a relaunched process adopts the newest incomplete "
                             "run of the same config")
    args = parser.parse_args(argv)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.cfg_path)
    _arm_hang_watchdog()
    run_with_retries(cfg, resume=args.resume, retries=args.retries, profile_dir=args.profile,
                     device=args.device, mesh=args.mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
