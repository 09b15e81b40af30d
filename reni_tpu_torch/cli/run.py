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
- ``TRAINER.MAX_RUNTIME`` (hours), image grids, ``--profile``.

Left out, raised by name when a config or the environment asks for them:
more than one device, ``TPU.SHARD_LATENTS`` and multi-process runs
(ROADMAP Queue A-11); ``TPU.STREAM_*`` (A-9); the hang watchdog
(``RENI_TPU_HANG_EXIT_S``), the chip lock and its stop file
(``RENI_TPU_CHIP_LOCK``, ``RENI_TPU_STOP_FILE``) and ``RENI_TPU_RSS_EXIT_GB``
(A-13). ``TPU.PRECOMPILE``, a TPU compile knob, is ignored with a note.

Differences from the JAX trainer: ``TB.LOG_GRAPH`` writes
``{task}_graph.txt`` (the ``torch.export`` graph of the plain decoder
forward at one latent x width 32) where JAX writes StableHLO; a resumed
FIT_INVERSE continues at its checkpoint's epoch with its optimizer state
(JAX restarts it at epoch 0 from the checkpoint's latents); a relaunch that
resumes a task finds the task's kept checkpoints, so best-2 retention and
the chained best FIT_DECODER checkpoint are those of the uncut run; fault
events go to the run's own ``metrics.jsonl`` by path, not through a
module-level log; ``TRAINER.LOGGER_TYPE`` other than tensorboard or wandb
writes no TensorBoard file (JAX writes one whatever it says).
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
import time
import traceback
from datetime import datetime, timezone

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.data.datasets import get_dataset
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.params import from_numpy, map_tree
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.train import tasks
from reni_tpu_torch.train.logging_utils import MetricLogger
from reni_tpu_torch.train.optim import build_schedule
from reni_tpu_torch.train.visualize import example_images
from reni_tpu_torch.utils import profiling
from reni_tpu_torch.utils.config import experiment_name, get_cfg_defaults
from reni_tpu_torch.utils.device import resolve_device


def _log_event(log_dir: str, event: str, **fields) -> None:
    """Append a fault-history record (retries, relaunch adoptions) to the
    run's ``metrics.jsonl``, so that a chain's log says what it survived."""
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
    since the last save."""

    def __init__(self, save_dir: str, task: str, model_config, keep: int = 2):
        self.save_dir = save_dir
        self.task = task
        self.model_config = model_config
        self.keep = keep
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
            for ext in (".npz", ".json"):
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
    return deadline is not None and time.time() > deadline


def run_task(
    config,
    task: str,
    dataset,
    logger: MetricLogger,
    chkpt_path: str | None,
    device: torch.device,
    deadline: float | None = None,
    resume_path: str | None = None,
):
    """Train one task of the chain; returns (params, metrics, the path of
    the checkpoint a later task should load: the best kept one, else the
    final one)."""
    model_cfg = RENIConfig.from_reni_cfg(config.RENI, task, tpu_cfg=config.get("TPU"))
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

    if bool(config.TRAINER.LOGGER.TB.get("LOG_GRAPH", False)):
        _dump_model_graph(model, params, logger.log_dir, task)

    save_dir = os.path.join(logger.log_dir, config.TRAINER.CHKPTS.SAVE_DIR)
    tracker = _BestTracker(save_dir, task, model_cfg)
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

    # beyond every N epochs, a save at each curriculum stage's end and once
    # RENI_TPU_CKPT_WALL_S seconds passed since the last one (0/unset: off)
    wall_save_s = float(os.environ.get("RENI_TPU_CKPT_WALL_S", "0") or 0)
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
        loss = log_epoch(epoch, metrics_chunk)
        if save_on and (epoch % every == 0 or epoch in stage_ends or (
                wall_save_s > 0 and time.monotonic() - last_save_t[0] > wall_save_s)):
            save(state_now, epoch, loss)
        if _deadline_reached(deadline):
            # TRAINER.MAX_RUNTIME exceeded: stop after this segment
            return True
        if log_images and epoch % img_every == 0:
            grid = example_images(
                model, state_now.params, res,
                mode=config.TRAINER.LOGGER.IMAGES_TO_SHOW, n_images=n_images,
                generator=torch.Generator().manual_seed(img_seed),
                dataset_images=images_at(res), unnormalise=dataset.unnormalise,
                is_hdr=is_hdr,
            )
            logger.log_image(f"{task.lower()}_images", grid, epoch)
        return False

    fit_kw = dict(start_epoch=start_epoch, initial_opt_state=opt_loader)
    if task == "FIT_INVERSE":
        from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse

        def inverse_callback(state_now, epoch, metrics_chunk, res):
            # renders are logged at the task's end; scalars and resumable
            # checkpoints as in the other tasks
            loss = log_epoch(epoch, metrics_chunk)
            if save_on and epoch % every == 0:
                save(state_now, epoch, loss)
            return _deadline_reached(deadline)

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
        if log_images:
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
            model, params, task_cfg, images_at, g_fit,
            mask_path=task_cfg.mask_path if task_cfg.apply_mask else None,
            callback_every=cb_every, callback=callback, reaugment=reaugment, **fit_kw,
        )

    final = os.path.join(save_dir, f"{task.lower()}_final")
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


def _devices_asked(config, mesh: str | None, device: torch.device) -> int:
    """Devices a ``--mesh`` spec (DATAxPIXEL[xMODEL]) or TPU.MESH asks for;
    DATA -1 takes every device of the run's kind."""
    if mesh:
        return int(np.prod([int(x) for x in mesh.lower().split("x")]))
    nd, npix = int(config.TPU.MESH.DATA), int(config.TPU.MESH.PIXEL)
    nm = int(config.TPU.MESH.get("MODEL", 1))
    if nd == -1:
        nd = torch.cuda.device_count() if device.type == "cuda" else 1
    return nd * npix * nm


def _refuse_unported(config, mesh: str | None, device: torch.device) -> None:
    """Raise NotImplementedError, naming the ROADMAP queue item, for what a
    config or the environment asks of a later slice; note an ignored
    PRECOMPILE."""
    tpu = config.TPU
    asked = []
    if _devices_asked(config, mesh, device) > 1:
        asked.append(("more than one device (--mesh / TPU.MESH)", "A-11"))
    if bool(tpu.get("SHARD_LATENTS", False)):
        asked.append(("TPU.SHARD_LATENTS", "A-11"))
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        asked.append(("a multi-process run (WORLD_SIZE > 1)", "A-11"))
    for key, off in (("STREAM_DATA", False), ("STREAM_FROM_DISK", False),
                     ("STREAM_CHUNK", 1), ("STREAM_DTYPE", "float32")):
        if tpu.get(key, off) != off:
            asked.append((f"TPU.{key}", "A-9"))
    for var in ("RENI_TPU_HANG_EXIT_S", "RENI_TPU_RSS_EXIT_GB"):
        if float(os.environ.get(var, "0") or 0) > 0:
            asked.append((var, "A-13"))
    for var in ("RENI_TPU_CHIP_LOCK", "RENI_TPU_STOP_FILE"):
        if os.environ.get(var):
            asked.append((var, "A-13"))
    if asked:
        what, item = asked[0]
        raise NotImplementedError(
            f"{what} is not ported to reni_tpu_torch yet: ROADMAP Queue {item}")
    if bool(tpu.get("PRECOMPILE", False)):
        print("[reni_tpu_torch] TPU.PRECOMPILE ignored (a TPU compile knob; "
              "ROADMAP Queue A-13)", flush=True)


def _dump_model_graph(model: RENIModel, params, log_dir: str, task: str) -> None:
    """TB.LOG_GRAPH: the reference logs the model graph to TensorBoard
    (run.py:55); here ``{task}_graph.txt`` holds the ``torch.export`` graph
    of the plain decoder forward (``use_pallas`` off: PyTorch operations,
    no kernel) at one latent x width 32, its weights inputs."""
    plain = RENIModel(dataclasses.replace(model.config, use_pallas=False))
    decoder = map_tree(lambda t: t.detach(), params["decoder"])
    Z = model.latents(params, [0]).detach()
    D = sphere.get_directions(32, device=Z.device)

    class Decoder(torch.nn.Module):
        def forward(self, decoder, Z, D):
            return plain.apply({"decoder": decoder}, Z, D)

    ep = torch.export.export(Decoder(), (decoder, Z, D))
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


def main(config, resume=None, log_dir=None, profile_dir=None, device=None, mesh=None):
    """Run ``config.RENI.TASKS`` in order; returns ({task: (params, metrics)},
    log_dir). ``device`` defaults to the card (raises without one)."""
    device = resolve_device(device)
    _refuse_unported(config, mesh, device)
    _apply_precision(config)
    if log_dir is None:
        log_dir = _experiment_runs(config)[1]
    wandb_cfg = None
    if config.TRAINER.LOGGER_TYPE == "wandb":
        wandb_cfg = dict(config.TRAINER.LOGGER.WANDB)
        wandb_cfg["run_config"] = config.to_dict()
    # the resolved-config record, and the identity check that gates relaunch
    # adoption (_find_resumable_run); the first writer wins: retries re-enter
    # with a trimmed TASKS list that must not overwrite it
    fingerprint = os.path.join(log_dir, "config.json")
    if not os.path.exists(fingerprint):
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
    # not import); any other value keeps metrics.jsonl alone
    logger = MetricLogger(
        log_dir, use_tensorboard=config.TRAINER.LOGGER_TYPE in ("tensorboard", "wandb"),
        wandb_config=wandb_cfg)
    trace_stack = contextlib.ExitStack()
    chkpt_path = load_path
    results = {}
    try:
        if profile_dir:
            trace_stack.enter_context(profiling.trace(profile_dir))
        for i, task in enumerate(tasks_list):
            if _deadline_reached(deadline):
                break
            t0 = time.perf_counter()
            dcfg = config.DATASET[config.DATASET.NAME]
            split = "Train" if task == "FIT_DECODER" else "Test"
            split_path = os.path.join(dcfg.PATH, split)
            if not os.path.isdir(split_path):
                split_path = dcfg.PATH  # flat dataset layout
            dataset = get_dataset(config.DATASET.NAME, split_path, dcfg.TRANSFORMS, dcfg.IS_HDR)
            params, metrics, best = run_task(
                config, task, dataset, logger, chkpt_path, device, deadline=deadline,
                resume_path=resume if i == 0 else None,
            )
            results[task] = (params, metrics)
            if task == "FIT_DECODER":
                chkpt_path = best
            loss = metrics[f"{task.lower()}_loss"]
            print(f"[reni_tpu_torch] {task}: {len(loss)} epochs, last loss {loss[-1]:.6g}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        # also on the exception path: a profiler left running would fail
        # every --retries attempt and lose the crashed run's trace
        trace_stack.close()
        logger.close()
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
                     mesh=None):
    """Drive ``main`` with crash retries: after an exception, resume from the
    newest checkpoint in the same run dir (at most EVERY_N_EPOCHS epochs are
    repeated). With ``retries > 0`` and no ``resume``, a fresh process first
    adopts the newest incomplete run of the same config
    (``_find_resumable_run``), so an outer relaunch loop recovers a killed
    process like an in-process retry. Retries and adoptions are logged as
    events in the run's ``metrics.jsonl``."""
    log_dir = None
    if retries > 0 and resume is None:
        found, plan = _find_resumable_run(config)
        if found:
            log_dir = found
            tasks_list, resume, load_path = plan
            config = config.clone()
            config.RENI.TASKS = tasks_list
            config.TRAINER.CHKPTS.LOAD_PATH = load_path
            print(f"[relaunch] adopting {log_dir}: tasks={tasks_list} resume={resume} "
                  f"load_path={load_path}", flush=True)
            _log_event(log_dir, "relaunch_adopt", tasks=tasks_list, resume=resume)
    if log_dir is None:
        log_dir = _experiment_runs(config)[1]
    attempt = 0
    while True:
        try:
            return main(config, resume=resume, log_dir=log_dir, profile_dir=profile_dir,
                        device=device, mesh=mesh)
        except Exception:
            if attempt >= retries:
                raise
            attempt += 1
            traceback.print_exc()
            tasks_list, resume, load_path = _auto_resume_plan(config, log_dir)
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
                        help="device mesh as DATAxPIXEL[xMODEL]: one device only until "
                             "ROADMAP Queue A-11")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler Chrome trace of the run into this dir")
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
    run_with_retries(cfg, resume=args.resume, retries=args.retries, profile_dir=args.profile,
                     device=args.device, mesh=args.mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
