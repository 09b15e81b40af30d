#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (reni_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one NVIDIA GPU

Phases (any failure exits non-zero and prints no result line):

1. build       - compile kernels/csrc/siren_fwd.cu, siren_bwd.cu,
                 siren_step.cu, film_step.cu and siren_anatomy.cu with nvcc
                 (sm_90a), all at once
2. compare     - at full width (N=49, 5x256 SIREN, 21 test latents x 32,768
                 directions, bf16 trunk, fast sine) each forward kernel
                 against its plain PyTorch version on the card: shared (1, P)
                 grid, per-image (B, P) grids, and the float32 trunk once;
                 then the shared grids of FIT_LATENT's three stages (21 x
                 512, 2,048 and 8,192 directions), the serving widths 128
                 and 130 (16,384 and 8,450 directions) and 100 training
                 latents x 8,192 (FIT_DECODER's batch and grid); both
                 the Cond-by-Concat and the FiLM Zoo decoder. The bf16
                 decodes take the fused kernel (csrc/fused_fwd.cuh), the
                 float32 ones the row-tile kernel (csrc/siren_fwd.cuh): the
                 route counters must say so. At the serving shape the fused
                 kernel gives the same bits twice, on persistent grids of 7,
                 64 and 131 CTAs and in lock step. Then the row-tile
                 kernel's smaller row tiles: a random 2-layer trunk of width
                 512 (float32) and 1,024 (bf16) against its plain version,
                 and a digest of the serving-shape outputs (the fused
                 kernel's bits)
3. compare_bwd - the same for each backward kernel, every gradient, with
                 and without the weight gradients: shared and per-image
                 grids, and the float32 trunk once (the chain kernel); then
                 FIT_LATENT's three stage grids with and without weight
                 gradients, and at 21 x 2,048 the Zoo trunk deepened to 8
                 products; bars max |kernel - plain| <= 1e-2 (bf16) / 1e-4
                 (float32) x max |plain|, two calls bitwise equal. The bf16
                 trunk runs as the layer-major passes (csrc/step_passes.cuh
                 with the cotangent last pass). Then each pass kernel of the
                 backward against its plain pass at 21 x 8,192, with and
                 without weight gradients; and the differentiable trunk's
                 route at FIT_LATENT's stages: the forward as the passes
                 against the plain forward, the backward from their scratch
                 against the plain backward. The kernels line reports the
                 largest absolute difference (max_abs_err) and the largest
                 difference over max |plain| (max_rel_err, what the bar holds)
4. serve       - the serving path (reni_tpu_torch.cli.serve.make_server) on
                 127.0.0.1 with a 20 ms batching window: /healthz,
                 /decode_idx for all 21 latents at widths 128, 130 and 256
                 (130 gives 8,450 pixels, not a multiple of 8: the kernel
                 masks its tail tile and still serves it),
                 /decode with rotation_y=90 checked against a column roll of
                 the unrotated decode, concurrent requests that the
                 micro-batcher coalesces; served arrays checked against a
                 direct load_decoder call. Launch counts are zeroed just
                 before and read just after: both kernels must have launched,
                 every decode through the fused kernel (its route counter),
                 none through the row-tile kernel
5. fit_latent  - train.tasks.fit_task FIT_LATENT on each Zoo decoder at the
                 published hyperparameters (21 maps in one batch, Adam b1=0
                 b2=0.9, LR 1e-2 -> 1e-4, curriculum 16x32 -> 32x64 ->
                 64x128) with the epochs cut from 2,400 to 300 (curriculum
                 100, 200), from fresh latents (load_decoder_only, mu = 0)
                 to the port's own decode of the entry's 21 test latents;
                 once more masked with data/Masks/Mask-3.png (cbc). Per
                 stage: median ms per step (CUDA events around whole steps),
                 first and last epoch loss. The forward and backward kernels
                 must launch once per step; the fitted maps' PSNR must be
                 within 0.1 dB of the same task run through the plain
                 forward and backward on the card
6. seed_maps   - the maps the Zoo was trained on (data/Zoo/README.md
                 "Recipe": 1,000 train + 21 test synthetic skies, seed 1,
                 width 128, ZIP half EXRs), written by the port's
                 data/synthetic.py into a temporary directory and loaded
                 with the port's data/datasets.get_dataset("RENI_HDR", ...)
                 and the published transform (minmaxnormalise, [-18.0536,
                 11.4633]); the training split staged on the card at
                 FIT_DECODER's three resolutions. Prints the host stage in
                 ms a map (generate and write, decode, stage) and a digest
                 of the staged maps (not asserted: numpy's SIMD sin and exp
                 may differ between CPUs); the maps stay on disk for the
                 evaluate phase
   fit_inverse - render.inverse.fit_inverse on each Zoo decoder at the
                 published RENI.FIT_INVERSE (data/3D_Models/teapot.obj, a
                 64x64 render, KD_VALUE 1.0, one view, batch 1, 64x128 maps =
                 8,192 lights, Adam b1=0 b2=0.999, LR 1e-2 -> 1e-5) with the
                 epochs cut from 1,200 to 40 (840 steps), from fresh latents
                 to the 21 seed-1 test maps, through the kernels and through
                 the plain decoder from the same generators. First the
                 backward at one latent x 8,192 against its plain version
                 and the device-memory guard's plan there (one group), and
                 the TF32 guard: a GT render at kd 0.5 in float32 against
                 float64, sum |diff| / sum |f64| <= 1e-4 (the largest pixel
                 error printed). Checks: the native rasterizer built the
                 fragments; the last epoch's loss below the first; every
                 step one forward as the fwd passes and one cotangent
                 backward from their scratch (two calls into the pass
                 entry), no forward kernel, no chain kernel; step 0's four
                 metrics within 1e-2 relative and the recovered renders'
                 PSNR against the GT renders within 0.1 dB between the runs;
                 inverse_recovery_eval printed for both. Median ms a step
                 (CUDA events), the render's and the decoder's forward +
                 backward alone at a step's shape, and a torch.profiler
                 split of five steps' device time (the decoder's kernels,
                 PyTorch's, idle)
   evaluate    - cli/evaluate.main on five HDR Zoo entries' latents_test
                 and the seed-1 test maps at 64x128 (Mask-3 in-painting on
                 the cbc entry), through the kernels and through the plain
                 decoder on the card: psnr_mean, rotated PSNR within 0.05
                 dB and ssim_mean within 1e-3 between the runs, printed
                 beside eval.json (a TPU's numbers), self_consistency_psnr
                 >= 50 dB; every decode through the fused forward. The LDR
                 entry is left out: its maps need the --ldr PNG generation
                 (ROADMAP A-6b)
   cli_run     - the trainer, python -m reni_tpu_torch.cli.run, on
                 configs/zoo_synthetic.yaml (written here as JSON: the card
                 has no PyYAML) with the chain FIT_DECODER -> FIT_LATENT ->
                 FIT_INVERSE (FIT_INVERSE as in the fit_inverse phase) on the
                 seed-1 maps, cut to 30 / 60 / 10 epochs (curricula (10, 20)
                 and (20, 40)), checkpoints every 5 epochs, 10 image grids
                 every 10. Run A: the chain in this process through
                 cli.run.cli, the step kernel once per FIT_DECODER step, the
                 backward and the forward passes once per FIT_LATENT and
                 FIT_INVERSE step, the fused forward once per grid; best-2 +
                 _latest + _final checkpoints per task. Run B: the same
                 command with --retries 1 as a child process, SIGKILLed when
                 fit_decoder_latest.json reports an epoch off the stage ends,
                 then run again: it must adopt run B's version_1 ("[relaunch]
                 adopting", a relaunch_adopt event), its FIT_DECODER and
                 FIT_LATENT final checkpoints must be run A's bit for bit
                 (FIT_INVERSE's too, else within 1e-6 relative, printed), and
                 its rows after the relaunch run A's rows of the same epochs
   compare_step - the train-step kernel against its plain version at full
                 width on the Cond-by-Concat Zoo decoder and 100 of its
                 training latents: the loss partials and every gradient at
                 100 x 8,192 (the flagship FIT_DECODER batch), 100 x 512 and
                 100 x 2,048 with a shared grid, then at 100 x 2,048 with
                 per-image grids, with a masked row, with the float32 trunk,
                 and with exp and no output activation; bars loss 1e-4
                 (bf16) / 1e-6 (float32) relative, gradients as in phase 3;
                 two calls on the same inputs must give the same bits. The
                 bf16 step runs as layer-major passes (csrc/step_passes.cuh)
                 and the float32 case through the chain kernel; then each
                 pass kernel against its plain pass at 100 x 8,192, fed the
                 plain chain's scratch, every output it writes within 1e-2 x
                 max |plain|
7. fit_decoder - train.tasks.fit_task FIT_DECODER at the published
                 hyperparameters (batch 100, Adam b1=0 b2=0.9, LR 1e-5 ->
                 1e-7, KLD weighting 1e-4, curriculum 16x32 -> 32x64 ->
                 64x128) with the epochs cut from 2,400 to 30 (curriculum
                 10, 20) on a fresh model.init student (VAD, Cond-by-Concat,
                 SO2, N=49, 5x256, tanh, bf16 trunk, fast sine) on the
                 1,000 seed-1 training maps (fit_task takes the dataset's
                 images_at). Once through the step kernel and once through its
                 plain version from the same generators. The step kernel
                 must launch once per step and the forward and backward
                 kernels not at all; each stage's last epoch loss must be
                 below its first; PSNR of the student's 64x128 decodes
                 within 0.1 dB between the runs; the result round-trips
                 through save_checkpoint / load_checkpoint. The kernel run's
                 64x128 steps after two of warm-up run with
                 torch.cuda.set_sync_debug_mode on: every synchronising call
                 is printed with where it came from, and one from the latent
                 noise draw (RENIModel.sample_latent) fails the phase
8. compare_film_step, fit_decoder_film - phases 6 and 7 for FiLM: the FiLM
                 step kernel against its plain version on the FiLM Zoo
                 decoder and 100 of its training latents (the same eight
                 cases and bars, dfreqs and dphases among the gradients),
                 then FIT_DECODER of a fresh model.init FiLM student (VAD,
                 FiLM, SO2, N=49, 5x256 trunk, mapping network 3x256, tanh,
                 bf16 trunk, fast sine) on the same 1,000 seed-1 maps,
                 with the same cut and the same
                 checks: the FiLM step kernel once per step, no forward or
                 backward kernel during training
9. guard       - the passes' device scratch under a forced budget: the
                 step of each conditioning at 100 x 8,192 and the backward
                 at 21 x 32,768 (with and without weight gradients) in
                 groups of images, every result but dWs bitwise equal to one
                 call, dWs within 1e-2 x max |one call|; then one
                 FIT_DECODER step of the Cond-by-Concat student at batch
                 1,000 x 8,192 (the 1,000 training maps) under the card's own
                 budget: a finite loss, its groups and peak memory printed
10. anatomy    - the probes of kernels/anatomy.py at 21 x 8,192 on the
                 Cond-by-Concat decoder: each forward and backward variant
                 and the weight-gradient product alone against its plain
                 version (the interleaved forwards equal bit for bit to the
                 kernel they rearrange, the fused kernel in lock step or the
                 row-tile kernel, and on its phase-2 bars, as is the
                 scratch of activations that the backward without its
                 reduction returns; the others 1e-2 x max |plain| per
                 result). The backward probes are built from the shipped
                 backward's design, the layer-major passes (the route is
                 printed), held against the plain passes in their slot
                 layout; bwd and bwd_no_dw bitwise equal to the shipped
                 backward, every backward probe bitwise equal over two
                 calls, and wgrad_bf16 on the bwd_no_accum scratch bitwise
                 the shipped dWs. Then the probe tool's path (time_anatomy,
                 what time_kernels.py --anatomy runs) at 21 x 8,192 and 21 x
                 32,768 with the probes' launch and route counts and the
                 calls into the pass entries zeroed before and read after
                 (the backward probes must run the passes of the step and
                 anatomy libraries, not the chain kernel), and one
                 attribution line of the shipped backward at each shape:
                 sines, weight work, the reduction after the passes,
                 wgrad_bf16 alone, the product skeleton, beside the bound
                 and the passes' byte floor
11. timings   - each kernel and its plain version: the forward at the
                 phase-2 shapes and at 21 x 8,192, the fused kernel and the
                 row-tile kernel's bf16 instantiation in turns at both
                 (ms, bound, the design's L2 weight bytes, TFLOP/s, host ms a
                 call) beside L2's read rate (a copy loop over 2 x 8 MB),
                 the backward at 21 x
                 32,768 and 21 x 8,192 with and without weight gradients
                 (each backward pass timed alone at 21 x 8,192, with its
                 bytes, FLOPs and the design's byte floor; the forward
                 kernel against the backward's forward passes; the handoff
                 A/B at 21 x 8,192: forward kernel + recomputing backward
                 against the passes' forward + backward from its scratch), each train step at 100 x
                 8,192 and 21 x 8,192 beside the forward + backward kernels
                 at the same shapes; median of CUDA-event timed runs after
                 warm-up; the bound is the larger of FLOPs / 989 TFLOP/s
                 (bf16 dense) and bytes / 3.35 TB/s (H100 SXM data sheet),
                 both counted without the kernels' padding. At 100 x 8,192
                 each pass of a step is also timed alone (ms, bytes, FLOPs,
                 TB/s), with the weight-gradient product, the design's byte
                 floor, the peak device memory of one step, and torch.matmul
                 of the same rows x 256 x 256 bf16 product as a yardstick the
                 port never calls. Launch counts are also kept per
                 FIT_LATENT and FIT_DECODER stage, so that a count can be
                 paired with a time at the same shape
12. report    - one JSON line of kernels, the card's name and power limit,
                 then {"ok": true, "device": {...}} as the last line
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ZOO = os.path.join(ROOT, "data", "Zoo")
CBC = os.path.join(ZOO, "latent_dim_49_net_5_256_vad_cbc_tanh_hdr")
FILM = os.path.join(ZOO, "latent_dim_49_net_5_256_vad_film_tanh_hdr")
WIDTH = 256  # 128 x 256 = 32,768 directions
SERVE_WIDTHS = (128, 130, 256)
DEVICE = "cuda"
# bars of the JAX package's test_fused_bf16_trunk_close
MAX_ERR, MEAN_ERR = 0.05, 0.01
# float32-trunk bars of test_fused_forward_matches_jnp (exact sine) and
# test_fused_apply_fast_sine_matches_fast_jnp (fast sine)
F32_MAX_ERR = {False: 1e-5, True: 2e-5}
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCE = "reni_tpu_torch/kernels/csrc/siren_fwd.cu"
SOURCE_FUSED = "reni_tpu_torch/kernels/csrc/fused_fwd.cuh"
SOURCE_TILE = "reni_tpu_torch/kernels/csrc/siren_fwd.cuh"
SOURCE_BWD = "reni_tpu_torch/kernels/csrc/siren_bwd.cu"
SOURCE_STEP = "reni_tpu_torch/kernels/csrc/siren_step.cu"
SOURCE_FILM_STEP = "reni_tpu_torch/kernels/csrc/film_step.cu"
SOURCE_ANATOMY = "reni_tpu_torch/kernels/csrc/siren_anatomy.cu"
KERNEL_SOURCES = ("siren_fwd", "siren_bwd", "siren_step", "film_step", "siren_anatomy")
# backward bars: max |kernel - plain| <= BAR x max |plain|, per gradient
BWD_BAR = {"bfloat16": 1e-2, "float32": 1e-4}
BWD_WIDTHS = (256, 128)  # 21 x 32,768 and 21 x 8,192 directions
MASK = os.path.join(ROOT, "data", "Masks", "Mask-3.png")
# FIT_LATENT: the published task (config.yaml RENI.FIT_LATENT) with the
# epochs cut from 2,400 to 300
FIT_EPOCHS, FIT_CURRICULUM = 300, (100, 200)
FIT_RES = ((16, 32), (64, 128))  # initial and final resolution
PSNR_BAR_DB = 0.1  # ROADMAP yardstick for trained runs
# FIT_DECODER: the published task (config.yaml RENI.FIT_DECODER) with the
# epochs cut from 2,400 to 30
DEC_EPOCHS, DEC_CURRICULUM = 30, (10, 20)
DEC_BATCH, DEC_MAPS = 100, 1000
STEP_LOSS_BAR = {"bfloat16": 1e-4, "float32": 1e-6}  # relative, kernel vs plain
STEP_TIMED = (100, 21)  # batches timed at 64 x 128
ANATOMY_WIDTH = 128  # the probes are held against their plain versions at 21 x 8,192
ANATOMY_WIDE = 256  # and timed there and at 21 x 32,768
ANATOMY_RUNS = 5  # timed runs per probe here; time_kernels.py --anatomy takes more
WIDE = (("float32", 512), ("bfloat16", 1024))  # forward widths past the 64-row tile
DEEP_MM = 8  # products of the deepened trunk the backward is held at
GUARD_BATCH = 1000  # FIT_DECODER batch of the device-memory guard's step
SYNC_WARMUP = 2  # 64x128 FIT_DECODER steps before the sync check
# the maps the Zoo was trained on (data/Zoo/README.md "Recipe") and the
# published transform (configs/zoo_synthetic.yaml)
SEED_MAPS = dict(train=1000, test=21, width=128, seed=1)
PUBLISHED_TRANSFORMS = [["minmaxnormalise", [-18.0536, 11.4633]]]
# FIT_INVERSE: the published task (config.yaml RENI.FIT_INVERSE: teapot,
# 64 x 64 render, KD_VALUE 1.0, one view, batch 1, 64 x 128 maps) with the
# epochs cut from 1,200 to 40
TEAPOT = os.path.join(ROOT, "data", "3D_Models", "teapot.obj")
INV_EPOCHS, INV_RENDER, INV_KD = 40, 64, 1.0
# the TF32 guard: one GT render with a specular term (kd 0.5) in float32
# against float64, sum |f32 - f64| / sum |f64| (K = 3 dots whose inputs are
# rounded to TF32's 10 mantissa bits put more than 1e-2 there:
# tests/test_torch_render.py::test_tf32_guard_sees_a_tf32_dot); the largest
# pixel error is printed, not held: a light within a few thousandths of a
# degree of -V makes N.H ill-conditioned in the float32 inputs themselves
TF32_GUARD_KD, TF32_GUARD_BAR = 0.5, 1e-4
STEP0_BAR = 1e-2  # step 0's metrics, kernel vs plain run, relative
INV_PROFILED = (100, 105)  # steps of the kernel run traced by torch.profiler
# the decoder's own CUDA kernels, by name (everything else on the card in a
# FIT_INVERSE step is PyTorch's: the shading's maps and light sums, the
# loss, Adam, the encodings)
DECODER_KERNELS = ("fused_fwd", "trunk_fwd", "trunk_bwd", "trunk_step", "fwd_pass", "last_pass",
                   "bwd_pass", "reduce_slots", "wgrad")
# evaluate: the five HDR Zoo entries with the transform of each one's
# config.yaml (the exp entry trains on raw radiance; the LDR entry needs the
# --ldr PNG maps, ROADMAP A-6b), kernel run vs plain run on the card
EVAL_ENTRIES = (("latent_dim_49_net_5_256_vad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS),
                ("latent_dim_49_net_5_256_vad_film_tanh_hdr", PUBLISHED_TRANSFORMS),
                ("latent_dim_100_net_5_256_vad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS),
                ("latent_dim_49_net_5_256_ad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS),
                ("latent_dim_49_net_5_256_vad_cbc_exp_hdr", []))
EVAL_DB, EVAL_SSIM, SELF_DB = 0.05, 1e-3, 50.0
# cli_run: configs/zoo_synthetic.yaml's values (held equal to the file by
# tests/test_torch_cli.py; JSON on the card, which has no PyYAML), the chain
# FIT_DECODER -> FIT_LATENT -> FIT_INVERSE, FIT_INVERSE as published
# (inverse_task_config), the seed-1 maps; cuts: EPOCHS (curriculum) below,
# checkpoints every 5 epochs, 10 image grids every 10 epochs
ZOO_SYNTHETIC = {
    "RENI": {
        "TASKS": ["FIT_DECODER", "FIT_LATENT"],
        "MODEL_TYPE": "VariationalAutoDecoder", "CONDITIONING": "Cond-by-Concat",
        "EQUIVARIANCE": "SO2", "LATENT_DIMENSION": 49, "HIDDEN_LAYERS": 5,
        "HIDDEN_FEATURES": 256, "OUT_FEATURES": 3, "LAST_LAYER_LINEAR": True,
        "OUTPUT_ACTIVATION": "tanh", "FIRST_OMEGA_0": 30.0, "HIDDEN_OMEGA_0": 30.0,
        "FIT_DECODER": {
            "LR_START": 1.0e-5, "LR_END": 1.0e-7, "OPTIMIZER": "adam", "OPTIMIZER_BETA_1": 0.0,
            "OPTIMIZER_BETA_2": 0.9, "BATCH_SIZE": 100, "EPOCHS": 2400,
            "MULTI_RES_TRAINING": True, "INITAL_RESOLUTION": [16, 32],
            "FINAL_RESOLUTION": [64, 128], "CURRICULUM": [800, 1600], "KLD_WEIGHTING": 1.0e-4},
        "FIT_LATENT": {
            "LR_START": 1.0e-2, "LR_END": 1.0e-4, "OPTIMIZER": "adam", "OPTIMIZER_BETA_1": 0.0,
            "OPTIMIZER_BETA_2": 0.9, "BATCH_SIZE": 21, "EPOCHS": 2400,
            "MULTI_RES_TRAINING": True, "INITAL_RESOLUTION": [16, 32],
            "FINAL_RESOLUTION": [64, 128], "CURRICULUM": [800, 1600],
            "COSINE_SIMILARITY_WEIGHT": 1.0e-4, "PRIOR_LOSS_WEIGHT": 1.0e-7,
            "APPLY_MASK": False, "MASK_PATH": "data/Masks/Mask-3.png"},
    },
    "DATASET": {"NAME": "RENI_HDR", "RENI_HDR": {
        "PATH": "/tmp/reni_zoo_data", "TRANSFORMS": [["minmaxnormalise", [-18.0536, 11.4633]]],
        "IS_HDR": True}},
    "TRAINER": {
        "LOGGER_TYPE": "tensorboard", "SEED": 42,
        "CHKPTS": {"SAVE": True, "SAVE_DIR": "/tmp/reni_zoo_ckpts", "EVERY_N_EPOCHS": 200},
        "LOGGER": {"LOG_IMAGES": False, "NUMBER_OF_IMAGES": 10, "IMAGES_TO_SHOW": "random",
                   "EPOCHS_BETWEEN_EXAMPLES": 10,
                   "TB": {"SAVE_DIR": "/tmp/reni_zoo_runs", "NAME": "auto"}},
    },
}
CLI_TASKS = ("FIT_DECODER", "FIT_LATENT", "FIT_INVERSE")
CLI_CUTS = {"FIT_DECODER": (30, [10, 20]), "FIT_LATENT": (60, [20, 40]), "FIT_INVERSE": (10, None)}
CLI_EVERY, CLI_IMAGES_EVERY = 5, 10
CLI_PROBE_S = 600  # time limit of each process of the crash / relaunch probe
CLI_INVERSE_BAR = 1e-6  # FIT_INVERSE's final latents, run B vs run A, relative, if not bitwise


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


def load_entry(entry: str, device):
    """(model config, decoder params on device, 21 test latents on device)."""
    from reni_tpu_torch.params import from_numpy
    from reni_tpu_torch.train import checkpoint as ckpt

    dec, _ = ckpt.load_checkpoint(os.path.join(entry, "checkpoint"))
    lat, _ = ckpt.load_checkpoint(os.path.join(entry, "latents_test"))
    cfg = ckpt.load_model_config(os.path.join(entry, "checkpoint"))
    table = lat["latents"]["mu"] if cfg.is_variational else lat["latents"]["Z"]
    return cfg, from_numpy(dec["decoder"], device), torch.as_tensor(table, device=device)


def kernel_args(cfg):
    """Keyword arguments of the fused wrapper for a model config."""
    kw = dict(
        hidden_layers=cfg.hidden_layers, hidden_features=cfg.hidden_features,
        out_features=cfg.out_features, output_activation=cfg.output_activation,
        trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine,
    )
    if not cfg.is_film:
        kw.update(first_omega_0=cfg.first_omega_0, hidden_omega_0=cfg.hidden_omega_0)
    return kw


def compare(cfg, dec, Z, D, trunk=None):
    """Kernel vs plain version through the public wrappers -> (max, mean,
    max |plain|)."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    kw = kernel_args(cfg)
    if trunk:
        kw["trunk"] = trunk
    if cfg.is_film:
        args = (dec, cfg.equivariance, Z, D)
        out = tk.fused_film_apply(*args, **kw)
        ref = tk.fused_film_apply_reference(*args, **kw)
    else:
        args = (dec, cfg.equivariance, cfg.latent_dim, Z, D)
        out = tk.fused_apply(*args, **kw)
        ref = tk.fused_apply_reference(*args, **kw)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (Z.shape[0], D.shape[1], 3), f"kernel output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "kernel output has non-finite values")
    err = (out - ref).abs()
    return err.max().item(), err.mean().item(), ref.abs().max().item()


def per_image_grids(D: torch.Tensor, batch: int, seed: int) -> torch.Tensor:
    """(B, P, 3) grids: the shared grid under a different random rotation
    per image (a real per-image direction operand, batch stride P*3)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        1,
    )
    return (D @ torch.as_tensor(R, dtype=torch.float32, device=D.device)).contiguous()


def http(base: str, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def decoded(body) -> np.ndarray:
    return np.frombuffer(base64.b64decode(body["data"]), np.float32).reshape(body["shape"])


def serve_entry(entry: str, expected: dict, *, rotation_width: int, concurrent: bool):
    """Start the daemon for a Zoo entry, drive it, and check what it serves
    against the direct decodes in ``expected`` ({width: (21, H, W, 3)})."""
    from reni_tpu_torch.cli.serve import make_server

    httpd = make_server(
        os.path.join(entry, "checkpoint"), os.path.join(entry, "latents_test"),
        port=0, batch_window_ms=20.0, device=DEVICE,
    )
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    name = os.path.basename(entry)
    try:
        code, health = http(base, "/healthz")
        check(code == 200 and health["ok"] and health["dataset_size"] == 21, f"healthz {health}")
        for width in SERVE_WIDTHS:
            ref = expected[width]
            t0 = time.perf_counter()
            code, body = http(base, "/decode_idx", {"idx": list(range(21)), "width": width, "format": "base64"})
            dt = time.perf_counter() - t0
            check(code == 200, f"/decode_idx {code} {body.get('error')}")
            out = decoded(body)
            check(out.shape == (21, width // 2, width, 3), f"/decode_idx shape {out.shape}")
            check(bool(np.isfinite(out).all()), "/decode_idx non-finite radiance")
            diff = float(np.abs(out - ref).max())
            check(diff <= 1e-6, f"served vs direct decode differ by {diff}")
            print(f"{name} /decode_idx 21 x width {width}: {dt * 1e3:.1f} ms, "
                  f"max |served - direct| {diff:.3g}")
        breakdown(base, httpd.reni_service, expected["latents"], max(SERVE_WIDTHS), name)

        width = rotation_width
        z = expected["latents"][:4].tolist()
        c0, r0 = http(base, "/decode", {"z": z, "width": width, "format": "base64"})
        c1, r1 = http(base, "/decode", {"z": z, "width": width, "format": "base64", "rotation_y": 90.0})
        check(c0 == 200 and c1 == 200, f"/decode {c0} {c1}")
        err = np.abs(decoded(r1) - np.roll(decoded(r0), width // 4, axis=2))
        print(f"{name} rotation_y=90 at width {width} vs column roll: max {err.max():.3g}, "
              f"mean {err.mean():.3g}")
        check(err.max() < MAX_ERR and err.mean() < MEAN_ERR, "rotation equivariance off the bf16 bar")

        if concurrent:
            width = SERVE_WIDTHS[0]
            results, threads = {}, []

            def one(i):
                results[i] = http(base, "/decode_idx", {"idx": [i], "width": width, "format": "base64"})

            for i in range(6):
                threads.append(threading.Thread(target=one, args=(i,)))
                threads[-1].start()
            for th in threads:
                th.join(timeout=600)
            check(len(results) == 6 and all(c == 200 for c, _ in results.values()), "concurrent requests")
            for i, (_, body) in results.items():
                # another batch size may take another reduction order in the
                # per-image packing products, so hold rows to the bf16 bar
                err = np.abs(decoded(body)[0] - expected[width][i])
                check(err.max() < MAX_ERR and err.mean() < MEAN_ERR, f"coalesced row {i} differs")
            _, health = http(base, "/healthz")
            stats = health["batching"]
            print(f"{name} batching: {stats}")
            check(stats["dispatches"] < stats["requests"], f"requests did not coalesce: {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def breakdown(base: str, service, latents: np.ndarray, width: int, name: str) -> None:
    """Where a served decode's time goes, medians of 5: the HTTP round trip
    of /decode_idx (JSON, base64, socket, plus the service's decode), the
    service's decode alone (device work + copy to host), the device time of
    the decoder call (CUDA events) and its host time (what the host spends
    to enqueue it: a synchronisation inside the call would show here)."""
    http_ms, svc_ms, dev_ms = [], [], []
    d = service.directions(width).expand(latents.shape[0], -1, -1)
    payload = {"idx": list(range(latents.shape[0])), "width": width, "format": "base64"}
    for _ in range(5):
        t0 = time.perf_counter()
        code, _ = http(base, "/decode_idx", payload)
        http_ms.append((time.perf_counter() - t0) * 1e3)
        check(code == 200, "/decode_idx failed")
        t0 = time.perf_counter()
        service.decode(latents, width)
        svc_ms.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        service.fn(latents, d)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    host_ms = host_time_ms(lambda: service.fn(latents, d), runs=5)
    print(f"{name} width {width} x {latents.shape[0]}: HTTP round trip "
          f"{statistics.median(http_ms):.2f} ms, service.decode "
          f"{statistics.median(svc_ms):.2f} ms, decoder call on the device "
          f"{statistics.median(dev_ms):.2f} ms (host {host_ms:.2f} ms a call)")


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` (launches on one
    stream run in order, so each timing covers one whole call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_time_ms(fn, runs: int = 25) -> float:
    """Median host time of one call of ``fn`` (no synchronisation inside the
    timing, after a synchronised warm-up): what the host spends to enqueue
    it, which bounds a call from below when the card is faster."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def min_bytes(ops, k: int, n_out: int, film: bool, trunk: str) -> int:
    """Bytes of the trunk's inputs without the kernel's padding: k real
    direction features, n_out real output channels, and the matmul weights
    at the trunk's dtype (as the kernel reads them)."""
    if film:
        d, a, ws, bs, wf, bf, fr, ph = ops
        f32 = (bs, fr, ph)
    else:
        d, a, b0, ws, bs, wf, bf = ops
        f32 = (b0, bs)
    w_bytes = 2 if trunk == "bfloat16" else 4
    n = d[..., :k].numel() + a[:, :k].numel() + bf[..., :n_out].numel()
    n += sum(t.numel() for t in f32)
    return 4 * n + w_bytes * (ws.numel() + wf[:, :n_out].numel())


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def build_all() -> None:
    """One nvcc per source, all started together."""
    from reni_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(_build.build, KERNEL_SOURCES))
    print(f"build_s {time.perf_counter() - t0:.2f} ({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


def packed(cfg, dec, Z, D):
    """The trunk operands of a decode (kernels/siren_fwd.py layout)."""
    from reni_tpu_torch.core import encodings
    from reni_tpu_torch.kernels import siren_fwd as tk

    d_feats = encodings.d_features(cfg.equivariance, D)
    if cfg.is_film:
        return tk.pack_film_inputs(dec, cfg.equivariance, Z, d_feats, cfg.hidden_features)
    return tk.pack_inputs(dec, cfg.equivariance, cfg.latent_dim, Z, d_feats)


def bwd_fns(cfg, trunk=None, weight_grads=True):
    """(kernel wrapper, plain version, keyword arguments) of a backward."""
    from reni_tpu_torch.kernels import siren_bwd as tb

    kw = dict(trunk=trunk or cfg.pallas_trunk, fast_sine=cfg.fast_sine,
              weight_grads=weight_grads)
    if cfg.is_film:
        return tb.film_trunk_bwd_cuda, tb.film_trunk_bwd_reference, kw
    kw.update(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0)
    return tb.siren_trunk_bwd_cuda, tb.siren_trunk_bwd_reference, kw


def cotangent(Z: torch.Tensor, npix: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=Z.device).manual_seed(seed)
    return torch.randn((Z.shape[0], npix, 8), generator=gen, device=Z.device)


def deeper(ops, film: bool, n_mm: int):
    """Trunk operands with ``n_mm`` H x H products: the decoder's hidden
    layers repeated in order (the widths of the Zoo entry, a deeper trunk
    than any)."""
    idx = [i % ops[2 if film else 3].shape[0] for i in range(n_mm)]
    if not film:
        d, a, b0, ws, bs, wf, bf = ops
        return d, a, b0, ws[idx], bs[idx], wf, bf
    d, a, ws, bs, wf, bf, fr, ph = ops
    layers = [0] + [i + 1 for i in idx]  # trunk layer 0, then each product's layer
    B, H = a.shape[0], a.shape[-1]
    mod = lambda t: t.view(B, 1, -1, H)[:, :, layers].reshape(B, 1, -1)
    return d, a, ws[idx], bs[layers], wf, bf, mod(fr), mod(ph)


def compare_bwd(cfg, dec, Z, D, trunk, weight_grads, seed, n_mm=None) -> tuple[float, float]:
    """Backward kernel vs plain version, every gradient (``n_mm``: on the
    trunk deepened to that many products), and two kernel calls bit for
    bit; returns the largest max |difference| and the largest max
    |difference| / max |plain| (the quantity the bar holds: the gradients'
    scales differ by orders of magnitude)."""
    kernel, plain, kw = bwd_fns(cfg, trunk, weight_grads)
    ops = packed(cfg, dec, Z, D)
    if n_mm is not None:
        ops = deeper(ops, cfg.is_film, n_mm)
    g = cotangent(Z, D.shape[1], seed)
    got, again, ref = kernel(*ops, g, **kw), kernel(*ops, g, **kw), plain(*ops, g, **kw)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(got, again)):
        check(x is None or torch.equal(x, y), f"gradient {i} differs between two calls")
    bar = BWD_BAR[kw["trunk"]]
    worst, worst_rel, report = 0.0, 0.0, []
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            check(x is None, f"gradient {i} computed without weight gradients")
            continue
        check(tuple(x.shape) == tuple(y.shape), f"gradient {i} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"gradient {i} has non-finite values")
        if not y.numel():
            continue
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        report.append(f"{err / scale:.2g}")
        check(err <= bar * scale, f"gradient {i}: max |diff| {err:.3g} > {bar} x {scale:.3g}")
    print(f"  max |diff| / max |plain| per gradient: {' '.join(report)} (bar {bar})")
    return worst, worst_rel


@contextlib.contextmanager
def plain_trunks():
    """Route RENIModel.apply's fused decodes through the plain forward and
    backward (fused_apply_reference / fused_film_apply_reference) on the
    card: the yardstick a run through the kernels is held against."""
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.models import reni

    saved = reni.fused_apply, reni.fused_film_apply
    reni.fused_apply, reni.fused_film_apply = tk.fused_apply_reference, tk.fused_film_apply_reference
    try:
        yield
    finally:
        reni.fused_apply, reni.fused_film_apply = saved


def fit_task_config(masked: bool):
    from reni_tpu_torch.train.optim import OptimConfig
    from reni_tpu_torch.train.tasks import TaskConfig

    return TaskConfig(
        task="FIT_LATENT",
        optim=OptimConfig(lr_start=1e-2, lr_end=1e-4, optimizer="adam", beta1=0.0, beta2=0.9),
        batch_size=21, epochs=FIT_EPOCHS, multi_res_training=True,
        initial_resolution=FIT_RES[0], final_resolution=FIT_RES[1], curriculum=FIT_CURRICULUM,
        cosine_similarity_weight=1e-4, prior_loss_weight=1e-7, apply_mask=masked,
        mask_path=MASK if masked else None,
    )


def psnr(pred: torch.Tensor, target: torch.Tensor, where=None) -> float:
    """PSNR (peak 1) of the normalised maps, over the pixels ``where``."""
    from reni_tpu_torch.train.losses import psnr as psnr_fn

    if where is not None:
        pred, target = pred[:, where], target[:, where]
    return psnr_fn(pred, target).item()


def timed(step, events: list):
    """``step`` with CUDA events around each whole call, appended to ``events``."""

    def run(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        return out

    return run


def counted(step, counters: dict, tally: dict):
    """``step`` adding, per call, each wrapper's new launches to ``tally``."""

    def run(state, batch):
        before = {k: fn.launches for k, fn in counters.items()}
        out = step(state, batch)
        for k, fn in counters.items():
            tally[k] = tally.get(k, 0) + fn.launches - before[k]
        return out

    return run


def median_ms(events: dict) -> dict:
    return {res: statistics.median(s.elapsed_time(e) for s, e in evs)
            for res, evs in events.items()}


def fit_latent(entry: str, device, *, masked: bool, plain: bool, targets: dict):
    """One FIT_LATENT run from fresh latents, through the kernels or (``plain``)
    their plain versions; returns (fitted maps at the final resolution,
    per-stage step times in ms, metrics, launches {fwd, bwd} during the run)."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    path = os.path.join(entry, "checkpoint")
    cfg = ckpt.load_model_config(path, fixed_decoder=True)
    model = RENIModel(cfg)
    params = ckpt.load_decoder_only(path, model, 21, torch.Generator().manual_seed(0), device)
    task = fit_task_config(masked)
    events: dict = {}

    counters = {"fwd": tk.fused_film_apply if cfg.is_film else tk.fused_apply,
                "fwd_passes": ts.passes_forward,
                "bwd": tb.film_trunk_bwd_cuda if cfg.is_film else tb.siren_trunk_bwd_cuda}
    per_stage: dict = {}

    def timed_step(model, directions, sineweight, res):
        step = tasks.make_fit_latent_step(
            model, directions, sineweight, alpha=task.prior_loss_weight,
            beta=task.cosine_similarity_weight,
        )
        return counted(timed(step, events.setdefault(res, [])), counters,
                       per_stage.setdefault(res, {}))

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with plain_trunks() if plain else contextlib.nullcontext():
        fitted, metrics = tasks.fit_task(
            model, params, task, lambda res: targets[res], torch.Generator().manual_seed(1),
            mask_path=task.mask_path, step_builder=timed_step,
        )
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ms = median_ms(events)
    with torch.no_grad():
        maps = model.apply(fitted, fitted["latents"]["mu"],
                           sphere.get_directions(FIT_RES[1][1], device=device))
    return maps, ms, metrics, launches, per_stage


def fit_latent_phase(device) -> dict:
    """FIT_LATENT through the kernels and through their plain versions;
    returns the forward and backward launches of the kernel runs per kernel
    name, in all and (``<name>@<h>x<w>``) per resolution stage."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.serve import load_decoder

    launches = {"siren_bwd": 0, "film_bwd": 0}
    fwd_name = {"siren_bwd": "siren_fwd", "film_bwd": "film_fwd"}
    mask = sphere.get_mask(FIT_RES[1][1], MASK, device=device)[0, :, 0] > 0.5
    stages = fit_task_config(False).resolution_stages()
    for name, entry, masked in (("siren_bwd", CBC, False), ("film_bwd", FILM, False),
                                ("siren_bwd", CBC, True)):
        label = f"{os.path.basename(entry)}{' masked (Mask-3)' if masked else ''}"
        # targets: the port's own decode of the entry's 21 test latents
        fn = load_decoder(os.path.join(entry, "checkpoint"), device)
        lat = load_entry(entry, device)[2]
        # (clone: load_decoder decodes under inference_mode)
        targets = {res: fn(lat, sphere.get_directions(res[1], device=device)).clone()
                   for res, _ in stages}
        result = {}
        for plain in (False, True):
            t0 = time.perf_counter()
            maps, ms, metrics, n, by_stage = fit_latent(entry, device, masked=masked,
                                                        plain=plain, targets=targets)
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(maps).all()), f"{label}: non-finite fitted maps")
            steps = FIT_EPOCHS  # one batch of 21 per epoch
            if plain:
                check(not any(n.values()), f"{label}: the plain run launched kernels {n}")
            else:
                # a forward (the passes', whose scratch the backward reads, or
                # the forward kernel's) and a backward per step
                check(n["fwd"] + n["fwd_passes"] == steps and n["bwd"] == steps,
                      f"{label}: {n} launches in {steps} steps (a forward and a backward each)")
                launches[name] += n["bwd"]
                for res, c in by_stage.items():
                    for key, kname in (("bwd", name), ("fwd", fwd_name[name]),
                                       ("fwd_passes", f"{name}_fwd_passes")):
                        tag = f"{kname}@{res[0]}x{res[1]}"
                        launches[tag] = launches.get(tag, 0) + c[key]
            loss = metrics["fit_latent_loss"]
            last = loss[-stages[-1][1]:]  # the final stage's epochs
            check(bool(np.isfinite(loss).all()) and last[-1] < last[0],
                  f"{label}: final-stage loss {last[0]} -> {last[-1]}")
            target = targets[FIT_RES[1]]
            db = {"all": psnr(maps, target)}
            if masked:
                db["observed (mask 1)"] = psnr(maps, target, mask)
                db["hidden (mask 0)"] = psnr(maps, target, ~mask)
            result[plain] = db
            run = "plain" if plain else "kernels"
            off = 0
            for (res, n_ep), (_, t) in zip(stages, sorted(ms.items())):
                print(f"{label} [{run}] stage {res[0]}x{res[1]}: {t:.3f} ms/step (median), "
                      f"epoch loss {loss[off]:.6g} -> {loss[off + n_ep - 1]:.6g}, launches "
                      f"{by_stage.get(res, {})}")
                off += n_ep
            print(f"{label} [{run}] {steps} steps in {wall:.1f} s, launches {n}; PSNR at "
                  f"{FIT_RES[1][0]}x{FIT_RES[1][1]} " + ", ".join(f"{k} {v:.3f} dB" for k, v in db.items()))
        for k in result[False]:
            gap = abs(result[False][k] - result[True][k])
            check(gap <= PSNR_BAR_DB, f"{label}: PSNR {k} kernels vs plain differ by {gap:.3f} dB")
        print(f"{label}: PSNR kernels - plain " + ", ".join(
            f"{k} {result[False][k] - result[True][k]:+.3f} dB" for k in result[False]))
    return launches


def seed_maps(device, tmp: str):
    """The maps the Zoo was trained and evaluated on (``data/Zoo/README.md``
    "Recipe"; SEED_MAPS): written by the port's ``data/synthetic.py`` (ZIP,
    half) into a temporary directory, loaded with the port's ``get_dataset``
    and the published transform, both splits, then staged to the card at
    FIT_DECODER's resolutions. Prints the host stage (ms a map for generate
    and write, decode, stage) and a digest of the staged 64x128 training
    maps (numpy's SIMD sin and exp may differ between CPUs, so it is not
    asserted). The maps stay in ``tmp`` for the evaluate phase. Returns
    (training set, test set)."""
    from reni_tpu_torch.data import datasets, synthetic

    n = SEED_MAPS["train"] + SEED_MAPS["test"]
    t0 = time.perf_counter()
    folders = synthetic.write_dataset(tmp, **SEED_MAPS)
    t1 = time.perf_counter()
    train, test = (datasets.get_dataset("RENI_HDR", folders[split], PUBLISHED_TRANSFORMS, True)
                   for split in ("Train", "Test"))
    t2 = time.perf_counter()
    stages = [res for res, _ in decoder_task_config().resolution_stages()]
    for res in stages:
        train.images_at(res, device=device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check((len(train), len(test)) == (SEED_MAPS["train"], SEED_MAPS["test"]),
          f"{len(train)} training and {len(test)} test maps")
    test_maps = test.images_host_at(FIT_RES[1])
    for res in stages:
        x = train.images_at(res, device=device)
        check(tuple(x.shape) == (SEED_MAPS["train"], res[0] * res[1], 3)
              and bool(torch.isfinite(x).all()), f"training maps at {res}: {tuple(x.shape)}")
    check(bool(np.isfinite(test_maps).all()), "non-finite test maps")
    final = train.images_at(FIT_RES[1], device=device)
    digest = hashlib.sha256(final.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"seed-{SEED_MAPS['seed']} maps: {SEED_MAPS['train']} train + {SEED_MAPS['test']} test "
          f"at {SEED_MAPS['width'] // 2}x{SEED_MAPS['width']}, log min/max {train.minmax}; "
          f"staged range [{final.min().item():.4f}, {final.max().item():.4f}], digest {digest}")
    print(f"host stage of the maps: generate and write {(t1 - t0) * 1e3 / n:.3f} ms a map, "
          f"decode {(t2 - t1) * 1e3 / n:.3f}, stage {len(stages)} resolutions on the card "
          f"{(t3 - t2) * 1e3 / SEED_MAPS['train']:.3f}; total {t3 - t0:.2f} s")
    return train, test


def inverse_task_config():
    from reni_tpu_torch.train.optim import OptimConfig
    from reni_tpu_torch.train.tasks import TaskConfig

    return TaskConfig(
        task="FIT_INVERSE",
        optim=OptimConfig(lr_start=1e-2, lr_end=1e-5, optimizer="adam", beta1=0.0, beta2=0.999),
        batch_size=1, epochs=INV_EPOCHS, multi_res_training=False,
        initial_resolution=FIT_RES[0], final_resolution=FIT_RES[1],
        cosine_similarity_weight=1e-4, prior_loss_weight=1e-7, render_resolution=INV_RENDER,
        object_path=TEAPOT, kd_value=INV_KD,
    )


def render_psnr(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """PSNR of renders against GT renders, peak the largest GT value."""
    mse = torch.mean((pred - gt) ** 2)
    return (10.0 * torch.log10(gt.max() ** 2 / mse)).item()


def fit_inverse(entry: str, device, test, setup, *, plain: bool):
    """One FIT_INVERSE run (``render.inverse.fit_inverse``) from fresh latents
    to the 21 seed-1 test maps, through the kernels or (``plain``) the plain
    decoder; returns (fitted params, metrics, the first step's metrics,
    median ms a step, launches {fwd, fwd_passes, bwd, pass calls, fused,
    tile} during the run)."""
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.render import inverse
    from reni_tpu_torch.train import checkpoint as ckpt

    path = os.path.join(entry, "checkpoint")
    cfg = ckpt.load_model_config(path, fixed_decoder=True)
    model = RENIModel(cfg)
    params = ckpt.load_decoder_only(path, model, SEED_MAPS["test"],
                                    torch.Generator().manual_seed(0), device)
    counters = {"fwd": tk.fused_film_apply if cfg.is_film else tk.fused_apply,
                "fwd_passes": ts.passes_forward,
                "bwd": tb.film_trunk_bwd_cuda if cfg.is_film else tb.siren_trunk_bwd_cuda}
    lib = "film_step" if cfg.is_film else "siren_step"
    events, tally, first, prof = [], {}, [], {}

    def wrap(step, res):
        step = counted(timed(step, events), counters, tally)

        def run(state, batch):
            if not plain and len(events) == INV_PROFILED[0]:
                torch.cuda.synchronize()
                prof["p"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof["p"].__enter__()
            state, m = step(state, batch)
            if "p" in prof and len(events) == INV_PROFILED[1]:
                torch.cuda.synchronize()
                prof["p"].__exit__(None, None, None)
            if not first:
                first.append({k: v.item() for k, v in m.items()})
            return state, m

        return run

    setup.generate_gt_renders(test.images_at(FIT_RES[1], device=device), test.unnormalise,
                              FIT_RES[1][1])  # made before the counts are zeroed
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    calls0 = ts.pass_launches[lib]
    tk.fused_fwd_launches = tk.tile_fwd_launches = 0
    with plain_trunks() if plain else contextlib.nullcontext():
        fitted, metrics = inverse.fit_inverse(
            model, params, inverse_task_config(),
            lambda res: test.images_at(res, device=device), test.unnormalise,
            torch.Generator().manual_seed(1), setup=setup, wrap_step=wrap,
        )
    torch.cuda.synchronize()
    n = {k: fn.launches for k, fn in counters.items()}
    n.update(pass_calls=ts.pass_launches[lib] - calls0, fused=tk.fused_fwd_launches,
             tile=tk.tile_fwd_launches)
    ms = statistics.median(s.elapsed_time(e) for s, e in events)
    if "p" in prof:
        device_split(prof["p"], INV_PROFILED[1] - INV_PROFILED[0], ms, os.path.basename(entry))
    return model, fitted, metrics, first[0], ms, n


def device_split(prof, n_steps: int, step_ms: float, label: str) -> None:
    """Device time a step from a torch.profiler trace of ``n_steps`` steps
    (kernels, copies and fills; not the annotations' ranges): the decoder's
    own kernels (DECODER_KERNELS) and PyTorch's (the shading, loss, Adam,
    encodings), beside the median step of the unprofiled steps (the
    profiler slows the host); the rest is the card's idle time. Printed,
    not held."""
    from torch.autograd import DeviceType

    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not work:
        print(f"{label}: the profiler saw no device time (CUDA events only)")
        return
    per_step = {}
    for e in work:
        per_step[e.name] = per_step.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n_steps
    ours = sum(v for k, v in per_step.items() if any(d in k for d in DECODER_KERNELS))
    total = sum(per_step.values())
    heavy = sorted(per_step.items(), key=lambda kv: -kv[1])[:5]
    print(f"{label}: a step's device time (torch.profiler, {n_steps} steps): the decoder's "
          f"kernels {ours:.3f} ms, PyTorch's kernels {total - ours:.3f} ms, of a {step_ms:.3f} ms "
          f"step (idle {max(step_ms - total, 0.0) / step_ms:.1%}); heaviest: "
          + ", ".join(f"{k[:40]} {v:.3f}" for k, v in heavy))


def shading_and_decoder_ms(model, params, setup, device) -> tuple[float, float]:
    """The render's forward + backward alone at a FIT_INVERSE step's shape
    (one 64 x 128 map's 8,192 lights, a 64 x 64 render), and the decoder's
    (one latent x 8,192 directions, the gradient w.r.t. the latent), each
    timed by CUDA events around whole calls."""
    from reni_tpu_torch.core import sphere

    width = FIT_RES[1][1]
    render = setup.render_fn(width)
    sw = sphere.get_sineweight(width, device=device)
    env = torch.rand((1, sw.shape[1], 3), device=device, generator=torch.Generator(
        device=device).manual_seed(5)).requires_grad_()

    def shade():
        render(env, sw).sum().backward()

    D = sphere.get_directions(width, device=device)
    z = model.latents(params, [0]).detach().clone().requires_grad_()

    def decode():
        model.apply(params, z, D).sum().backward()

    return time_ms(shade, runs=10), time_ms(decode, runs=10)


def tf32_guard(test, device) -> None:
    """One GT render with a specular term (test map 0, kd 0.5) in float32
    against float64 on the card: sum |f32 - f64| / sum |f64| <= the bar
    (the largest pixel error printed beside it)."""
    from reni_tpu_torch.render.inverse import InverseRenderSetup

    setup = InverseRenderSetup(TEAPOT, render_resolution=INV_RENDER, kd=TF32_GUARD_KD,
                               device=device)
    maps = test.images_at(FIT_RES[1], device=device)[:1]
    r32 = setup.generate_gt_renders(maps, test.unnormalise, FIT_RES[1][1]).double()
    r64 = setup.generate_gt_renders(maps.double(), test.unnormalise, FIT_RES[1][1])
    err = (r32 - r64).abs()
    mean_rel = (err.sum() / r64.abs().sum()).item()
    max_rel = (err.max() / r64.abs().max()).item()
    print(f"TF32 guard: GT render of test map 0 at kd {TF32_GUARD_KD}, float32 vs float64: "
          f"sum|diff|/sum|f64| {mean_rel:.3g} (bar {TF32_GUARD_BAR}), max|diff|/max|f64| "
          f"{max_rel:.3g} (printed); allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    check(bool(torch.isfinite(r32).all()), "non-finite float32 GT render")
    check(mean_rel <= TF32_GUARD_BAR, f"float32 render off float64 by {mean_rel:.3g}")


def batch_one_checks(entries, device) -> None:
    """The decode at FIT_INVERSE's batch of one: the backward on the passes
    against its plain version at 1 x 8,192 (each gradient, one image's 64
    row tiles reduced into its latent gradient), and the device-memory
    guard's plan at this size."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_step as ts

    D = sphere.get_directions(FIT_RES[1][1], device=device)
    for name, (cfg, dec, Z) in entries.items():
        print(f"{name} backward at 1 x {D.shape[1]}, no weight gradients:")
        compare_bwd(cfg, dec, Z[:1], D, None, False, seed=11)
        plan = bwd_plan(cfg, dec, Z[:1], device, weight_grads=False)[0]
        budget = ts.device_budget(device)
        groups = plan.groups(budget)
        print(f"  plan: {plan.tiles_per_cta} tiles a CTA x {plan.chunks} chunks, scratch "
              f"{plan.scratch_bytes / 2**20:.2f} MiB against a budget of {budget / 2**30:.1f} GiB "
              f"-> {len(groups)} group(s)")
        check(ts.pass_route(cfg.pallas_trunk, cfg.hidden_features,
                            cfg.hidden_layers - cfg.is_film), f"{name}: B = 1 is off the passes")
        check(groups == ((0, 1),), f"{name}: one image in {groups}")


def fit_inverse_phase(device, test, entries) -> dict:
    """FIT_INVERSE on both Zoo decoders through the kernels and the plain
    decoder; returns the kernel runs' backward and forward-pass launches
    under ``<kernel>@fit_inverse``."""
    from reni_tpu_torch import eval as ev
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.render import rasterizer
    from reni_tpu_torch.render.inverse import InverseRenderSetup

    t0 = time.perf_counter()
    batch_one_checks(entries, device)
    tf32_guard(test, device)
    setup = InverseRenderSetup(TEAPOT, render_resolution=INV_RENDER, kd=INV_KD, device=device)
    print(f"fragments: the native rasterizer {rasterizer.library_path().name}, "
          f"{(setup.fragments.pix_to_face >= 0).mean():.3f} of the {INV_RENDER}x{INV_RENDER} "
          f"render covered")
    maps = test.images_at(FIT_RES[1], device=device)
    gt = setup.generate_gt_renders(maps, test.unnormalise, FIT_RES[1][1])
    render = setup.render_fn(FIT_RES[1][1])
    D = sphere.get_directions(FIT_RES[1][1], device=device)
    sw = sphere.get_sineweight(FIT_RES[1][1], device=device)
    steps = INV_EPOCHS * SEED_MAPS["test"]
    launches = {}
    for name, entry in (("siren_bwd", CBC), ("film_bwd", FILM)):
        label = os.path.basename(entry)
        result = {}
        for plain in (False, True):
            run = "plain" if plain else "kernels"
            t1 = time.perf_counter()
            model, fitted, metrics, first, ms, n = fit_inverse(entry, device, test, setup,
                                                               plain=plain)
            wall = time.perf_counter() - t1
            loss = metrics["fit_inverse_loss"]
            check(bool(np.isfinite(loss).all()) and loss[-1] < loss[0],
                  f"{label} [{run}]: epoch loss {loss[0]} -> {loss[-1]}")
            if plain:
                check(not any(n.values()), f"{label}: the plain run launched kernels {n}")
            else:
                # a forward as the fwd passes and a cotangent backward from
                # their scratch each step: two calls into the pass entry, no
                # forward kernel, no chain kernel
                check(n["fwd_passes"] == steps and n["bwd"] == steps and n["pass_calls"] == 2 * steps
                      and n["fwd"] == n["fused"] == n["tile"] == 0,
                      f"{label}: {n} in {steps} steps (passes route, nothing else)")
                launches[f"{name}@fit_inverse"] = n["bwd"]
                launches[f"{name}_fwd_passes@fit_inverse"] = n["fwd_passes"]
            with torch.no_grad():
                env = test.unnormalise(model.apply(fitted, fitted["latents"]["mu"], D))
                pred = render(env, sw.expand(env.shape))
            db = render_psnr(pred, gt)
            rec = ev.inverse_recovery_eval(model, fitted, maps, FIT_RES[1], setup,
                                           unnormalise=test.unnormalise)
            result[plain] = (first, db)
            print(f"{label} [{run}] {steps} steps in {wall:.1f} s: {ms:.3f} ms/step (median), "
                  f"epoch loss {loss[0]:.6g} -> {loss[-1]:.6g}, launches {n}; renders vs GT "
                  f"PSNR {db:.3f} dB; render correlation mean "
                  f"{rec['render_correlation_mean']:.4f} min {rec['render_correlation_min']:.4f}, "
                  f"envmap_rel_error {rec['envmap_rel_error']:.4f}")
            if not plain:
                shade_ms, dec_ms = shading_and_decoder_ms(model, fitted, setup, device)
                print(f"{label}: at a step's shape the render's forward + backward alone "
                      f"{shade_ms:.3f} ms, the decoder's {dec_ms:.3f} ms, of {ms:.3f} ms a step")
        (k_first, k_db), (p_first, p_db) = result[False], result[True]
        for k in k_first:
            rel = abs(k_first[k] - p_first[k]) / max(abs(p_first[k]), 1e-30)
            check(rel <= STEP0_BAR, f"{label}: step 0 {k} {k_first[k]} vs plain {p_first[k]}")
        print(f"{label}: step 0 kernels vs plain " + ", ".join(
            f"{k} {k_first[k]:.6g} / {p_first[k]:.6g}" for k in k_first)
              + f"; renders PSNR kernels - plain {k_db - p_db:+.3f} dB")
        check(abs(k_db - p_db) <= PSNR_BAR_DB, f"{label}: render PSNR gap {k_db - p_db:.3f} dB")
    print(f"fit_inverse phase wall {time.perf_counter() - t0:.1f} s")
    return launches


def evaluate_phase(device, maps_root: str) -> dict:
    """``cli/evaluate.py`` on the HDR Zoo entries' test latents and the
    seed-1 test maps, through the kernels and the plain decoder on the card;
    returns the forward kernels' launches of the kernel runs under
    ``<kernel>@evaluate``."""
    from reni_tpu_torch.cli import evaluate
    from reni_tpu_torch.kernels import siren_fwd as tk

    t0 = time.perf_counter()
    keys = ("psnr_mean", "ssim_mean", "rotated_reconstruction_psnr", "self_consistency_psnr")
    launches = {"siren_fwd@evaluate": 0, "film_fwd@evaluate": 0}
    for name, transforms in EVAL_ENTRIES:
        entry = os.path.join(ZOO, name)
        cfg_path = os.path.join(maps_root, f"{name}.json")
        with open(cfg_path, "w") as f:
            json.dump({"DATASET": {"NAME": "RENI_HDR", "RENI_HDR": {
                "PATH": maps_root, "TRANSFORMS": transforms, "IS_HDR": True}}}, f)
        argv = ["--checkpoint", os.path.join(entry, "latents_test"), "--cfg_path", cfg_path,
                "--device", "cuda"]
        if entry == CBC:
            argv += ["--mask", MASK]
        with open(os.path.join(entry, "eval.json")) as f:
            card = json.load(f)
        reports = {}
        for plain in (False, True):
            torch.cuda.synchronize()
            tk.fused_apply.launches = tk.fused_film_apply.launches = 0
            tk.fused_fwd_launches = tk.tile_fwd_launches = 0
            with plain_trunks() if plain else contextlib.nullcontext(), \
                    contextlib.redirect_stdout(io.StringIO()):
                reports[plain] = evaluate.main(argv)
            torch.cuda.synchronize()
            n = {"fused": tk.fused_fwd_launches, "tile": tk.tile_fwd_launches,
                 "cbc": tk.fused_apply.launches, "film": tk.fused_film_apply.launches}
            if plain:
                check(not any(n.values()), f"{name}: the plain run launched kernels {n}")
            else:
                check(n["fused"] == n["cbc"] + n["film"] > 0 and n["tile"] == 0,
                      f"{name}: evaluation decodes {n} not all through the fused kernel")
                launches["siren_fwd@evaluate"] += n["cbc"]
                launches["film_fwd@evaluate"] += n["film"]
        got, ref = reports[False], reports[True]
        print(f"{name}: kernels / plain / eval.json " + "; ".join(
            f"{k} {got[k]:.4f} / {ref[k]:.4f} / {card[k]:.4f}" for k in keys)
              + ("; in-painting (Mask-3) observed {:.3f} / {:.3f}, hallucinated {:.3f} / {:.3f} "
                 "dB".format(got["observed_psnr"], ref["observed_psnr"],
                             got["hallucinated_psnr"], ref["hallucinated_psnr"])
                 if "observed_psnr" in got else ""))
        for k, bar in (("psnr_mean", EVAL_DB), ("rotated_reconstruction_psnr", EVAL_DB),
                       ("ssim_mean", EVAL_SSIM), ("observed_psnr", EVAL_DB),
                       ("hallucinated_psnr", EVAL_DB)):
            if k in got:
                check(abs(got[k] - ref[k]) <= bar, f"{name}: {k} kernels {got[k]} plain {ref[k]}")
        check(got["self_consistency_psnr"] >= SELF_DB,
              f"{name}: self_consistency_psnr {got['self_consistency_psnr']}")
    print(f"launches during evaluation (kernel runs): {launches}; the LDR entry is left out (its "
          f"maps need the --ldr PNG generation, ROADMAP A-6b); evaluate phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def cli_config(maps_root: str, runs: str):
    """The trainer's config for the cli_run phase: ``get_cfg_defaults()``
    merged with ZOO_SYNTHETIC, the three-task chain, FIT_INVERSE as
    ``inverse_task_config`` has it, the seed-1 maps under ``maps_root`` and
    runs under ``runs``, and the phase's cuts."""
    import copy

    from reni_tpu_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults().merge_from_dict(copy.deepcopy(ZOO_SYNTHETIC))
    cfg.RENI.TASKS = list(CLI_TASKS)
    inv = inverse_task_config()
    cfg.RENI.FIT_INVERSE.merge_from_dict({
        "LR_START": inv.optim.lr_start, "LR_END": inv.optim.lr_end,
        "OPTIMIZER": inv.optim.optimizer, "OPTIMIZER_BETA_1": inv.optim.beta1,
        "OPTIMIZER_BETA_2": inv.optim.beta2, "BATCH_SIZE": inv.batch_size,
        "MULTI_RES_TRAINING": inv.multi_res_training,
        "FINAL_RESOLUTION": list(inv.final_resolution),
        "COSINE_SIMILARITY_WEIGHT": inv.cosine_similarity_weight,
        "PRIOR_LOSS_WEIGHT": inv.prior_loss_weight,
        "RENDER_RESOLUTION": inv.render_resolution, "OBJECT_PATH": inv.object_path,
        "KD_VALUE": inv.kd_value})
    for task, (epochs, curriculum) in CLI_CUTS.items():
        cfg.RENI[task].EPOCHS = epochs
        if curriculum:
            cfg.RENI[task].CURRICULUM = curriculum
    cfg.DATASET.RENI_HDR.PATH = maps_root
    cfg.TRAINER.CHKPTS.SAVE_DIR = "checkpoints"
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = CLI_EVERY
    cfg.TRAINER.LOGGER.LOG_IMAGES = True
    cfg.TRAINER.LOGGER.EPOCHS_BETWEEN_EXAMPLES = CLI_IMAGES_EVERY
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = runs
    return cfg


def _cli_rows(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli_finals(log_dir: str) -> dict:
    out = {}
    for task in CLI_TASKS:
        with np.load(os.path.join(log_dir, "checkpoints", f"{task.lower()}_final.npz")) as z:
            out[task] = {k: z[k] for k in z.files}
    return out


def cli_chain(device, cfg, cfg_path: str) -> tuple[str, dict, dict]:
    """Run A: the whole chain in this process through ``cli.run.cli``, the
    kernels' counts zeroed just before and read just after; returns (its
    run dir, {task: {part: wall seconds}}, launches). The parts: the whole
    ``run_task``, its graph export, ``fit_task`` (the training loop with its
    callbacks), and inside it the checkpoint saves and the image grids
    (host clock, the card synchronised around each)."""
    from reni_tpu_torch.cli import run as cli_run
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    counters = {"siren_step": ts.siren_step_cuda, "siren_bwd": tb.siren_trunk_bwd_cuda,
                "siren_fwd": tk.fused_apply, "fwd_passes": ts.passes_forward}
    parts = {"task": (cli_run, "run_task"), "graph": (cli_run, "_dump_model_graph"),
             "fit_task": (tasks, "fit_task"), "saves": (ckpt, "save_checkpoint"),
             "grids": (cli_run, "example_images")}
    seconds: dict = {}
    current = ["?"]

    def timed(part, fn):
        def run(*a, **k):
            if part == "task":
                current[0] = a[1]
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                by = seconds.setdefault(current[0], {})
                by[part] = by.get(part, 0.0) + time.perf_counter() - t
        return run

    argv = ["--cfg_path", cfg_path] + ([] if device.type == "cuda" else ["--device", "cpu"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    tk.fused_fwd_launches = tk.tile_fwd_launches = 0
    real = {part: getattr(mod, name) for part, (mod, name) in parts.items()}
    for part, (mod, name) in parts.items():
        setattr(mod, name, timed(part, real[part]))
    try:
        rc = cli_run.cli(argv)
    finally:
        for part, (mod, name) in parts.items():
            setattr(mod, name, real[part])
    torch.cuda.synchronize()
    n = {k: fn.launches for k, fn in counters.items()}
    n.update(fused=tk.fused_fwd_launches, tile=tk.tile_fwd_launches)
    check(rc == 0, f"run A: cli returned {rc}")
    return cli_run._experiment_runs(cfg)[0], seconds, n


def relaunch_probe(device, cfg, cfg_path: str, log_b: str, out_path: str) -> int:
    """Run B: ``python -m reni_tpu_torch.cli.run --cfg_path ... --retries 1``,
    SIGKILLed once ``fit_decoder_latest.json`` reports an epoch that is not
    a stage end (a resume mid-stage, with the VAD noise and Adam's state in
    play), then the same command again, which must adopt ``log_b``. Both
    processes' output goes to ``out_path``; returns the killed epoch."""
    import signal

    from reni_tpu_torch.train.tasks import TaskConfig

    cmd = [sys.executable, "-m", "reni_tpu_torch.cli.run", "--cfg_path", cfg_path,
           "--retries", "1"] + ([] if device.type == "cuda" else ["--device", "cpu"])
    stage_ends, off = set(), 0
    for _, n in TaskConfig.from_config(cfg, "FIT_DECODER").resolution_stages():
        off += n
        stage_ends.add(off)
    latest = os.path.join(log_b, "checkpoints", "fit_decoder_latest.json")
    killed = None
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            limit = time.monotonic() + CLI_PROBE_S
            while proc.poll() is None and time.monotonic() < limit:
                try:
                    with open(latest) as f:
                        epoch = int(json.load(f)["epoch"])
                except (OSError, ValueError, KeyError):
                    epoch = None
                if epoch is not None and epoch not in stage_ends:
                    os.killpg(proc.pid, signal.SIGKILL)
                    killed = epoch
                    break
                time.sleep(0.005)
        finally:
            if proc.poll() is None and killed is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=120)
        check(killed is not None, f"run B ended (rc {proc.returncode}) before "
                                  f"{latest} reported an epoch off the stage ends {stage_ends}")
        out.write(f"\n[chip_smoke] SIGKILL at FIT_DECODER epoch {killed}\n")
        out.flush()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=CLI_PROBE_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=120)
    check(rc == 0, f"run B's relaunch exited {rc} (its output: {out_path})")
    return killed


def cli_run_phase(device, maps_root: str) -> dict:
    """The trainer (``reni_tpu_torch.cli.run``) on the flagship configuration:
    run A, the chain in this process; run B, the same command SIGKILLed in
    FIT_DECODER and relaunched with --retries 1, which must adopt its run
    dir and end bit for bit at run A's final checkpoints. Returns run A's
    launches under ``<kernel>@cli_run``."""
    t0 = time.perf_counter()
    work = os.path.join(maps_root, "cli_run")
    os.makedirs(work, exist_ok=True)
    cfg = cli_config(maps_root, os.path.join(work, "runs"))
    cfg_path = os.path.join(work, "zoo_synthetic_chain.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    print("cuts of configs/zoo_synthetic.yaml: " + "; ".join(
        f"{t} EPOCHS {cfg.RENI[t].EPOCHS}" + (f", curriculum {cfg.RENI[t].CURRICULUM}"
                                              if cfg.RENI[t].MULTI_RES_TRAINING else "")
        for t in CLI_TASKS) + f"; checkpoints every {CLI_EVERY} epochs, "
          f"{cfg.TRAINER.LOGGER.NUMBER_OF_IMAGES} images every {CLI_IMAGES_EVERY} epochs; "
          f"FIT_INVERSE as published (teapot, {INV_RENDER}x{INV_RENDER}, KD {INV_KD}, batch 1)")

    log_a, task_s, n = cli_chain(device, cfg, cfg_path)
    wall_a = time.perf_counter() - t0
    rows_a = _cli_rows(log_a)
    steps = {t: cfg.RENI[t].EPOCHS * -(-(SEED_MAPS["train"] if t == "FIT_DECODER"
                                         else SEED_MAPS["test"]) // cfg.RENI[t].BATCH_SIZE)
             for t in CLI_TASKS}
    ckdir = os.path.join(log_a, "checkpoints")
    files = sorted(os.listdir(ckdir))
    for task in CLI_TASKS:
        t = task.lower()
        kept = [f for f in files if f.startswith(f"{t}_epoch=") and f.endswith(".npz")]
        loss = [r[f"{t}_loss"] for r in rows_a if f"{t}_loss" in r]
        with open(os.path.join(ckdir, f"{t}_final.json")) as f:
            final = json.load(f)
        part = task_s[task]
        print(f"run A {task}: {steps[task]} steps, {part['task']:.2f} s (graph export "
              f"{part.get('graph', 0):.2f}, fit_task {part['fit_task']:.2f}; checkpoint saves "
              f"{part.get('saves', 0):.2f}, grids {part.get('grids', 0):.2f}), final "
              f"{t}_loss {final['loss']:.6g} (logged {loss[0]:.6g} -> {loss[-1]:.6g}); kept {kept}")
        check(len(kept) == 2 and f"{t}_latest.npz" in files and f"{t}_final.npz" in files,
              f"run A {task}: checkpoints {[f for f in files if f.startswith(t)]}")
        check(bool(np.isfinite(loss).all()), f"run A {task}: non-finite loss {loss}")
    images = sorted(os.listdir(os.path.join(log_a, "images")))
    print(f"run A image grids: {images}")
    check(len(images) == CLI_CUTS["FIT_DECODER"][0] // CLI_IMAGES_EVERY
          + CLI_CUTS["FIT_LATENT"][0] // CLI_IMAGES_EVERY + 1, f"run A image grids {images}")
    check(os.path.exists(os.path.join(log_a, "fit_decoder_graph.txt")), "no decoder graph")
    print(f"run A launches: {n}")
    # FIT_DECODER through the step kernel; FIT_LATENT's and FIT_INVERSE's
    # decodes as the fwd passes and their backward from the passes' scratch;
    # the grids (FIT_DECODER 3, FIT_LATENT 6, FIT_INVERSE's renders 1)
    # through the fused forward kernel
    check(n["siren_step"] == steps["FIT_DECODER"], f"step kernel {n['siren_step']} launches")
    fit_steps = steps["FIT_LATENT"] + steps["FIT_INVERSE"]
    check(n["siren_bwd"] == n["fwd_passes"] == fit_steps,
          f"backward {n['siren_bwd']}, forward passes {n['fwd_passes']}: {fit_steps} steps")
    check(n["siren_fwd"] == n["fused"] == len(images) and n["tile"] == 0,
          f"forward kernel {n}: {len(images)} grids")

    t1 = time.perf_counter()
    log_b = os.path.join(os.path.dirname(log_a), "version_1")
    out_b = os.path.join(work, "run_b.log")
    killed = relaunch_probe(device, cfg, cfg_path, log_b, out_b)
    wall_b = time.perf_counter() - t1
    with open(out_b) as f:
        text = f.read()
    adopt = [line for line in text.splitlines() if line.startswith("[relaunch] adopting")]
    print(f"run B: SIGKILL at FIT_DECODER epoch {killed}; relaunch: {adopt}")
    check(len(adopt) == 1 and log_b in adopt[0], f"run B's relaunch did not adopt {log_b}")
    runs = sorted(os.listdir(os.path.dirname(log_a)))
    check(runs == ["version_0", "version_1"], f"run dirs {runs}")
    rows_b = _cli_rows(log_b)
    events = [i for i, r in enumerate(rows_b) if r.get("event") == "relaunch_adopt"]
    check(len(events) == 1, f"run B's relaunch_adopt events: {events}")
    fa, fb = _cli_finals(log_a), _cli_finals(log_b)
    bitwise = {t: fa[t].keys() == fb[t].keys() and all(np.array_equal(fa[t][k], fb[t][k])
                                                         for k in fa[t]) for t in CLI_TASKS}
    print(f"run B's final checkpoints bit for bit run A's: {bitwise}")
    for task in ("FIT_DECODER", "FIT_LATENT"):
        check(bitwise[task], f"{task}: run B's final checkpoint is not run A's, bit for bit")
    if not bitwise["FIT_INVERSE"]:
        mu_a, mu_b = fa["FIT_INVERSE"]["latents/mu"], fb["FIT_INVERSE"]["latents/mu"]
        rel = float(np.abs(mu_b - mu_a).max() / np.abs(mu_a).max())
        print(f"FIT_INVERSE final latents run B vs A: max |diff| / max |A| {rel:.3g}")
        check(rel <= CLI_INVERSE_BAR, f"FIT_INVERSE final latents differ by {rel:.3g}")
    # run B's rows after the relaunch against run A's rows of the same task
    # and epoch: every FIT_DECODER row after the killed epoch, every later row
    def key(r):
        return r["step"], tuple(sorted(r))

    after = [r for r in rows_b[events[0] + 1:] if "event" not in r]
    want = {key(r): r for r in rows_a
            if "fit_decoder_loss" not in r or r["step"] > killed}
    exact = sum(want.get(key(r)) == r for r in after)
    print(f"run B's {len(after)} rows after the relaunch against run A's {len(want)} rows of "
          f"the same epochs: {exact} equal exactly")
    check(sorted(map(key, after)) == sorted(want), "run B's rows after the relaunch are not "
                                                   "those of run A's epochs after the kill")
    for r in after:
        a = want[key(r)]
        if r == a:
            continue
        check("fit_inverse_loss" in r and not bitwise["FIT_INVERSE"],
              f"run B row {r} is not run A's {a}")
        for k in r:
            check(abs(r[k] - a[k]) <= CLI_INVERSE_BAR * max(abs(a[k]), 1e-30),
                  f"run B row {r} vs run A's {a}")
    print(f"cli_run phase wall {time.perf_counter() - t0:.1f} s: run A {wall_a:.1f} s, "
          f"run B (both processes) {wall_b:.1f} s")
    return {"siren_step@cli_run": n["siren_step"], "siren_bwd@cli_run": n["siren_bwd"],
            "siren_bwd_fwd_passes@cli_run": n["fwd_passes"], "siren_fwd@cli_run": n["siren_fwd"]}


def training_maps(device, train, entry: str = CBC) -> tuple[torch.Tensor, dict]:
    """(a Zoo entry's 1,000 training latents mu, {resolution: the seed-1
    training maps (1000, P, 3) on the card} at FIT_DECODER's stages)."""
    mu = training_latents(entry, device)
    maps = {res: train.images_at(res, device=device)
            for res, _ in decoder_task_config().resolution_stages()}
    return mu, maps


def decoder_task_config():
    from reni_tpu_torch.train.optim import OptimConfig
    from reni_tpu_torch.train.tasks import TaskConfig

    return TaskConfig(
        task="FIT_DECODER",
        optim=OptimConfig(lr_start=1e-5, lr_end=1e-7, optimizer="adam", beta1=0.0, beta2=0.9),
        batch_size=DEC_BATCH, epochs=DEC_EPOCHS, multi_res_training=True,
        initial_resolution=FIT_RES[0], final_resolution=FIT_RES[1], curriculum=DEC_CURRICULUM,
        kld_weighting=1e-4,
    )


def step_operands(cfg, dec, Z, D, targets, sineweight, masked_row: bool = False):
    """The step kernel's operands: the packed trunk operands, the targets and
    pixel weights padded to 8 lanes, the (B, 1, 8) batch mask."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    bm = torch.ones((Z.shape[0], 1, 8), device=Z.device)
    if masked_row:
        bm[-1] = 0.0
    return (*packed(cfg, dec, Z, D), tk._pad_last(targets, 8), tk._pad_last(sineweight, 8), bm)


def step_kwargs(cfg, npix: int, trunk=None, act="tanh") -> dict:
    kw = dict(trunk=trunk or cfg.pallas_trunk, fast_sine=cfg.fast_sine, out_act=act,
              gscale=1.0 / (npix * cfg.out_features))
    if not cfg.is_film:
        kw.update(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0)
    return kw


def step_fns(cfg):
    """(kernel wrapper, plain version) of the train step of a conditioning."""
    from reni_tpu_torch.kernels import siren_step as ts

    if cfg.is_film:
        return ts.film_step_cuda, ts.film_step_reference
    return ts.siren_step_cuda, ts.siren_step_reference


def compare_step(cfg, ops, kw) -> tuple[float, float]:
    """Step kernel vs plain version: the loss and every gradient, and two
    kernel calls bit for bit; returns the largest max |difference| and the
    largest max |difference| / max |plain| over the gradients."""
    kernel, plain = step_fns(cfg)
    got, again = kernel(*ops, **kw), kernel(*ops, **kw)
    ref = plain(*ops, **kw)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(got, again)):
        check(torch.equal(x, y), f"result {i} differs between two calls on the same inputs")
    loss, loss_ref = got[0].sum().item() * kw["gscale"], ref[0].sum().item() * kw["gscale"]
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    check(loss_rel <= STEP_LOSS_BAR[kw["trunk"]],
          f"loss {loss:.8g} vs plain {loss_ref:.8g}: relative {loss_rel:.3g}")
    bar = BWD_BAR[kw["trunk"]]
    worst, worst_rel, report = 0.0, 0.0, []
    for i, (x, y) in enumerate(zip(got[1:], ref[1:])):
        check(tuple(x.shape) == tuple(y.shape), f"gradient {i} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"gradient {i} has non-finite values")
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        report.append(f"{err / scale:.2g}")
        check(err <= bar * scale, f"gradient {i}: max |diff| {err:.3g} > {bar} x {scale:.3g}")
    print(f"  loss {loss:.6g} (relative error {loss_rel:.2g}); max |diff| / max |plain| per "
          f"gradient: {' '.join(report)} (bar {bar}); two calls bitwise equal")
    return worst, worst_rel


def compare_step_phase(name, cfg, dec, mu, maps, device) -> tuple[list, list]:
    """The compare_step cases of the step kernel ``name`` (siren_step or
    film_step); returns the absolute and relative errors."""
    from reni_tpu_torch.core import sphere

    Z = mu[:DEC_BATCH]
    stages = [res for res, _ in decoder_task_config().resolution_stages()]
    mid = stages[1]
    cases = [(res, f"{res[0]}x{res[1]} shared grid", {}) for res in (stages[2], stages[0], mid)]
    cases += [
        (mid, "per-image grids", dict(per_image=True)),
        (mid, "a masked row", dict(masked_row=True)),
        (mid, "float32 trunk", dict(trunk="float32")),
        (mid, "exp output", dict(act="exp")),
        (mid, "no output activation", dict(act=None)),
    ]
    errs, rels = [], []
    with torch.no_grad():
        for res, label, opt in cases:
            D = sphere.get_directions(res[1], device=device)
            if opt.get("per_image"):
                D = per_image_grids(D, Z.shape[0], seed=4)
            # targets: the maps of the next 100 latents, so the residual is not zero
            ops = step_operands(cfg, dec, Z, D, maps[res][DEC_BATCH:2 * DEC_BATCH],
                                sphere.get_sineweight(res[1], device=device),
                                masked_row=opt.get("masked_row", False))
            kw = step_kwargs(cfg, D.shape[1], opt.get("trunk"), opt.get("act", "tanh"))
            print(f"{name} B={Z.shape[0]} P={D.shape[1]} {label}:")
            err, rel = compare_step(cfg, ops, kw)
            errs.append(err)
            rels.append(rel)
    return errs, rels


def compare_plan_passes(label, plan, ops, kw, device) -> tuple[list, list]:
    """Each pass kernel of ``plan`` (a step's or a backward's) against its
    plain pass: the plain chain up to a pass feeds both, and every output the
    pass writes (scratch rows, slot columns) is held to 1e-2 x max |plain|.
    Returns the absolute and relative errors."""
    from reni_tpu_torch.kernels import siren_step as ts

    check(ts.pass_route(kw["trunk"], plan.hidden, plan.n_mm), f"{label}: not on the pass route")
    ref = ts.PassWork.for_plan(plan, kw["trunk"], device)
    prep = ts.pass_operands(plan, ops, kw)
    errs, rels = [], []
    with torch.no_grad():
        for k, (kind, j) in enumerate(plan.passes):
            got = ref.clone()
            ts.step_pass_cuda(plan, k, ops, kw, got, prep)
            ts.step_pass_reference(plan, k, ops, kw, ref)
            torch.cuda.synchronize()
            outs, report = ts.pass_outputs(plan, k, got), []
            for key, y in ts.pass_outputs(plan, k, ref).items():
                x, y = outs[key].float(), y.float()
                check(bool(torch.isfinite(x).all()), f"{label} pass {kind} {j}: non-finite {key}")
                err, scale = (x - y).abs().max().item(), y.abs().max().item()
                check(err <= BWD_BAR["bfloat16"] * scale,
                      f"{label} pass {kind} {j} {key}: max |diff| {err:.3g} > 1e-2 x {scale:.3g}")
                rel = err / scale if scale else 0.0  # a backward's mse slot holds zeros
                errs.append(err)
                rels.append(rel)
                report.append(f"{key} {rel:.2g}")
            print(f"  {label} pass {k} ({kind} {j}) vs its plain pass, max |diff| / max |plain|: "
                  f"{', '.join(report)}")
            del got
    del ref, prep
    torch.cuda.empty_cache()
    return errs, rels


def compare_passes(name, cfg, dec, mu, maps, device) -> tuple[list, list]:
    """Each pass kernel of the step ``name`` against its plain pass at the
    flagship shape (100 training latents x 8,192 directions, the next 100
    maps as targets). Returns the absolute and relative errors."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_step as ts

    res = FIT_RES[1]
    D = sphere.get_directions(res[1], device=device)
    ops = step_operands(cfg, dec, mu[:DEC_BATCH], D, maps[res][DEC_BATCH:2 * DEC_BATCH],
                        sphere.get_sineweight(res[1], device=device))
    kw = step_kwargs(cfg, D.shape[1])
    return compare_plan_passes(name, ts.step_plan_cuda(cfg.is_film, ops, device), ops, kw, device)


def bwd_plan(cfg, dec, Z, device, weight_grads: bool):
    """(plan, operands with the cotangent, keyword arguments) of the backward
    at FIT_LATENT's last stage (21 x 8,192)."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_step as ts

    D = sphere.get_directions(FIT_RES[1][1], device=device)
    ops = (*packed(cfg, dec, Z, D), cotangent(Z, D.shape[1], seed=8))
    kw = bwd_fns(cfg, weight_grads=weight_grads)[2]
    plan = ts.step_plan_cuda(cfg.is_film, ops, device, bwd=True, weight_grads=weight_grads)
    return plan, ops, kw


def compare_bwd_passes(name, cfg, dec, Z, device) -> tuple[list, list]:
    """Each pass kernel of the backward ``name`` against its plain pass at 21
    x 8,192, with and without weight gradients."""
    errs, rels = [], []
    for weight_grads in (False, True):
        plan, ops, kw = bwd_plan(cfg, dec, Z, device, weight_grads)
        e, r = compare_plan_passes(f"{name} ({'with' if weight_grads else 'no'} weight gradients)",
                                   plan, ops, kw, device)
        errs += e
        rels += r
    return errs, rels


def compare_handoff(name, cfg, dec, Z, device) -> tuple[list, list]:
    """The differentiable trunk's route on the card at FIT_LATENT's stages
    (21 x 512, 2,048 and 8,192), with and without weight gradients: the
    forward as the passes (the fwd passes and the output last pass) against
    the plain forward at the forward's bars, then the backward from their
    scratch against the plain backward at 1e-2 x max |plain| per result.
    Returns the backward's absolute and relative errors."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    errs, rels = [], []
    _, plain_bwd, _ = bwd_fns(cfg)
    plain_fwd = tk.film_trunk_reference if cfg.is_film else tk.siren_trunk_reference
    for (h, w), _ in fit_task_config(False).resolution_stages():
        D = sphere.get_directions(w, device=device)
        ops, g = packed(cfg, dec, Z, D), cotangent(Z, D.shape[1], seed=12)
        for weight_grads in (False, True):
            kw = bwd_fns(cfg, weight_grads=weight_grads)[2]
            fkw = {k: v for k, v in kw.items() if k != "weight_grads"}
            with torch.no_grad():
                out, handed = ts.passes_forward(cfg.is_film, ops, fkw, weight_grads)
                got = ts.passes_bwd_handoff(handed, g)
                ref_out, ref = plain_fwd(*ops, **fkw), plain_bwd(*ops, g, **kw)
            torch.cuda.synchronize()
            err = (out - ref_out).abs()
            label = (f"{name} handoff B={Z.shape[0]} P={D.shape[1]} "
                     f"({'with' if weight_grads else 'no'} weight gradients)")
            check(err.max().item() < MAX_ERR and err.mean().item() < MEAN_ERR,
                  f"{label}: the passes' forward off the bf16 bar")
            worst, report = 0.0, []
            for i, (x, y) in enumerate(zip(got, ref)):
                if y is None:
                    check(x is None, f"{label}: result {i} computed without weight gradients")
                    continue
                e, scale = (x - y).abs().max().item(), y.abs().max().item()
                check(e <= BWD_BAR["bfloat16"] * scale, f"{label}: result {i} {e:.3g} > 1e-2 x "
                      f"{scale:.3g}")
                errs.append(e)
                rels.append(e / scale)
                report.append(f"{e / scale:.2g}")
            print(f"{label}: forward max abs err {err.max().item():.3g}, mean "
                  f"{err.mean().item():.3g}; backward max |diff| / max |plain| per result: "
                  f"{' '.join(report)}")
    return errs, rels


def time_plan_passes(label, plan, ops, kw, device, runs: int = 10) -> tuple[dict, float]:
    """The passes of ``plan`` timed alone, each with its bytes, FLOPs and
    achieved rates, and (with weight gradients) the weight-gradient product
    alone, then the design's byte floor (printed); returns ({pass: ms}, dWs
    ms or 0)."""
    from reni_tpu_torch.kernels import anatomy as ta
    from reni_tpu_torch.kernels import siren_step as ts

    work = ts.PassWork.for_plan(plan, kw["trunk"], device)
    prep = ts.pass_operands(plan, ops, kw)  # cast and transposed once, as a call does
    for k in range(len(plan.passes)):  # the scratch each pass reads
        ts.step_pass_cuda(plan, k, ops, kw, work, prep)
    passes, total = {}, 0
    for k, (kind, j) in enumerate(plan.passes):
        ms = time_ms(lambda: ts.step_pass_cuda(plan, k, ops, kw, work, prep), runs=runs, warmup=1)
        flops, nbytes = plan.pass_cost(k)
        total += nbytes
        passes[f"{kind}{j}"] = ms
        print(f"  {label} pass {kind} {j}: {ms:.4f} ms, {nbytes:.4g} B, {flops:.4g} FLOP -> "
              f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    wgrad_ms = 0.0
    if plan.weight_grads:
        wgrad_ms = time_ms(lambda: ta.weight_grads_cuda(work.sc_h, work.sc_dz), runs=5, warmup=1)
        flops, nbytes = plan.wgrad_cost()
        total += nbytes
        print(f"  {label} dWs (wgrad_bf16 + its sum): {wgrad_ms:.4f} ms, {nbytes:.4g} B, "
              f"{flops:.4g} FLOP -> {nbytes / (wgrad_ms * 1e-3) / 1e12:.3f} TB/s, "
              f"{flops / (wgrad_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    del work, prep
    torch.cuda.empty_cache()
    print(f"  {label}: the design's byte floor {total:.4g} B ({total / plan.rows:.0f} per row) -> "
          f"{total / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12:.2f} TB/s; sum of the passes"
          f"{' and dWs' if plan.weight_grads else ''} {sum(passes.values()) + wgrad_ms:.4f} ms")
    return passes, wgrad_ms


def pass_timings(name, cfg, ops, kw, device) -> dict:
    """The passes of one step timed alone at the step's shape
    (``time_plan_passes``); and, as a yardstick only (the port never calls
    it), torch.matmul of the same rows x H x H bf16 product. Returns the
    numbers for the kernels line."""
    from reni_tpu_torch.kernels import siren_step as ts

    plan = ts.step_plan_cuda(cfg.is_film, ops, device)
    passes, wgrad_ms = time_plan_passes(name, plan, ops, kw, device)
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn((plan.rows, plan.hidden), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((plan.hidden, plan.hidden), generator=gen, device=device).to(torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(x, w), runs=10)
    mm_bytes = 2 * (2 * x.numel() + w.numel())
    print(f"  yardstick (not called by the port): torch.matmul {plan.rows} x {plan.hidden} x "
          f"{plan.hidden} bf16 {mm_ms:.4f} ms -> {mm_bytes / (mm_ms * 1e-3) / 1e12:.3f} TB/s")
    del x, w
    return {"passes_ms": passes, "wgrad_ms": wgrad_ms, "matmul_yardstick_ms": mm_ms}


def bwd_pass_timings(name, cfg, dec, Z, device) -> dict:
    """Each pass of the backward timed alone at 21 x 8,192, without and with
    weight gradients (the design's byte floor printed); returns the times for
    the kernels line."""
    out = {}
    for weight_grads in (False, True):
        plan, ops, kw = bwd_plan(cfg, dec, Z, device, weight_grads)
        tag = "wgrad" if weight_grads else "no_wgrad"
        passes, wgrad_ms = time_plan_passes(f"{name} 21 x 8,192 ({tag})", plan, ops, kw, device,
                                            runs=25)
        out[f"passes_ms_21x8192_{tag}"] = passes
        if weight_grads:
            out["wgrad_ms_21x8192"] = wgrad_ms
    return out


def step_peak_memory(kernel, ops, kw) -> float:
    """Peak device memory (GB) while one step runs, its operands included."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel(*ops, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory of one step: {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB "
          f"above its operands)")
    return peak / 1e9


@contextlib.contextmanager
def plain_step():
    """Route fused_step_mse and fused_film_step_mse through the plain steps on
    the card: the yardstick a FIT_DECODER run through a kernel is held against."""
    from reni_tpu_torch.kernels import siren_step as ts

    saved = ts.StepMSE.steps
    ts.StepMSE.steps = {film: (plain, plain) for film, (plain, _) in saved.items()}
    try:
        yield
    finally:
        ts.StepMSE.steps = saved


def kernel_counters(cfg) -> dict:
    """The wrappers whose ``.launches`` a FIT_DECODER run of this conditioning
    is read from: its step, forward and backward kernels."""
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk

    if cfg.is_film:
        return {"step": step_fns(cfg)[0], "fwd": tk.fused_film_apply,
                "bwd": tb.film_trunk_bwd_cuda}
    return {"step": step_fns(cfg)[0], "fwd": tk.fused_apply, "bwd": tb.siren_trunk_bwd_cuda}


def sync_watched(step, hits: list, warmup: int = SYNC_WARMUP):
    """``step`` with torch.cuda.set_sync_debug_mode("error") around each
    call after the first ``warmup``: a call that synchronises the host with
    the card raises there, and is appended to ``hits`` as (message, the
    innermost frames of the package and this script that made it) before the
    error goes on."""
    calls = [0]

    def run(state, batch):
        calls[0] += 1
        if calls[0] <= warmup:
            return step(state, batch)
        with warnings.catch_warnings():  # the mode's one-time notice that it is a prototype
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("error")
        try:
            return step(state, batch)
        except RuntimeError as e:
            frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                      for f in traceback.extract_tb(e.__traceback__)
                      if "reni_tpu_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
            hits.append((str(e).splitlines()[0], frames[-4:]))
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return run


def fit_decoder(device, entry: str, *, plain: bool, train, sync_hits: list | None = None):
    """One FIT_DECODER run of a fresh student of ``entry``'s configuration on
    the dataset ``train`` (its ``images_at`` handed to ``fit_task``), through
    the step kernel or (``plain``) its plain version; returns (trained
    params, model, per-stage step times in ms, metrics, launches {step, fwd,
    bwd} during the run). With ``sync_hits`` the final stage's steps after
    warm-up are ``sync_watched`` into it."""
    import functools

    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    model = RENIModel(ckpt.load_model_config(os.path.join(entry, "checkpoint")))
    params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
    task = decoder_task_config()
    events: dict = {}

    counters = kernel_counters(model.config)
    per_stage: dict = {}

    def timed_step(model, directions, sineweight, res):
        step = tasks.make_fit_decoder_step(model, directions, sineweight,
                                           kld_weighting=task.kld_weighting)
        if sync_hits is not None and res == FIT_RES[1]:
            step = sync_watched(step, sync_hits)
        return counted(timed(step, events.setdefault(res, [])), counters,
                       per_stage.setdefault(res, {}))

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with plain_step() if plain else contextlib.nullcontext():
        trained, metrics = tasks.fit_task(
            model, params, task, functools.partial(train.images_at, device=device),
            torch.Generator().manual_seed(1),
            step_builder=timed_step,
        )
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    return trained, model, median_ms(events), metrics, launches, per_stage


def fit_decoder_phase(device, train, entry: str = CBC) -> int:
    """FIT_DECODER of a student of ``entry``'s configuration on the seed-1
    training maps ``train`` through its step kernel and through the plain
    version; returns the step kernel's launches in the kernel run."""
    import tempfile

    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.params import to_numpy
    from reni_tpu_torch.train import checkpoint as ckpt

    task = decoder_task_config()
    stages = task.resolution_stages()
    steps = DEC_EPOCHS * (DEC_MAPS // DEC_BATCH)
    target = train.images_at(FIT_RES[1], device=device)
    D = sphere.get_directions(FIT_RES[1][1], device=device)
    result, launched, final_ms = {}, 0, 0.0
    for plain in (False, True):
        run = "plain" if plain else "kernel"
        t0 = time.perf_counter()
        hits = None if plain else []
        try:
            trained, model, ms, metrics, n, by_stage = fit_decoder(device, entry, plain=plain,
                                                                  train=train, sync_hits=hits)
        except RuntimeError:
            if not hits:
                raise
            msg, frames = hits[0]
            raise SmokeFailure(f"FIT_DECODER [{run}]: a timed step synchronised the host with the "
                               f"card: {msg!r} at {' <- '.join(reversed(frames))}")
        wall = time.perf_counter() - t0
        tag = f"FIT_DECODER {model.config.conditioning} [{run}]"
        if hits is not None:
            watched = (DEC_EPOCHS - DEC_CURRICULUM[-1]) * (DEC_MAPS // DEC_BATCH) - SYNC_WARMUP
            print(f"{tag} sync check: {watched} timed {FIT_RES[1][0]}x{FIT_RES[1][1]} steps "
                  f"after {SYNC_WARMUP} of warm-up under torch.cuda.set_sync_debug_mode('error'): "
                  f"no synchronising call")
        if plain:
            check(n == {"step": 0, "fwd": 0, "bwd": 0}, f"the plain run launched kernels {n}")
        else:
            check(n == {"step": steps, "fwd": 0, "bwd": 0},
                  f"{n} launches in {steps} steps (the step kernel once per step, no other)")
            launched, final_ms = n["step"], ms[FIT_RES[1]]
        loss = metrics["fit_decoder_loss"]
        check(bool(np.isfinite(loss).all()), f"{tag} non-finite loss")
        off = 0
        for (res, n_ep), (_, t) in zip(stages, sorted(ms.items())):
            first, last = loss[off], loss[off + n_ep - 1]
            print(f"{tag} stage {res[0]}x{res[1]}: {t:.3f} ms/step (median), "
                  f"epoch loss {first:.6g} -> {last:.6g}, launches {by_stage.get(res, {})}")
            check(last < first, f"{tag} stage {res}: loss {first} -> {last} did not fall")
            off += n_ep
        with torch.no_grad():
            mu = trained["latents"]["mu"]
            decoded = torch.cat([model.apply(trained, z, D) for z in mu.split(DEC_BATCH)])
        check(bool(torch.isfinite(decoded).all()), f"{tag} non-finite decodes")
        result[plain] = psnr(decoded, target)
        print(f"{tag} {steps} steps in {wall:.1f} s, launches {n}; PSNR of the "
              f"student's {FIT_RES[1][0]}x{FIT_RES[1][1]} decodes {result[plain]:.3f} dB")
        if not plain:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "fit_decoder_final")
                ckpt.save_fit_result(path, trained, model_config=model.config,
                                     task="FIT_DECODER", metrics=metrics)
                back, meta = ckpt.load_checkpoint(path)
                check(ckpt.load_model_config(path) == model.config and meta["epoch"] == DEC_EPOCHS,
                      f"checkpoint metadata {meta}")
                flat, want = ckpt._flatten(back), ckpt._flatten(to_numpy(trained))
                check(flat.keys() == want.keys()
                      and all(np.array_equal(flat[k], want[k]) for k in want),
                      "the trained params do not round-trip through the checkpoint")
            print(f"{tag} checkpoint round trip: {len(want)} leaves equal")
    gap = result[False] - result[True]
    print(f"FIT_DECODER {model.config.conditioning}: PSNR kernel - plain {gap:+.3f} dB")
    check(abs(gap) <= PSNR_BAR_DB, f"PSNR kernel vs plain differ by {gap:.3f} dB")
    print(f"flagship FIT_DECODER {model.config.conditioning} step (batch {DEC_BATCH} at "
          f"{FIT_RES[1][0]}x{FIT_RES[1][1]} = {DEC_BATCH * D.shape[1]:,} directions, optimizer "
          f"included): {final_ms:.3f} ms -> "
          f"{DEC_BATCH * D.shape[1] / (final_ms * 1e-3):.4g} directions/s")
    return launched


def step_bytes(ops, k: int, n_out: int, film: bool, trunk: str) -> int:
    """The step's inputs (the trunk's, the targets' and pixel weights' real
    channels, the mask) and outputs (loss partials, per-image and weight
    gradients in float32)."""
    n_trunk = 8 if film else 7  # trunk operands before tgt, sw, bm
    trunk_ops = ops[:n_trunk]
    a = trunk_ops[1]
    B, P, H = a.shape[0], ops[0].shape[1], a.shape[-1]
    n = min_bytes(trunk_ops, k, n_out, film, trunk)
    n += 4 * (B * P * n_out + P * n_out + B)
    if film:
        _, _, ws, bs, _, _, fr, ph = trunk_ops
        per_image = fr.numel() + ph.numel()
    else:
        _, _, b0, ws, bs, _, _ = trunk_ops
        per_image = b0.numel()
    n += 4 * (n_out + B * k * H + per_image + ws.numel() + bs.numel() + H * n_out + n_out)
    return n


def time_step(name, cfg, dec, mu, maps, device, replaces, launches, errors, rel_errors) -> dict:
    """The step kernel ``name`` (siren_step or film_step), its plain version
    and the forward + backward kernels with weight gradients at 64 x 128,
    batches 100 and 21; returns the kernels-line row (batch 100, the flagship
    shape)."""
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.kernels import siren_fwd as tk

    res = FIT_RES[1]
    D = sphere.get_directions(res[1], device=device)
    sw = sphere.get_sineweight(res[1], device=device)
    k, n_out, P = encodings.d_features(cfg.equivariance, D).shape[-1], cfg.out_features, D.shape[1]
    kernel, plain = step_fns(cfg)
    fwd = tk.film_trunk_cuda if cfg.is_film else tk.siren_trunk_cuda
    bwd, _, bwd_kw = bwd_fns(cfg, weight_grads=True)
    fwd_kw = {x: v for x, v in bwd_kw.items() if x != "weight_grads"}
    n_trunk = 8 if cfg.is_film else 7
    row = None
    for B in STEP_TIMED:
        ops = step_operands(cfg, dec, mu[:B], D, maps[res][DEC_BATCH:DEC_BATCH + B], sw)
        kw = step_kwargs(cfg, P)
        g = cotangent(mu[:B], P, seed=5)
        # forward + the backward without the forward again + the final layer
        flops = B * P * (bwd_flops(cfg, k, n_out, True) + 2.0 * n_out * cfg.hidden_features)
        bound_ms, bound_by = bound(flops, step_bytes(ops, k, n_out, cfg.is_film, kw["trunk"]))

        def two_kernels():
            fwd(*ops[:n_trunk], **fwd_kw)
            bwd(*ops[:n_trunk], g, **bwd_kw)

        ms = time_ms(lambda: kernel(*ops, **kw), runs=15)
        extra = {}
        if B == DEC_BATCH:
            extra = pass_timings(name, cfg, ops, kw, device)
            extra["peak_mem_gb"] = step_peak_memory(kernel, ops, kw)
        two_ms = time_ms(two_kernels, runs=10)
        plain_ms = time_ms(lambda: plain(*ops, **kw), runs=5, warmup=1)
        print(f"{name} B={B} P={P}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, forward + "
              f"backward kernels with weight gradients {two_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.4g} FLOP, {flops / (B * P):.0f} per pixel) -> "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        if row is None:
            row = {
                "name": name, "route": "cuda",
                "source": SOURCE_FILM_STEP if cfg.is_film else SOURCE_STEP,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(errors[name]), "max_rel_err": max(rel_errors[name]),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "two_kernel_ms": two_ms, **extra,
            }
    return row


# the probes that time_anatomy times, in the order of benchmarks/bwd_anatomy.py:
# (name, forward or backward, the variant's keyword arguments)
ANATOMY_VARIANTS = (
    ("fwd", "fwd", {}),
    ("fwd_no_sine", "fwd", dict(transcendental=False)),
    ("fwd_interleave2", "fwd", dict(interleave=2)),
    ("fwd_interleave4", "fwd", dict(interleave=4)),
    ("bwd", "bwd", {}),
    ("bwd_no_accum", "bwd", dict(accum=False)),
    ("bwd_no_sincos", "bwd", dict(transcendental=False)),
    ("bwd_no_dw", "bwd", dict(weight_grads=False)),
    ("bwd_mxu_only", "bwd", dict(transcendental=False, weight_grads=False)),
)
ANATOMY_VARIANTS_BY_NAME = {name: variant for name, _, variant in ANATOMY_VARIANTS}


def anatomy_operands(cfg, dec, Z, D):
    """(trunk operands, cotangent, keyword arguments) of the probes for a
    Cond-by-Concat decode."""
    kw = dict(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0, trunk=cfg.pallas_trunk,
              fast_sine=cfg.fast_sine)
    return packed(cfg, dec, Z, D), cotangent(Z, D.shape[1], seed=6), kw


def time_anatomy(cfg, dec, Z, D, runs: int) -> dict:
    """Median ms of every probe of ANATOMY_VARIANTS and of the weight-gradient
    product alone (on the scratch the backward without its reduction wrote:
    on the pass route the shipped backward's; with and without the sum of
    its split-K partials) at one shape, then the attribution line of the
    shipped backward (``attribution``): the path of ``time_kernels.py
    --anatomy``."""
    from reni_tpu_torch.kernels import anatomy as ta

    ops, g, kw = anatomy_operands(cfg, dec, Z, D)
    times = {}
    for name, side, variant in ANATOMY_VARIANTS:
        if side == "fwd":
            times[name] = time_ms(lambda: ta.fwd_variant_cuda(*ops, **variant, **kw), runs=runs)
        else:
            times[name] = time_ms(lambda: ta.bwd_variant_cuda(*ops, g, **variant, **kw), runs=runs)
    _, _, sc_h, sc_dz = ta.bwd_variant_cuda(*ops, g, accum=False, **kw)
    times["wgrad_bf16"] = time_ms(lambda: ta.weight_grads_cuda(sc_h, sc_dz, reduce=False),
                                  runs=runs)
    times["wgrad_bf16_and_sum"] = time_ms(lambda: ta.weight_grads_cuda(sc_h, sc_dz), runs=runs)
    del sc_h, sc_dz
    times["attribution"] = attribution(cfg, ops, times)
    return times


def byte_floor_ms(plan) -> float:
    """The passes' byte floor of a plan: the scratch each pass reads and
    writes once (``StepPlan.pass_cost``) and the weight-gradient product's
    (``wgrad_cost``), at PEAK_BYTES."""
    nbytes = sum(plan.pass_cost(k)[1] for k in range(len(plan.passes))) + plan.wgrad_cost()[1]
    return nbytes / PEAK_BYTES * 1e3


def attribution(cfg, ops, times: dict) -> dict:
    """The shipped backward's time at one shape split by its probes (printed
    as one line): sines = bwd - bwd_no_sincos, weight work = bwd -
    bwd_no_dw, the reduction after the passes = bwd - bwd_no_accum,
    wgrad_bf16 alone (and with its split-K sum), the product skeleton =
    bwd_mxu_only; beside the bound with and without weight gradients and,
    on the pass route, the passes' byte floor with and without them."""
    import dataclasses

    from reni_tpu_torch.core import encodings
    from reni_tpu_torch.kernels import anatomy as ta

    B, P, H = ops[1].shape[0], ops[0].shape[1], cfg.hidden_features
    k = encodings.d_features(cfg.equivariance, torch.zeros(1, 1, 3)).shape[-1]
    out = {
        "sines": times["bwd"] - times["bwd_no_sincos"],
        "weight_work": times["bwd"] - times["bwd_no_dw"],
        "reduction": times["bwd"] - times["bwd_no_accum"],
        "wgrad_bf16": times["wgrad_bf16"],
        "wgrad_bf16_and_sum": times["wgrad_bf16_and_sum"],
        "skeleton": times["bwd_mxu_only"],
    }
    for wgrad, tag in ((True, "with"), (False, "without")):
        out[f"bound_ms_{tag}"] = bound(B * P * bwd_flops(cfg, k, cfg.out_features, wgrad),
                                       bwd_bytes(ops, k, cfg.out_features, False,
                                                 cfg.pallas_trunk, wgrad))[0]
    route = ta.bwd_route(cfg.pallas_trunk, H, cfg.hidden_layers)
    floors = ""
    if route == "passes":
        sms = torch.cuda.get_device_properties(ops[0].device).multi_processor_count
        plan = ta.bwd_plan(ops[0], ops[1], ops[3], sms)
        out["floor_ms_with"] = byte_floor_ms(plan)
        out["floor_ms_without"] = byte_floor_ms(dataclasses.replace(plan, weight_grads=False))
        floors = (f"; the passes' byte floor {out['floor_ms_with']:.4f} ms with, "
                  f"{out['floor_ms_without']:.4f} without")
    print(f"attribution of the shipped backward ({route}) at {B} x {P:,}: bwd {times['bwd']:.4f} "
          f"ms = sines {out['sines']:.4f} | weight work {out['weight_work']:.4f} | reduction "
          f"after the passes {out['reduction']:.4f} (wgrad_bf16 alone {out['wgrad_bf16']:.4f}, "
          f"with its split-K sum {out['wgrad_bf16_and_sum']:.4f}) | skeleton (bwd_mxu_only) "
          f"{out['skeleton']:.4f}; bound {out['bound_ms_with']:.4f} ms with weight gradients, "
          f"{out['bound_ms_without']:.4f} without" + floors)
    return out


def compare_probe(label: str, got, ref, bar: float) -> tuple[float, float]:
    """Each result of a probe within bar x max |plain|; returns the largest
    max |difference| and the largest max |difference| / max |plain|."""
    worst, worst_rel, report = 0.0, 0.0, []
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            check(x is None, f"{label}: result {i} computed without weight gradients")
            continue
        x, y = x.float(), y.float()
        check(tuple(x.shape) == tuple(y.shape), f"{label}: result {i} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{label}: result {i} has non-finite values")
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        report.append(f"{err / scale:.2g}")
        check(err <= bar * scale, f"{label}: result {i} max |diff| {err:.3g} > {bar} x {scale:.3g}")
    print(f"{label}: max |diff| / max |plain| per result: {' '.join(report)} (bar {bar})")
    return worst, worst_rel


def anatomy_phase(cfg, dec, Z, device, errors, rel_errors, launches) -> dict:
    """Hold every probe against its plain version at 21 x 8,192 (the backward
    probes on the pass route in the passes' slot layout; ``bwd`` and
    ``bwd_no_dw`` bitwise equal to the shipped backward; every probe equal
    to itself over two calls), then drive the probe tool's path at 21 x 8,192
    and 21 x 32,768 with the launch and route counts zeroed before and read
    after; returns {probe name: ms} at 21 x 8,192 (the 21 x 32,768 times
    under "21x32768") and fills errors / launches for fwd_variant and
    bwd_variant."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import anatomy as ta
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    D = sphere.get_directions(ANATOMY_WIDTH, device=device)
    ops, g, kw = anatomy_operands(cfg, dec, Z, D)
    bar = BWD_BAR[kw["trunk"]]
    route = ta.bwd_route(kw["trunk"], cfg.hidden_features, cfg.hidden_layers)
    if route == "passes":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        layout = {"plan": ta.bwd_plan(ops[0], ops[1], ops[3], sms)}
    else:
        layout = {"grid": tb.launch_grid(D.shape[1], Z.shape[0], kw["trunk"], device)}
    print(f"backward probes at {Z.shape[0]} x {D.shape[1]:,}: built from the {route} "
          f"(the shipped backward's design), slot layout {layout}")
    for name in ("fwd_variant", "bwd_variant"):
        errors[name], rel_errors[name] = [], []
    fused = tk.fwd_route(kw["trunk"], cfg.hidden_features, cfg.hidden_layers) == "fused"
    with torch.no_grad():
        shipped = tk.siren_trunk_cuda(*ops, **kw)
        tile = tk.siren_trunk_cuda(*ops, route="tile", **kw)
        shipped_bwd = {wgrad: tb.siren_trunk_bwd_cuda(*ops, g, weight_grads=wgrad, **kw)
                       for wgrad in (True, False)}
        for name, side, variant in ANATOMY_VARIANTS:
            label = f"{name} B={Z.shape[0]} P={D.shape[1]}"
            if side == "fwd":
                got = ta.fwd_variant_cuda(*ops, **variant, **kw)
                ref = ta.fwd_variant_reference(*ops, **variant, **kw)
                if variant.get("transcendental", True):
                    # numerically the kernel it rearranges (on the fused route
                    # interleave 4 is the row-tile kernel's): its bits and the
                    # phase-2 bars
                    base = tile if fused and variant.get("interleave") == 4 else shipped
                    check(torch.equal(got, base), f"{name} differs from the kernel it rearranges")
                    err = (got - ref).abs()
                    check(err.max().item() < MAX_ERR and err.mean().item() < MEAN_ERR,
                          f"{name} off the bf16 bar")
                err, rel = compare_probe(label, [got], [ref], bar)
            else:
                got = [x if x is None else x.clone()
                       for x in ta.bwd_variant_cuda(*ops, g, **variant, **kw)]
                again = ta.bwd_variant_cuda(*ops, g, **variant, **kw)
                check(all((x is None and y is None) or torch.equal(x, y)
                          for x, y in zip(got, again)), f"{name} differs between two calls")
                del again
                if variant in ({}, {"weight_grads": False}):
                    base = shipped_bwd[variant.get("weight_grads", True)]
                    check(all((x is None and y is None) or torch.equal(x, y)
                              for x, y in zip(got, base)),
                          f"{name} is not bitwise the shipped backward (siren_trunk_bwd_cuda)")
                ref = list(ta.bwd_variant_reference(*ops, g, **layout, **variant, **kw))
                if not variant.get("accum", True):
                    # the scratch of activations is a forward result: the forward's bars
                    h_err = (got.pop(2).float() - ref.pop(2).float()).abs()
                    print(f"{label}: scratch h max abs err {h_err.max().item():.3g}, "
                          f"mean {h_err.mean().item():.3g}")
                    check(h_err.max().item() < MAX_ERR and h_err.mean().item() < MEAN_ERR,
                          f"{name}: the scratch of activations is off the bf16 bar")
                err, rel = compare_probe(label, got, ref, bar)
            errors[f"{side}_variant"].append(err)
            rel_errors[f"{side}_variant"].append(rel)
        _, _, sc_h, sc_dz = ta.bwd_variant_cuda(*ops, g, accum=False, **kw)
        dws, again = ta.weight_grads_cuda(sc_h, sc_dz), ta.weight_grads_cuda(sc_h, sc_dz)
        check(torch.equal(dws, again), "the weight-gradient product differs between two calls")
        if route == "passes":
            check(torch.equal(dws, shipped_bwd[True][2]),
                  "wgrad_bf16 on the bwd_no_accum scratch is not the shipped backward's dWs")
        compare_probe("wgrad_bf16 alone", [dws], [ta.weight_grads_reference(sc_h, sc_dz)], 1e-4)
        del sc_h, sc_dz, dws, again, got, ref, shipped_bwd
        torch.cuda.synchronize()
        ta.fwd_variant_cuda.launches = ta.bwd_variant_cuda.launches = 0
        ta.weight_grads_cuda.launches = 0
        ta.bwd_variant_cuda.routes = {"passes": 0, "chain": 0}
        ts.pass_launches.update({k: 0 for k in ts.pass_launches})
        times = time_anatomy(cfg, dec, Z, D, runs=ANATOMY_RUNS)
        torch.cuda.empty_cache()
        wide = sphere.get_directions(ANATOMY_WIDE, device=device)
        times[f"{Z.shape[0]}x{wide.shape[1]}"] = time_anatomy(cfg, dec, Z, wide, runs=ANATOMY_RUNS)
        torch.cuda.synchronize()
    launches["fwd_variant"] = ta.fwd_variant_cuda.launches
    launches["bwd_variant"] = ta.bwd_variant_cuda.launches
    routes, calls = dict(ta.bwd_variant_cuda.routes), dict(ts.pass_launches)
    print(f"probe launches on the probe tool's path: fwd_variant {launches['fwd_variant']}, "
          f"bwd_variant {launches['bwd_variant']} (by design {routes}), weight_grads "
          f"{ta.weight_grads_cuda.launches}; calls into the pass entries {calls}")
    for name in ("fwd_variant", "bwd_variant"):
        check(launches[name] > 0, f"{name} was never launched on the probe tool's path")
    check(ta.weight_grads_cuda.launches > 0, "the weight-gradient product was never launched")
    if route == "passes":
        check(routes["chain"] == 0 and calls["siren_step"] > 0 and calls["siren_anatomy"] > 0,
              "the backward probes did not run the passes of the step and anatomy libraries")
    for label, t in ((f"{Z.shape[0]} x {D.shape[1]:,}", times),
                     (f"{Z.shape[0]} x {wide.shape[1]:,}", times[f"{Z.shape[0]}x{wide.shape[1]}"])):
        print(f"anatomy ms at {label}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in t.items() if isinstance(v, float)))
    return times


def probe_row(name, side, variant, cfg, dec, Z, device, times, replaces, launches, errors,
              rel_errors) -> dict:
    """The kernels-line row of a probe kernel: the time of its variant
    ``variant`` (the one without sines: a function of its own) at 21 x 8,192
    beside its plain version and the bound of the products it still does;
    ``variants_ms`` holds every variant's time."""
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.kernels import anatomy as ta

    D = sphere.get_directions(ANATOMY_WIDTH, device=device)
    ops, g, kw = anatomy_operands(cfg, dec, Z, D)
    k, n_out, H = encodings.d_features(cfg.equivariance, D).shape[-1], cfg.out_features, cfg.hidden_features
    B, P = Z.shape[0], D.shape[1]
    opts = dict(ANATOMY_VARIANTS_BY_NAME[variant])
    with torch.no_grad():
        if side == "fwd":
            flops = 2.0 * B * P * (k * H + cfg.hidden_layers * H * H + H * n_out)
            nbytes = min_bytes(ops, k, n_out, False, kw["trunk"]) + B * P * n_out * 4
            plain_ms = time_ms(lambda: ta.fwd_variant_reference(*ops, **opts, **kw), runs=5)
        else:
            flops = B * P * bwd_flops(cfg, k, n_out, True)
            nbytes = bwd_bytes(ops, k, n_out, False, kw["trunk"], True)
            plain_ms = time_ms(lambda: ta.bwd_variant_reference(*ops, g, **opts, **kw), runs=5)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"{name} ({variant}) B={B} P={P}: kernel {times[variant]:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops:.4g} FLOP)")

    def variants(t):
        return {k: v for k, v in t.items() if isinstance(v, float) and (
            k.startswith(side) or (side == "bwd" and k.startswith("wgrad")))}

    wide = f"{B}x{ANATOMY_WIDE // 2 * ANATOMY_WIDE}"
    row = {
        "name": name, "route": "cuda", "source": SOURCE_ANATOMY, "replaces": replaces[name],
        "launches": launches[name], "max_abs_err": max(errors[name]),
        "max_rel_err": max(rel_errors[name]), "ms": times[variant], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "timed_variant": variant,
        "variants_ms": variants(times), f"variants_ms_{wide}": variants(times[wide]),
    }
    if side == "bwd":
        row["design"] = ta.bwd_route(kw["trunk"], H, cfg.hidden_layers)
        row["attribution"] = {f"{B}x{P}": times["attribution"],
                              wide: times[wide]["attribution"]}
    return row


L2_READ_MB, L2_READ_REPS = 16, 50  # a buffer that fits in L2, read over and over


def l2_read_rate(device) -> float:
    """L2's read rate on this card in TB/s: the L2 probe of kernels/anatomy.py
    (checked once against its plain version) reading L2_READ_MB MB
    L2_READ_REPS times."""
    from reni_tpu_torch.kernels import anatomy as ta

    gen = torch.Generator(device=device).manual_seed(11)
    buf = torch.randint(0, 256, (L2_READ_MB << 20,), dtype=torch.uint8, device=device,
                        generator=gen)
    check(torch.equal(ta.l2_read_cuda(buf, 3), ta.l2_read_reference(buf, 3)),
          "the L2 probe differs from its plain version")
    ms = time_ms(lambda: ta.l2_read_cuda(buf, L2_READ_REPS), runs=10)
    tbs = L2_READ_REPS * buf.numel() / (ms * 1e-3) / 1e12
    print(f"L2 read rate: {L2_READ_MB} MB read {L2_READ_REPS} times in {ms:.4f} ms -> "
          f"{tbs:.3f} TB/s")
    return tbs


def fwd_timing(name, cfg, dec, Z, device, l2_tbs: float) -> dict:
    """The forward kernel's kernels-line row: at 21 x 32,768 (serving) and
    21 x 8,192 the fused kernel and the row-tile kernel's instantiation for
    the same trunk in turns (fused, row-tile, row-tile, fused), the plain
    version, the bound, the weight bytes each design reads from L2 (every
    tile reads every hidden weight: 128-row tiles against 64-row ones) and
    the fused call's host time."""
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.kernels import siren_fwd as tk

    kernel, plain, kw = trunk_fns(cfg)
    B, H, n_out = Z.shape[0], cfg.hidden_features, cfg.out_features
    n_mm = cfg.hidden_layers - cfg.is_film
    row, shapes = None, {}
    for width in (WIDTH, FIT_RES[1][1]):
        D = sphere.get_directions(width, device=device)
        ops = packed(cfg, dec, Z, D)
        P, k = D.shape[1], encodings.d_features(cfg.equivariance, D).shape[-1]
        flops = 2.0 * B * P * (k * H + n_mm * H * H + H * n_out)
        nbytes = min_bytes(ops, k, n_out, cfg.is_film, cfg.pallas_trunk) + B * P * n_out * 4
        bound_ms, bound_by = bound(flops, nbytes)
        times = {"fused": [], "tile": []}
        for route in ("fused", "tile", "tile", "fused"):
            times[route].append(time_ms(lambda: kernel(*ops, route=route, **kw)))
        host_ms = host_time_ms(lambda: kernel(*ops, **kw))
        plain_ms = time_ms(lambda: plain(*ops, **kw), runs=5 if P > 8192 else 10)
        l2 = {route: B * math.ceil(P / rows) * n_mm * H * H * 2
              for route, rows in (("fused", tk.FUSED_TILE), ("tile", tk.tile_rows(H, cfg.pallas_trunk)))}
        ms = statistics.mean(times["fused"])
        print(f"{name} B={B} P={P}: fused kernel {times['fused'][0]:.4f} / {times['fused'][1]:.4f} "
              f"ms (host {host_ms:.4f} ms a call), row-tile kernel {times['tile'][0]:.4f} / "
              f"{times['tile'][1]:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.4g} FLOP, {nbytes:.4g} B) -> {flops / (ms * 1e-3) / 1e12:.1f} "
              f"TFLOP/s; weight bytes from L2 {l2['fused']:.4g} (fused; "
              f"{l2['fused'] / (l2_tbs * 1e12) * 1e3:.4f} ms at {l2_tbs:.3f} TB/s) against "
              f"{l2['tile']:.4g} (row-tile)")
        shapes[f"{B}x{P}"] = {"ms": ms, "fused_ms": times["fused"], "tile_ms": times["tile"],
                              "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "l2_weight_bytes": l2["fused"], "tile_l2_weight_bytes": l2["tile"]}
        if row is None:  # the serving shape
            row = {
                "name": name, "route": "cuda", "source": SOURCE_FUSED, "library": SOURCE,
                "kernel": f"fused_fwd<{'true' if cfg.is_film else 'false'}, ...> "
                          f"(row-tile kernel trunk_fwd: {SOURCE_TILE})",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "tile_ms": statistics.mean(times["tile"]), "host_ms": host_ms,
                "l2_read_tbs": l2_tbs,
            }
    row["shapes"] = shapes
    return row


def handoff_ab(cfg, dec, Z, device, rounds: int = 2) -> dict:
    """FIT_LATENT's trunk at its last stage (21 x 8,192, no weight
    gradients), forward and backward, both ways in turns: the forward kernel
    and a backward that runs the forward again as passes ("recompute"), and
    the forward as passes whose scratch the backward reads ("handoff", what
    the differentiable trunks do under the device-memory budget). Returns
    the median ms of each, over ``rounds`` timings in turns."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    D = sphere.get_directions(FIT_RES[1][1], device=device)
    ops, g = packed(cfg, dec, Z, D), cotangent(Z, D.shape[1], seed=11)
    bwd, _, kw = bwd_fns(cfg, weight_grads=False)
    fkw = {k: v for k, v in kw.items() if k != "weight_grads"}
    fwd = tk.film_trunk_cuda if cfg.is_film else tk.siren_trunk_cuda

    def recompute():
        fwd(*ops, **fkw)
        bwd(*ops, g, **kw)

    def handoff():
        _, handed = ts.passes_forward(cfg.is_film, ops, fkw, False)
        ts.passes_bwd_handoff(handed, g)

    times = {"recompute": [], "handoff": []}
    for _ in range(rounds):
        for name, fn in (("recompute", recompute), ("handoff", handoff)):
            times[name].append(time_ms(fn, runs=25))
    out = {k: statistics.median(v) for k, v in times.items()}
    print(f"handoff A/B at 21 x 8,192, forward + backward without weight gradients (in turns, "
          f"{rounds} x 25 runs): recompute {out['recompute']:.4f} ms, handoff "
          f"{out['handoff']:.4f} ms")
    return out


def bwd_flops(cfg, k: int, n_out: int, weight_grads: bool) -> float:
    """FLOP per pixel of a backward, counted without padding: the forward
    again without its final layer, g @ Wf^T, every dz @ W^T and d^T dz0, and
    with weight gradients h^T dz for each hidden product and h^T g."""
    H = cfg.hidden_features
    n_mm = cfg.hidden_layers - 1 if cfg.is_film else cfg.hidden_layers
    flops = 2 * (k * H + n_mm * H * H)  # forward again
    flops += 2 * n_out * H + 2 * n_mm * H * H + 2 * k * H  # g Wf^T, dz W^T, d^T dz0
    if weight_grads:
        flops += 2 * n_mm * H * H + 2 * H * n_out
    return float(flops)


def bwd_bytes(ops, k: int, n_out: int, film: bool, trunk: str, weight_grads: bool) -> int:
    """The backward's inputs (as for the forward, plus the cotangent's real
    channels) and outputs (per-image gradients, weight gradients in float32)."""
    B, P = ops[1].shape[0], ops[0].shape[1]
    H = ops[1].shape[-1]
    n = min_bytes(ops, k, n_out, film, trunk) + 4 * B * P * n_out
    if film:
        _, a, ws, bs, wf, bf, fr, ph = ops
        n += 4 * (B * k * H + fr.numel() + ph.numel())
    else:
        _, a, b0, ws, bs, wf, bf = ops
        n += 4 * (B * k * H + b0.numel())
    if weight_grads:
        n += 4 * (ws.numel() + bs.numel() + H * n_out + n_out)
    return n


def training_latents(entry: str, device) -> torch.Tensor:
    """A Zoo entry's 1,000 training latents mu."""
    from reni_tpu_torch.train import checkpoint as ckpt

    path = os.path.join(entry, "checkpoint")
    mu = torch.as_tensor(ckpt.load_checkpoint(path)[0]["latents"]["mu"], device=device)
    check(tuple(mu.shape) == (DEC_MAPS, 49, 3), f"training latents {tuple(mu.shape)}")
    return mu


def trunk_fns(cfg):
    """(kernel wrapper, plain version, keyword arguments) of a forward."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    kw = dict(trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine)
    if cfg.is_film:
        return tk.film_trunk_cuda, tk.film_trunk_reference, kw
    kw.update(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0)
    return tk.siren_trunk_cuda, tk.siren_trunk_reference, kw


FUSED_GRIDS = (7, 64, 131)  # persistent grids the fused kernel's bits are held across


def fused_bits(name, cfg, dec, Z, D) -> None:
    """The fused kernel at the serving shape: two calls, persistent grids of
    FUSED_GRIDS CTAs and the lock-step schedule give the same bits."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    ops = packed(cfg, dec, Z, D)
    kernel, _, kw = trunk_fns(cfg)
    first = kernel(*ops, **kw)
    check(torch.equal(first, kernel(*ops, **kw)), f"{name}: two fused calls differ")
    check(torch.equal(first, kernel(*ops, sched=tk.SCHED_LOCKSTEP, **kw)),
          f"{name}: the lock-step schedule changes the bits")
    sm_count = tk._sm_count
    try:
        for grid in FUSED_GRIDS:
            tk._sm_count = lambda device, grid=grid: grid
            check(torch.equal(first, kernel(*ops, **kw)),
                  f"{name}: a persistent grid of {grid} CTAs changes the bits")
    finally:
        tk._sm_count = sm_count
    torch.cuda.synchronize()
    print(f"{name} fused kernel at B={Z.shape[0]} P={D.shape[1]}: two calls, grids of "
          f"{', '.join(map(str, FUSED_GRIDS))} CTAs and lock step bitwise equal")


def wide_trunk(H: int, device, B: int = 21, P: int = 8192, L: int = 2, seed: int = 9):
    """Random Cond-by-Concat trunk operands of width ``H`` (SIREN-scaled, from
    a numpy generator): a width no Zoo entry has."""
    rng = np.random.default_rng(seed)

    def u(*shape, b):
        return torch.as_tensor(rng.uniform(-b, b, size=shape).astype(np.float32), device=device)

    d = torch.zeros(1, P, 8, device=device)
    d[..., :4] = u(1, P, 4, b=1.0)
    a = torch.zeros(B, 8, H, device=device)
    a[:, :4] = u(B, 4, H, b=0.5)
    wf = torch.zeros(H, 8, device=device)
    wf[:, :3] = u(H, 3, b=np.sqrt(6 / H) / 30)
    return (d, a, u(B, 1, H, b=0.1), u(L, H, H, b=np.sqrt(6 / H) / 30), u(L, H, b=0.05), wf,
            torch.zeros(1, 8, device=device))


def compare_wide(device, errors, rel_errors) -> None:
    """The forward at widths past the 64-row tile (WIDE) against its plain
    version at 21 x 8,192: the row-tile kernel, on its 32-row tile."""
    from reni_tpu_torch.kernels import siren_fwd as tk

    kw0 = dict(omega0=30.0, omega_h=30.0, fast_sine=True)
    for trunk, H in WIDE:
        ops = wide_trunk(H, device)
        kw = dict(kw0, trunk=trunk)
        check(tk.unsupported_reason(ops[0].shape[1], H, 21, trunk) is None,
              f"the forward declines H = {H} ({trunk})")
        tiles = tk.tile_fwd_launches
        with torch.no_grad():
            out, ref = tk.siren_trunk_cuda(*ops, **kw), tk.siren_trunk_reference(*ops, **kw)
        torch.cuda.synchronize()
        check(tk.tile_fwd_launches == tiles + 1, f"H = {H} ({trunk}) did not take the row-tile kernel")
        err = (out - ref).abs()
        mx, mean = err.max().item(), err.mean().item()
        print(f"siren_fwd H={H} {trunk} (a {tk.tile_rows(H, trunk)}-row tile) B=21 P=8192: "
              f"max abs err {mx:.3g}, mean {mean:.3g}")
        if trunk == "float32":
            check(mx < F32_MAX_ERR[True], f"H = {H} float32 forward off the float32 bar")
        else:
            check(mx < MAX_ERR and mean < MEAN_ERR, f"H = {H} bf16 forward off the bf16 bar")
        errors["siren_fwd"].append(mx)
        rel_errors["siren_fwd"].append(mx / ref.abs().max().item())


def forward_digest(entries, device) -> None:
    """Print the sha256 (16 hex digits) of the forward kernel's output bytes
    at the serving shape (21 x 32,768, shared grid) for each Zoo decoder:
    the fused kernel's bits, to compare two trees by."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk

    D = sphere.get_directions(WIDTH, device=device)
    out = {}
    with torch.no_grad():
        for name, (cfg, dec, Z) in entries.items():
            kernel, _, kw = trunk_fns(cfg)
            y = kernel(*packed(cfg, dec, Z, D), **kw)
            out[name] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"forward digest at 21 x {D.shape[1]:,} (serving shape): {out}")


def held_in_groups(label, plan, run, dws_at: int) -> None:
    """``run(budget)`` of ``plan`` under a third of its scratch against one
    call (``run(None)``): every result but dWs (at ``dws_at``) bitwise
    equal, dWs within 1e-2 x max |one call|."""
    budget = plan.scratch_bytes // 3
    groups = plan.groups(budget)
    check(len(groups) > 1, f"{label}: a third of the scratch still fits one group")
    with torch.no_grad():
        one = run(None)
        grouped = run(budget)
    torch.cuda.synchronize()
    rel = 0.0
    for i, (x, y) in enumerate(zip(one, grouped)):
        if x is None:
            check(y is None, f"{label}: result {i} computed in groups only")
        elif i == dws_at:
            rel = (x - y).abs().max().item() / x.abs().max().item()
            check(rel <= BWD_BAR["bfloat16"], f"{label}: grouped dWs off by {rel:.3g} x max")
        else:
            check(torch.equal(x, y), f"{label}: result {i} differs from one call")
    print(f"{label}: {len(groups)} groups of up to {groups[0][1] - groups[0][0]} images under a "
          f"budget of {budget / 1e9:.3f} GB (one call's scratch {plan.scratch_bytes / 1e9:.3f} "
          f"GB): every result but dWs bitwise equal to one call, dWs max |diff| / max {rel:.2g}")


def guard_phase(device, cases, mu_maps) -> dict:
    """The passes' device scratch under a forced budget (``held_in_groups``):
    each step at 100 x 8,192 and each backward at 21 x 32,768 with and
    without weight gradients; then one FIT_DECODER step of a fresh
    Cond-by-Concat student at GUARD_BATCH x 8,192 under the card's own
    budget. ``cases`` {name: (cfg, dec, test latents)}, ``mu_maps`` {name:
    (training latents, maps)}. Returns the big step's numbers."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    res = FIT_RES[1]
    D = sphere.get_directions(res[1], device=device)
    sw = sphere.get_sineweight(res[1], device=device)
    for name, (cfg, dec, Z) in cases.items():
        film = cfg.is_film
        mu, maps = mu_maps[name]
        ops = step_operands(cfg, dec, mu[:DEC_BATCH], D, maps[res][DEC_BATCH:2 * DEC_BATCH], sw)
        kw = step_kwargs(cfg, D.shape[1])
        held_in_groups(f"{'film' if film else 'siren'}_step B={DEC_BATCH} P={D.shape[1]}",
                       ts.step_plan_cuda(film, ops, device),
                       lambda budget: ts._passes_step(film, ops, kw, budget=budget),
                       2 if film else 3)
        wide = sphere.get_directions(WIDTH, device=device)
        tops = packed(cfg, dec, Z, wide)
        g = cotangent(Z, wide.shape[1], seed=10)
        for weight_grads in (False, True):
            kw = bwd_fns(cfg, weight_grads=weight_grads)[2]
            held_in_groups(
                f"{'film' if film else 'siren'}_bwd B={Z.shape[0]} P={wide.shape[1]} "
                f"({'with' if weight_grads else 'no'} weight gradients)",
                ts.step_plan_cuda(film, (*tops, g), device, bwd=True, weight_grads=weight_grads),
                lambda budget: ts._passes_bwd(film, tops, g, kw, weight_grads, budget=budget),
                1 if film else 2)
        del ops, tops, g
        torch.cuda.empty_cache()

    # one FIT_DECODER step at GUARD_BATCH x 8,192 under the card's own budget
    mu, maps = mu_maps["siren_fwd"]
    model = RENIModel(ckpt.load_model_config(os.path.join(CBC, "checkpoint")))
    check(model.fused_step_reason(GUARD_BATCH, D.shape[1]) is None,
          "the train-step kernel declines the guard's batch")
    params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
    state = tasks.init_train_state(model, params, decoder_task_config().optim,
                                   torch.Generator().manual_seed(1))
    step = tasks.make_fit_decoder_step(model, D, sw, kld_weighting=1e-4)
    batch = (maps[res][:GUARD_BATCH], torch.arange(GUARD_BATCH, device=device),
             torch.ones(GUARD_BATCH, device=device))
    cfg = model.config
    plan = ts.step_plan(False, GUARD_BATCH, D.shape[1], cfg.hidden_features, cfg.hidden_layers,
                        torch.cuda.get_device_properties(device).multi_processor_count)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    budget = ts.device_budget(device)
    seen, real = [], ts._work_and_groups  # the groups the step's call takes

    def spy(*args):
        work, groups = real(*args)
        seen.append(groups)
        return work, groups

    n0 = ts.siren_step_cuda.launches
    ts._work_and_groups = spy
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ts._work_and_groups = real
    check(len(seen) == 1, f"the guard's step ran the passes {len(seen)} times, not once")
    groups = seen[0]
    peak = torch.cuda.max_memory_allocated()
    loss = metrics["loss"].item()
    check(ts.siren_step_cuda.launches == n0 + 1, "the guard's step did not take the step kernel")
    check(np.isfinite(loss), f"the {GUARD_BATCH}-map step's loss is {loss}")
    print(f"FIT_DECODER step at {GUARD_BATCH} x {D.shape[1]:,}: loss {loss:.6g}, {wall * 1e3:.1f} "
          f"ms (first call), scratch of one call {plan.scratch_bytes / 1e9:.3f} GB (the card's "
          f"budget before the step {budget / 1e9:.3f} GB) -> {len(groups)} group(s) of up to "
          f"{groups[0][1] - groups[0][0]} images; peak device memory {peak / 1e9:.3f} GB")
    del state, batch, step, params
    torch.cuda.empty_cache()
    return {"guard_step_groups": len(groups), "guard_step_peak_gb": peak / 1e9,
            "guard_step_ms": wall * 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the plain versions are the float32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.serve import load_decoder

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    phase("build")
    build_all()

    phase("compare at full width and at FIT_LATENT's shapes")
    D = sphere.get_directions(WIDTH, device=dev)
    # the shared grids of FIT_LATENT's resolution stages (21 x 512, 2,048, 8,192)
    fit_grids = [(f"FIT_LATENT {h}x{w} shared grid", sphere.get_directions(w, device=dev))
                 for (h, w), _ in fit_task_config(False).resolution_stages()]
    errors = {"siren_fwd": [], "film_fwd": [], "siren_bwd": [], "film_bwd": []}
    rel_errors = {name: [] for name in errors}
    entries = {}
    maps_grid = sphere.get_directions(FIT_RES[1][1], device=dev)
    serve_grids = [(f"serving width {w}", sphere.get_directions(w, device=dev))
                   for w in SERVE_WIDTHS if w != WIDTH]
    for name, entry in (("siren_fwd", CBC), ("film_fwd", FILM)):
        cfg, dec, Z = load_entry(entry, dev)
        check(tuple(Z.shape) == (21, 49, 3), f"test latents {tuple(Z.shape)}")
        entries[name] = (cfg, dec, Z)
        mu100 = training_latents(entry, dev)[:DEC_BATCH]
        with torch.inference_mode():
            for label, grid, trunk, lat in (
                ("shared (1, P) grid", D, None, Z),
                ("per-image (B, P) grids", per_image_grids(D, Z.shape[0], seed=0), None, Z),
                ("float32 trunk, shared grid", D, "float32", Z),
                *((label, grid, None, Z) for label, grid in fit_grids + serve_grids),
                ("training latents, FIT_DECODER's 64x128 grid", maps_grid, None, mu100),
            ):
                routes = (tk.fused_fwd_launches, tk.tile_fwd_launches)
                mx, mean, scale = compare(cfg, dec, lat, grid, trunk)
                errors[name].append(mx)
                rel_errors[name].append(mx / scale)
                route = tk.fwd_route(trunk or cfg.pallas_trunk, cfg.hidden_features,
                                     cfg.hidden_layers - cfg.is_film)
                print(f"{name} {os.path.basename(entry)} B={lat.shape[0]} P={grid.shape[1]} "
                      f"{label} ({route} kernel): max abs err {mx:.3g}, mean {mean:.3g}")
                fused = route == "fused"
                check((tk.fused_fwd_launches, tk.tile_fwd_launches)
                      == (routes[0] + fused, routes[1] + (not fused)),
                      f"{name} {label} did not take the {route} kernel")
                if (trunk or cfg.pallas_trunk) == "float32":
                    bar = F32_MAX_ERR[cfg.fast_sine]
                    check(mx < bar, f"{name} {label} off the float32 bar {bar}")
                else:
                    check(mx < MAX_ERR and mean < MEAN_ERR, f"{name} {label} off the bf16 bar")
            fused_bits(name, cfg, dec, Z, D)
    compare_wide(dev, errors, rel_errors)
    forward_digest(entries, dev)

    phase("compare_bwd at full width and at FIT_LATENT's shapes")
    for fwd_name, name in (("siren_fwd", "siren_bwd"), ("film_fwd", "film_bwd")):
        cfg, dec, Z = entries[fwd_name]
        grids = per_image_grids(D, Z.shape[0], seed=1)
        with torch.no_grad():
            for label, grid, trunk, wgrad in (
                ("shared grid, weight gradients", D, None, True),
                ("shared grid, no weight gradients", D, None, False),
                ("per-image grids, weight gradients", grids, None, True),
                ("per-image grids, no weight gradients", grids, None, False),
                ("float32 trunk, shared grid, no weight gradients", D, "float32", False),
                ("float32 trunk, shared grid, weight gradients", D, "float32", True),
                *((f"float32 trunk, {fit_grids[-1][0]}, {'' if wgrad else 'no '}weight "
                   f"gradients", fit_grids[-1][1], "float32", wgrad) for wgrad in (False, True)),
                *((f"{label}, {'' if wgrad else 'no '}weight gradients", grid, None, wgrad)
                  for label, grid in fit_grids for wgrad in (False, True)),
            ):
                print(f"{name} B={Z.shape[0]} P={grid.shape[1]} {label}:")
                err, rel = compare_bwd(cfg, dec, Z, grid, trunk, wgrad, seed=2)
                errors[name].append(err)
                rel_errors[name].append(rel)
            for wgrad in (False, True):
                grid = fit_grids[1][1]
                print(f"{name} B={Z.shape[0]} P={grid.shape[1]} the trunk deepened to {DEEP_MM} "
                      f"products, {'' if wgrad else 'no '}weight gradients:")
                err, rel = compare_bwd(cfg, dec, Z, grid, None, wgrad, seed=2, n_mm=DEEP_MM)
                errors[name].append(err)
                rel_errors[name].append(rel)
        err, rel = compare_bwd_passes(name, cfg, dec, Z, dev)
        errors[name] += err
        rel_errors[name] += rel
        err, rel = compare_handoff(name, cfg, dec, Z, dev)
        errors[name] += err
        rel_errors[name] += rel

    phase("serve")
    # direct decodes to check the daemon against, made before the counts
    # are zeroed so they are not part of the served run
    expected = {}
    for name, entry in (("siren_fwd", CBC), ("film_fwd", FILM)):
        fn = load_decoder(os.path.join(entry, "checkpoint"), dev)
        lat = entries[name][2]
        exp = {"latents": lat.cpu().numpy()}
        for width in SERVE_WIDTHS:
            out = fn(lat, sphere.get_directions(width, device=dev)).cpu().numpy()
            exp[width] = out.reshape(21, width // 2, width, 3)
        expected[name] = exp
    torch.cuda.synchronize()
    tk.fused_apply.launches = 0
    tk.fused_film_apply.launches = 0
    tk.fused_fwd_launches = tk.tile_fwd_launches = 0
    serve_entry(CBC, expected["siren_fwd"], rotation_width=WIDTH, concurrent=True)
    serve_entry(FILM, expected["film_fwd"], rotation_width=WIDTH, concurrent=False)
    torch.cuda.synchronize()
    launches = {"siren_fwd": tk.fused_apply.launches, "film_fwd": tk.fused_film_apply.launches}
    routes = {"fused": tk.fused_fwd_launches, "tile": tk.tile_fwd_launches}
    print(f"launches during serving: {launches}; by route: {routes}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the serving path")
    check(routes == {"fused": sum(launches.values()), "tile": 0},
          "a served decode did not take the fused kernel")

    phase("fit_latent")
    launches.update(fit_latent_phase(dev))
    print(f"backward launches during FIT_LATENT (kernel runs): "
          f"{ {k: launches[k] for k in ('siren_bwd', 'film_bwd')} }; per stage "
          f"{ {k: v for k, v in launches.items() if '@' in k} }")

    phase("seed_maps")
    maps_dir = tempfile.TemporaryDirectory()
    train, test = seed_maps(dev, maps_dir.name)

    phase("fit_inverse")
    launches.update(fit_inverse_phase(dev, test, {k: entries[k] for k in ("siren_fwd", "film_fwd")}))

    phase("evaluate")
    launches.update(evaluate_phase(dev, maps_dir.name))

    phase("cli_run")
    launches.update(cli_run_phase(dev, maps_dir.name))
    maps_dir.cleanup()
    for name, tag in (("siren_bwd", "siren_bwd@fit_inverse"), ("film_bwd", "film_bwd@fit_inverse"),
                      ("siren_fwd", "siren_fwd@evaluate"), ("film_fwd", "film_fwd@evaluate"),
                      ("siren_bwd", "siren_bwd@cli_run"), ("siren_fwd", "siren_fwd@cli_run")):
        launches[name] += launches[tag]
    print(f"launches by kernel, all paths so far: "
          f"{ {k: launches[k] for k in ('siren_fwd', 'film_fwd', 'siren_bwd', 'film_bwd')} }")

    phase("compare_step at full width and at FIT_DECODER's shapes")
    cfg_cbc, dec_cbc, _ = entries["siren_fwd"]
    mu, maps = training_maps(dev, train)
    errors["siren_step"], rel_errors["siren_step"] = compare_step_phase(
        "siren_step", cfg_cbc, dec_cbc, mu, maps, dev)
    err, rel = compare_passes("siren_step", cfg_cbc, dec_cbc, mu, maps, dev)
    errors["siren_step"] += err
    rel_errors["siren_step"] += rel

    phase("fit_decoder")
    launches["siren_step"] = fit_decoder_phase(dev, train)
    print(f"step-kernel launches during FIT_DECODER (kernel run): {launches['siren_step']}")
    launches["siren_step"] += launches["siren_step@cli_run"]

    phase("compare_film_step at full width and at FIT_DECODER's shapes")
    cfg_film, dec_film, _ = entries["film_fwd"]
    mu_film, maps_film = training_maps(dev, train, FILM)
    errors["film_step"], rel_errors["film_step"] = compare_step_phase(
        "film_step", cfg_film, dec_film, mu_film, maps_film, dev)
    err, rel = compare_passes("film_step", cfg_film, dec_film, mu_film, maps_film, dev)
    errors["film_step"] += err
    rel_errors["film_step"] += rel

    phase("fit_decoder_film")
    launches["film_step"] = fit_decoder_phase(dev, train, FILM)
    print(f"FiLM step-kernel launches during FIT_DECODER (kernel run): {launches['film_step']}")

    phase("guard")
    torch.cuda.empty_cache()
    guard = guard_phase(dev, {k: entries[k] for k in ("siren_fwd", "film_fwd")},
                        {"siren_fwd": (mu, maps), "film_fwd": (mu_film, maps_film)})

    phase("anatomy")
    torch.cuda.empty_cache()
    anatomy_ms = anatomy_phase(cfg_cbc, dec_cbc, entries["siren_fwd"][2], dev, errors,
                               rel_errors, launches)

    phase("timings")
    rows = []
    replaces = {
        "siren_step": "reni_tpu/kernels/siren_pallas.py:980",
        "film_step": "reni_tpu/kernels/siren_pallas.py:1296",
        "fwd_variant": "benchmarks/bwd_anatomy.py:115",
        "bwd_variant": "benchmarks/bwd_anatomy.py:52",
        "siren_fwd": "reni_tpu/kernels/siren_pallas.py:140",
        "film_fwd": "reni_tpu/kernels/siren_pallas.py:201",
        "siren_bwd": "reni_tpu/kernels/siren_pallas.py:151",
        "film_bwd": "reni_tpu/kernels/siren_pallas.py:221",
    }
    fit_ms = {}
    with torch.inference_mode():
        l2_tbs = l2_read_rate(dev)
        for name in ("siren_fwd", "film_fwd"):
            cfg, dec, Z = entries[name]
            row = fwd_timing(name, cfg, dec, Z, dev, l2_tbs)
            fit_ms[name] = row["shapes"][f"21x{FIT_RES[1][0] * FIT_RES[1][1]}"]["ms"]
            row.update({"replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": max(errors[name]), "max_rel_err": max(rel_errors[name])})
            rows.append(row)
        for fwd_name, name in (("siren_fwd", "siren_bwd"), ("film_fwd", "film_bwd")):
            cfg, dec, Z = entries[fwd_name]
            row, shapes = None, {}
            for width in BWD_WIDTHS:
                grid = sphere.get_directions(width, device=dev)
                ops = packed(cfg, dec, Z, grid)
                g = cotangent(Z, grid.shape[1], seed=3)
                k = encodings.d_features(cfg.equivariance, grid).shape[-1]
                B, P = Z.shape[0], grid.shape[1]
                for wgrad in (False, True):
                    kernel, plain, kw = bwd_fns(cfg, weight_grads=wgrad)
                    flops = B * P * bwd_flops(cfg, k, cfg.out_features, wgrad)
                    nbytes = bwd_bytes(ops, k, cfg.out_features, cfg.is_film,
                                       cfg.pallas_trunk, wgrad)
                    bound_ms, bound_by = bound(flops, nbytes)
                    runs = 25 if P * B <= 21 * 8192 or not wgrad else 10
                    ms = time_ms(lambda: kernel(*ops, g, **kw), runs=runs)
                    host_ms = host_time_ms(lambda: kernel(*ops, g, **kw))
                    plain_ms = time_ms(lambda: plain(*ops, g, **kw), runs=runs)
                    print(f"{name} B={B} P={P} {'with' if wgrad else 'without'} weight "
                          f"gradients: kernel {ms:.4f} ms (host {host_ms:.4f} ms a call), "
                          f"plain {plain_ms:.4f} ms, bound "
                          f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} FLOP, {nbytes:.4g} B) "
                          f"-> {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
                    shapes[f"{B}x{P}{'_wgrad' if wgrad else ''}"] = {
                        "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
                    if row is None:  # 21 x 32,768 without weight gradients (FIT_LATENT's mode)
                        row = {
                            "name": name, "route": "cuda",
                            "source": SOURCE_FILM_STEP if cfg.is_film else SOURCE_STEP,
                            "chain_source": SOURCE_BWD,
                            "replaces": replaces[name], "launches": launches[name],
                            "max_abs_err": max(errors[name]),
                            "max_rel_err": max(rel_errors[name]),
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        }
            row["shapes"] = shapes
            row.update(bwd_pass_timings(name, cfg, dec, Z, dev))
            fwd_passes = sum(v for k, v in row["passes_ms_21x8192_no_wgrad"].items()
                             if k.startswith("fwd"))
            row["handoff_ab_ms"] = handoff_ab(cfg, dec, Z, dev)
            print(f"{name} at 21 x 8,192: the forward kernel {fit_ms[fwd_name]:.4f} ms; the "
                  f"backward without weight gradients "
                  f"{shapes[f'21x{FIT_RES[1][0] * FIT_RES[1][1]}']['ms']:.4f} ms, of which its "
                  f"forward passes {fwd_passes:.4f} ms")
            rows.append(row)
        rows.append(time_step("siren_step", cfg_cbc, dec_cbc, mu, maps, dev, replaces, launches,
                              errors, rel_errors))
        torch.cuda.empty_cache()
        rows.append(time_step("film_step", cfg_film, dec_film, mu_film, maps_film, dev, replaces,
                              launches, errors, rel_errors))
    z21 = entries["siren_fwd"][2]
    rows.append(probe_row("fwd_variant", "fwd", "fwd_no_sine", cfg_cbc, dec_cbc, z21, dev,
                          anatomy_ms, replaces, launches, errors, rel_errors))
    rows.append(probe_row("bwd_variant", "bwd", "bwd_no_sincos", cfg_cbc, dec_cbc, z21, dev,
                          anatomy_ms, replaces, launches, errors, rel_errors))
    for row in rows:  # launches per resolution stage, where a path counts them
        for key, tag in (("launches_by_stage", "@"), ("fwd_passes_by_stage", "_fwd_passes@")):
            by = {k.split("@")[1]: v for k, v in launches.items()
                  if k.startswith(row["name"] + tag)}
            if by:
                row[key] = by
    print(f"total_s {time.perf_counter() - t_start:.1f}")

    card = card_line()
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
