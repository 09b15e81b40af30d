#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (reni_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one NVIDIA GPU

Phases (any failure exits non-zero and prints no result line):

1. build       - compile kernels/csrc/siren_fwd.cu, siren_bwd.cu,
                 siren_step.cu, film_step.cu, siren_anatomy.cu and the
                 tiled passes' tiled_{siren,film}_{bf16,f32}.cu with nvcc
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
                 grids, and the float32 trunk once (the tiled passes); then
                 FIT_LATENT's three stage grids with and without weight
                 gradients, at 21 x 2,048 the Zoo trunk deepened to 8
                 products, and at 21 x 8,192 the chain kernel
                 (csrc/siren_bwd.cuh) on bf16 trunks of width 96 (CHAIN:
                 cbc 5 products, FiLM 4 and one layer), no pass launched; bars max |kernel - plain| <= 1e-2 (bf16) / 1e-4
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
   export      - cli/export.py traces the cbc and FiLM Zoo decoders on the
                 card (torch.export of the plain decoder, symbolic B and P);
                 a child process that imports torch alone loads each .pt2
                 and decodes the 21 test latents at width 256; held to the
                 plain decoder (max 5e-5) and to the fused kernel path
                 (bf16 bars); the daemon started with --artifact, one
                 /decode equal to the artifact's direct call; decode times
                 of the artifact, the plain decoder and the kernel path. The
                 artifact launches no kernel of the port
5. fit_latent  - train.tasks.fit_task FIT_LATENT on each Zoo decoder at the
                 published hyperparameters (21 maps in one batch, Adam b1=0
                 b2=0.9, LR 1e-2 -> 1e-4, curriculum 16x32 -> 32x64 ->
                 64x128) with the epochs cut from 2,400 to 150 (curriculum
                 50, 100), from fresh latents (load_decoder_only, mu = 0)
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
                 evaluate phase. Then the 21 test skies as 8-bit PNGs
                 (data/synthetic.py --ldr, the LDR Zoo entry's maps), read
                 back without PIL: ms a map
   codecs      - the remaining EXR codecs (ROADMAP A-6b): the 21 seed-1
                 test skies re-written by the port's writer in PIZ, B44,
                 B44A, DWAA and DWAB (half) and PIZ (float); every file
                 decoded by the native decoder (data/csrc/exr_decode.cpp,
                 built with g++ at first use) and by the Python decoder,
                 bit for bit (DWA on its first 4 files); PIZ bit for bit the
                 ZIP decode; B44's exact maps counted, DWA's largest error
                 against the ZIP decode printed. Host ms a map for the
                 write, the native and the Python decode
   stream      - the streaming tiers (ROADMAP A-9): FIT_DECODER of the cbc
                 Zoo configuration (batch 100, the 1,000 seed-1 maps) with
                 the epochs cut to 9 (3 a stage), (a) resident, (b)
                 stream=True from images_host_at, (c) from disk (lazy=True,
                 row_source_at on the ZIP files), (d) (c) with
                 stream_chunk=5, (e) stream_dtype=bfloat16: (b)-(d) end bit
                 for bit at (a)'s params and per-epoch metrics, (e) at a
                 resident run on bf16-rounded targets; the 64x128 steps of
                 (b) and (c) under set_sync_debug_mode("error"); ms a step
                 and start to start per tier and stage, DiskRowSource's
                 decodes against the rows asked, the card's idle share in a
                 torch.profiler stretch of (c), the H2D copy of a batch
                 (float32, bf16), host ms a row of a lazy decode + stage on
                 1 to 8 threads. Then FIT_LATENT on the cbc decoder from
                 the 21 DWAB files streamed from disk (one batch an epoch,
                 30 epochs), bit for bit a resident FIT_LATENT on the same
                 files' eager decode
   fit_inverse - render.inverse.fit_inverse on each Zoo decoder at the
                 published RENI.FIT_INVERSE (data/3D_Models/teapot.obj, a
                 64x64 render, KD_VALUE 1.0, one view, batch 1, 64x128 maps =
                 8,192 lights, Adam b1=0 b2=0.999, LR 1e-2 -> 1e-5) with the
                 epochs cut from 1,200 to 20 (420 steps), from fresh latents
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
   evaluate    - cli/evaluate.main on the six Zoo entries' latents_test
                 and the seed-1 test maps at 64x128 (the LDR entry on their
                 PNGs, normalize(0.5, 0.5); Mask-3 in-painting on the cbc
                 entry), through the kernels and through the plain decoder
                 on the card: psnr_mean, rotated PSNR within 0.05 dB and
                 ssim_mean within 1e-3 between the runs, printed beside
                 eval.json (a TPU's numbers), self_consistency_psnr >= 50
                 dB; every decode through the fused forward
   baselines   - SH projection + reconstruction of two seed-1 test maps at
                 order 6 (a 49-latent budget) in float64 on the card, within
                 1e-10 relative of the CPU; an SG mixture of 12 lobes fitted
                 for 2,000 Adam steps on the card, last loss < first / 20
   convert     - the cbc entry to a reference-layout Lightning .ckpt and
                 back (cli/convert.py): weights and a kernel-path decode of
                 the 21 test latents bit for bit the entry's
   fit_prior   - examples/fit_prior_torch.py --checkpoint zoo on a seed-1
                 test map through Mask-3 (width 64, 400 steps) in a child on
                 the card: the loss falls, one forward and one backward of
                 the kernels a step; step time and launches printed. Then
                 on the script's own inputs: the backward kernel against
                 its plain version at 1 x 2,048 (a cotangent weighted by the
                 masked sine weight), timed there beside its bound; the
                 script's fit through the kernels and through the plain
                 versions, step 0's loss within STEP_LOSS_BAR and the
                 fitted decodes' PSNR within 0.1 dB between the runs
   cli_run    - the trainer, python -m reni_tpu_torch.cli.run, on
                 configs/zoo_synthetic.yaml (written here as JSON: the card
                 has no PyYAML) with the chain FIT_DECODER -> FIT_LATENT ->
                 FIT_INVERSE (FIT_INVERSE as in the fit_inverse phase) on the
                 seed-1 maps, cut to 16 / 32 / 8 epochs (curricula (8, 12)
                 and (8, 16)), checkpoints every 4 epochs, 10 image grids
                 every 8. Run A: the chain in this process through
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
                 its rows after the relaunch run A's rows of the same epochs.
                 Run C: FIT_DECODER alone with TPU.STREAM_FROM_DISK (rows
                 decoded a batch at a time, grids from a DiskRowSource) in
                 this process: its fit_decoder_final run A's bit for bit
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
                 and the float32 case through the tiled passes; the chain
                 kernel (csrc/siren_step.cuh) on the CHAIN trunks at 100 x
                 8,192, no pass launched; then each
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
12. mesh      - (after cli_run) the data x pixel mesh (ROADMAP A-11): ranks
                 as processes on the one card, their collectives over gloo
                 (NCCL takes one rank a card), built once here and each
                 launching the kernels on its block: (a) 4 ranks, 2 x 2,
                 one FIT_DECODER step of each conditioning at 100 x 8,192
                 against the single-device kernel step (loss 1e-4 relative,
                 every gradient within the bf16 step bar), the same bits
                 twice and on every rank; (b) 2 x 2, FIT_DECODER cbc at the
                 stream phase's cut, resident and from disk in chunks of 5,
                 PSNR within 0.1 dB of the single-device resident run, each
                 rank decoding only its rows; (d) decode_sharded over the 4
                 ranks against the single-device decode; (c) 2 x 1
                 FIT_LATENT with sharded latents (21 maps padded to 22) and
                 (e) the trainer's chain on 2 x 1 through run_with_retries
                 (rank 0 alone writes), each within 0.1 dB of its
                 single-device run; (f) an NCCL group of one rank. Times
                 here are not scaling numbers: the ranks share one card
13. tp        - (after mesh) the tensor-parallel model axis (ROADMAP
                 A-11b): ranks as processes on the one card over gloo, the
                 decoder parallel/tp.py's sharded plain decoder (the kernels
                 declined, as in JAX: none launches). (a) one FIT_DECODER
                 step of the cbc (5x256) and FiLM (mapping 3x256) Zoo
                 configurations at 100 x 8,192 on 1 x 1 x 2 and 1 x 1 x 4
                 against the single-device plain step (loss 1e-5 relative,
                 every gradient within 1e-4 x max |single|), the same bits
                 twice (1 x 1 x 2; one call on 1 x 1 x 4), the replicated
                 leaves and the gathered slices the same bits on every rank;
                 (c) FIT_LATENT with the frozen decoder sharded on 1 x 1 x 2;
                 (b) FIT_DECODER cbc on 2 x 1 x 2, resident and from disk in
                 chunks of 5; (d) the trainer's three-task chain on --mesh
                 1x1x2, killed mid-FIT_DECODER and relaunched with --retries
                 1 (bit for bit the uncut chain); cut to two epochs: (b) and
                 (d)'s FIT_DECODER at 16x32, (c) and (d)'s FIT_LATENT one at
                 16x32 and one at 32x64, (d)'s FIT_INVERSE at its own
                 resolution; each within 0.1 dB of its single-device plain
                 run
14. faults    - the trainer's fault machinery (ROADMAP A-13) on cli_run's
                 FIT_DECODER, each run a trainer process, in two waves: a
                 stop file (exit 115 after a checkpoint), an RSS bound below
                 the RSS (exit 114) and a run holding the chip lock under
                 RENI_TPU_HANG_EXIT_S=30 (no hang exit), side by side; a
                 second launch with TPU.PRECOMPILE that waits for the lock,
                 beside the two relaunches; the holder, the second launch and
                 each relaunch bit for bit cli_run's run A, with what the
                 precompiler built
15. wide      - (after faults) the tiled passes (csrc/tiled_passes.cuh):
                 (a) bf16 at 5 x 384, 5 x 512, 3 x 1,024 and float32 at
                 12 x 256, 5 x 512, 3 x 1,024, cbc and FiLM at 21 x 8,192:
                 the step, the backward with and without weight gradients
                 and the hand-off against their plain versions at the bars,
                 two calls the same bits; at 5 x 512 each trunk's step at
                 100 x 8,192 and backward at 21 x 8,192 timed; then, the
                 route counts zeroed just before, (b) FIT_DECODER of the
                 Zoo's cbc widened to 5 x 512 (fresh init, 6 epochs,
                 curriculum 2 / 4) through the kernels and the plain step,
                 within 0.1 dB; (c) the trainer's chain at 5 x 512 bf16 and
                 12 x 256 float32 (cut to 6 / 6 / 1 epochs), every step of
                 every task through the kernels on the tiled route
16. report    - one JSON line of kernels, the card's name and power limit,
                 then {"ok": true, "device": {...}} as the last line; the
                 step and backward rows carry the tiled routes' numbers
                 under "wide_routes"

The numbers of the export, evaluate, baselines, convert and fit_prior
phases are printed with the card's name and power limit beside them.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import runpy
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
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ZOO = os.path.join(ROOT, "data", "Zoo")
CBC = os.path.join(ZOO, "latent_dim_49_net_5_256_vad_cbc_tanh_hdr")
FILM = os.path.join(ZOO, "latent_dim_49_net_5_256_vad_film_tanh_hdr")
WIDTH = 256  # 128 x 256 = 32,768 directions
SERVE_WIDTHS = (128, 130, 256)
DEVICE = "cuda"
CARD = ""  # the card's name and power limit (nvidia-smi), printed beside the new phases' numbers
# bars of the JAX package's test_fused_bf16_trunk_close
MAX_ERR, MEAN_ERR = 0.05, 0.01
# float32-trunk bars of test_fused_forward_matches_jnp (exact sine) and
# test_fused_apply_fast_sine_matches_fast_jnp (fast sine)
F32_MAX_ERR = {False: 1e-5, True: 2e-5}
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCE = "reni_tpu_torch/kernels/csrc/siren_fwd.cu"
SOURCE_FUSED = "reni_tpu_torch/kernels/csrc/fused_fwd.cuh"
SOURCE_TILE = "reni_tpu_torch/kernels/csrc/siren_fwd.cuh"
SOURCE_BWD = "reni_tpu_torch/kernels/csrc/siren_bwd.cu"
SOURCE_STEP = "reni_tpu_torch/kernels/csrc/siren_step.cu"
SOURCE_FILM_STEP = "reni_tpu_torch/kernels/csrc/film_step.cu"
SOURCE_ANATOMY = "reni_tpu_torch/kernels/csrc/siren_anatomy.cu"
KERNEL_SOURCES = ("siren_fwd", "siren_bwd", "siren_step", "film_step", "siren_anatomy",
                  "tiled_siren_bf16", "tiled_siren_f32", "tiled_film_bf16", "tiled_film_f32")
SOURCE_TILED = "reni_tpu_torch/kernels/csrc/tiled_passes.cuh"
# backward bars: max |kernel - plain| <= BAR x max |plain|, per gradient
BWD_BAR = {"bfloat16": 1e-2, "float32": 1e-4}
BWD_WIDTHS = (256, 128)  # 21 x 32,768 and 21 x 8,192 directions
MASK = os.path.join(ROOT, "data", "Masks", "Mask-3.png")
# FIT_LATENT: the published task (config.yaml RENI.FIT_LATENT) with the
# epochs cut from 2,400 to 150
FIT_EPOCHS, FIT_CURRICULUM = 150, (50, 100)
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
# forward widths past the 64-row tile; float32 2,048 is past the 16-row tile
# too: the passes' output mode (siren_fwd.fwd_route "passes")
WIDE = (("float32", 512), ("bfloat16", 1024), ("float32", 2048))
C8_SHAPE = (65536, 64, 64, 2)  # images, directions, width, products: past the grid's old y limit
DEEP_MM = 8  # products of the deepened trunk the backward is held at
# the chain kernels (csrc/siren_step.cuh, csrc/siren_bwd.cuh) on the bf16
# trunks no pass design takes, a width that is not a multiple of 64: (H, H x
# H products) by conditioning, within the chain's depth limit; FiLM also its
# one-layer trunk
CHAIN = {False: ((96, 5),), True: ((96, 4), (96, 0))}
GUARD_BATCH = 1000  # FIT_DECODER batch of the device-memory guard's step
SYNC_WARMUP = 2  # 64x128 FIT_DECODER steps before the sync check
# the maps the Zoo was trained on (data/Zoo/README.md "Recipe") and the
# published transform (configs/zoo_synthetic.yaml)
SEED_MAPS = dict(train=1000, test=21, width=128, seed=1)
PUBLISHED_TRANSFORMS = [["minmaxnormalise", [-18.0536, 11.4633]]]
# FIT_INVERSE: the published task (config.yaml RENI.FIT_INVERSE: teapot,
# 64 x 64 render, KD_VALUE 1.0, one view, batch 1, 64 x 128 maps) with the
# epochs cut from 1,200 to 20
TEAPOT = os.path.join(ROOT, "data", "3D_Models", "teapot.obj")
INV_EPOCHS, INV_RENDER, INV_KD = 20, 64, 1.0
# the TF32 guard: one GT render with a specular term (kd 0.5) in float32
# against float64, sum |f32 - f64| / sum |f64| (K = 3 dots whose inputs are
# rounded to TF32's 10 mantissa bits put more than 1e-2 there:
# tests/test_torch_render.py::test_tf32_guard_sees_a_tf32_dot); the largest
# pixel error is printed, not held: a light within a few thousandths of a
# degree of -V makes N.H ill-conditioned in the float32 inputs themselves
TF32_GUARD_KD, TF32_GUARD_BAR = 0.5, 1e-4
STEP0_BAR = 1e-2  # step 0's metrics, kernel vs plain run, relative
INV_PROFILED = (100, 105)  # steps of the kernel run traced by torch.profiler
# evaluate: the six Zoo entries with the dataset and transform of each one's
# config.yaml (the exp entry trains on raw radiance; the LDR entry on the
# --ldr PNGs of the same skies with normalize(0.5, 0.5)), kernel run vs
# plain run on the card
LDR_TRANSFORMS = [["normalize", [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]]]
EVAL_ENTRIES = (("latent_dim_49_net_5_256_vad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS, "RENI_HDR"),
                ("latent_dim_49_net_5_256_vad_film_tanh_hdr", PUBLISHED_TRANSFORMS, "RENI_HDR"),
                ("latent_dim_100_net_5_256_vad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS, "RENI_HDR"),
                ("latent_dim_49_net_5_256_ad_cbc_tanh_hdr", PUBLISHED_TRANSFORMS, "RENI_HDR"),
                ("latent_dim_49_net_5_256_vad_cbc_exp_hdr", [], "RENI_HDR"),
                ("latent_dim_49_net_5_256_vad_cbc_tanh_ldr", LDR_TRANSFORMS, "RENI_LDR"))
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
CLI_CUTS = {"FIT_DECODER": (16, [8, 12]), "FIT_LATENT": (32, [8, 16]), "FIT_INVERSE": (8, None)}
CLI_EVERY, CLI_IMAGES_EVERY = 4, 8
CLI_PROBE_S = 600  # time limit of each process of the crash / relaunch probe
CLI_INVERSE_BAR = 1e-6  # FIT_INVERSE's final latents, run B vs run A, relative, if not bitwise
# export: the artifact (the plain decoder) against the plain decoder, float32
# forward bar of ROADMAP's parity yardsticks
EXPORT_F32_BAR = 5e-5
# baselines: SH at the order a 49-latent budget buys, in float64 on the card
# against the CPU; SG as tests/test_baselines.py fits it, at its loss bar
SH_MAPS, SH_REL_BAR = 2, 1e-10
SG_LOBES, SG_STEPS, SG_RATIO = 12, 2000, 20.0
# fit_prior: examples/fit_prior_torch.py on the best Zoo prior, one seed-1
# test map through Mask-3
FIT_PRIOR_SCRIPT = os.path.join(ROOT, "examples", "fit_prior_torch.py")
FIT_PRIOR_WIDTH, FIT_PRIOR_STEPS = 64, 400
CHILD_S = 600  # time limit of each child process of the new phases
# codecs: the 21 seed-1 test skies re-written in each remaining codec; the
# Python decoder checked on every file but DWA's first CODEC_PYTHON_DWA
CODEC_FILES = (("PIZ", "half"), ("B44", "half"), ("B44A", "half"), ("DWAA", "half"),
               ("DWAB", "half"), ("PIZ", "float"))
CODEC_PYTHON_DWA = 4
# stream: FIT_DECODER (decoder_task_config) with the epochs cut from 2,400 to
# 6 (2 a stage); chunk 5 divides the 10 batches an epoch; 64x128 steps
# [10, 18) of the from-disk run traced; the host stage timed over 200 rows
STREAM_EPOCHS, STREAM_CURRICULUM = 6, (2, 4)
STREAM_CHUNK = 5
STREAM_PROFILED = (10, 18)
STREAM_THREADS, STREAM_RATE_ROWS = (1, 2, 4, 8), 200
STREAM_COPY_RUNS = 11
# FIT_LATENT from the DWAB files on disk: 21 maps in one batch, 30 epochs
STREAM_LATENT_EPOCHS, STREAM_LATENT_CURRICULUM = 30, (10, 20)
# mesh: each rank's time limit; the single-device runs the phase is held
# against (the stream phase's resident run, cli_run's run A finals)
MESH_CHILD_S = 300
MESH_CHILD = [sys.executable, os.path.abspath(__file__), "--mesh-rank"]  # a rank's command
MESH_REFS: dict = {}
# tp: the sharded step against the single-device plain step (float32 bars:
# the loss relative, each gradient over max |single|); (b) cut to two epochs
# at 16x32, (c) to one epoch at 16x32 and one at 32x64; (d) the chain cut to
# (EPOCHS, CURRICULUM, FINAL_RESOLUTION), FIT_DECODER one stage of two epochs
# (killed mid-stage)
TP_LOSS_BAR, TP_GRAD_BAR = 1e-5, 1e-4
TP_FIT_EPOCHS, TP_FIT_CURRICULUM, TP_FIT_RES = 2, (1,), (32, 64)
TP_CHAIN_CUTS = {"FIT_DECODER": (2, None, [16, 32]), "FIT_LATENT": (2, [1], [32, 64]),
                 "FIT_INVERSE": (2, None, None)}
# wide: the tiled passes (csrc/tiled_passes.cuh) at (trunk, H, H x H
# products), cbc and FiLM at 21 x 8,192 against their plain versions; the
# Zoo's cbc trunk widened to 5 x 512 through FIT_DECODER (kernels and plain
# step) and the trainer's chain at (H, layers, trunk), each cut to
# WIDE_CLI_CUTS (epochs, curriculum)
WIDE_KERNELS = (("bfloat16", 384, 5), ("bfloat16", 512, 5), ("bfloat16", 1024, 3),
                ("float32", 256, 12), ("float32", 512, 5), ("float32", 1024, 3),
                ("bfloat16", 1152, 3), ("bfloat16", 2048, 2), ("float32", 1152, 3),
                ("float32", 2048, 2))
WIDE_ONE_LAYER = (("bfloat16", 256), ("float32", 256))  # (trunk, H) of one-layer FiLM trunks
WIDE_FIT = (512, 6, (2, 4))  # width, epochs, curriculum
WIDE_CHAINS = ((512, 5, "bfloat16"), (256, 12, "float32"))
WIDE_CLI_CUTS = {"FIT_DECODER": (6, [2, 4]), "FIT_LATENT": (6, [2, 4]), "FIT_INVERSE": (1, None)}
WIDE_TIMED = (512, 5)  # the width and products timed for the kernels line
WIDE_ZOO_F32 = (256, 5)  # and the Zoo's own trunk under TPU.PRECISION: float32 (the step)


T0 = time.perf_counter()  # the phases' start times are counted from import


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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


def compare_bwd(cfg, dec, Z, D, trunk, weight_grads, seed, n_mm=None,
                weight=None) -> tuple[float, float]:
    """Backward kernel vs plain version, every gradient (``n_mm``: on the
    trunk deepened to that many products; ``weight``: (1, P, 1) pixel
    weights of the cotangent), and two kernel calls bit for bit; returns the
    largest max |difference| and the largest max |difference| / max |plain|
    (the quantity the bar holds: the gradients' scales differ by orders of
    magnitude)."""
    kernel, plain, kw = bwd_fns(cfg, trunk, weight_grads)
    ops = packed(cfg, dec, Z, D)
    if n_mm is not None:
        ops = deeper(ops, cfg.is_film, n_mm)
    g = cotangent(Z, D.shape[1], seed)
    if weight is not None:
        g = g * weight
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
    asserted). The maps stay in ``tmp`` for the evaluate phase. Then the 21
    test skies of the same draw as 8-bit PNGs under ``tmp/ldr/Test`` (the
    LDR Zoo entry's maps, ``--ldr``, written with the training skies under
    ``tmp/ldr/Train``), read back with ``read_ldr`` (numpy + zlib, no PIL)
    and timed a map. Returns (training set, test set)."""
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
    t0 = time.perf_counter()
    ldr = synthetic.write_dataset(os.path.join(tmp, "ldr"), **SEED_MAPS, ldr=True)["Test"]
    t1 = time.perf_counter()
    names = sorted(os.listdir(ldr))
    maps = [datasets.read_ldr(os.path.join(ldr, name)) for name in names]
    t2 = time.perf_counter()
    check(len(maps) == SEED_MAPS["test"]
          and all(m.shape == (SEED_MAPS["width"] // 2, SEED_MAPS["width"], 3)
                  and m.dtype == np.float32 and 0.0 <= m.min() <= m.max() <= 1.0 for m in maps),
          "LDR test maps")
    print(f"LDR maps (--ldr, PNG): {n} generated and written in {t1 - t0:.2f} s "
          f"({(t1 - t0) * 1e3 / n:.3f} ms a map); read_ldr of the {len(maps)} test maps "
          f"{(t2 - t1) * 1e3 / len(maps):.3f} ms a map (host)")
    return train, test


def exr_codec_files(src_dir: str, out_root: str, codec: str, pixel_type: str):
    """The ZIP test skies of ``src_dir`` re-written by the port's writer in
    ``codec`` / ``pixel_type`` under ``out_root/<codec>_<pixel_type>/Test``;
    returns (that directory, the ZIP decodes, host ms a map to write)."""
    from reni_tpu_torch.data import exr

    names = sorted(os.listdir(src_dir))
    zips = [exr.read(os.path.join(src_dir, n)) for n in names]
    out = os.path.join(out_root, f"{codec}_{pixel_type}", "Test")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    for name, img in zip(names, zips):
        exr.write(os.path.join(out, name), img, pixel_type=pixel_type, compression=codec)
    return out, zips, (time.perf_counter() - t0) * 1e3 / len(names)


def codecs_phase(maps_root: str) -> str:
    """The remaining codecs (ROADMAP A-6b) on the 21 seed-1 test skies: each
    re-written by the port's writer in CODEC_FILES; the native decoder
    against the Python decoder bit for bit on every file (DWA on
    CODEC_PYTHON_DWA files: Python takes about 0.5 s a DWA map); PIZ against
    the ZIP decode bit for bit (lossless), B44 where a map survives it
    exactly, DWA's largest relative error against the ZIP decode (printed,
    no bar). Prints ms a map for the write, the native decode and the Python
    decode (host, one thread), with the card's name and power limit.
    Returns the DWAB half directory (the stream phase's FIT_LATENT)."""
    from reni_tpu_torch.data import exr

    src = os.path.join(maps_root, "Test")
    dirs = {}
    for codec, pixel_type in CODEC_FILES:
        out, zips, write_ms = exr_codec_files(src, os.path.join(maps_root, "codecs"), codec,
                                              pixel_type)
        dirs[(codec, pixel_type)] = out
        paths = [os.path.join(out, n) for n in sorted(os.listdir(out))]
        t0 = time.perf_counter()
        native = [exr.read(p) for p in paths]
        native_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        n_py = CODEC_PYTHON_DWA if codec.startswith("DWA") else len(paths)
        t0 = time.perf_counter()
        with exr.force_python_decoder():
            python = [exr.read(p) for p in paths[:n_py]]
        python_ms = (time.perf_counter() - t0) * 1e3 / n_py
        for i, (a, b) in enumerate(zip(native, python)):
            check(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
                  f"{codec} {pixel_type} map {i}: native decode != Python decode")
        exact = [np.array_equal(a.view(np.uint32), z.view(np.uint32))
                 for a, z in zip(native, zips)]
        if codec == "PIZ":
            check(all(exact), f"PIZ {pixel_type}: {exact.count(False)} maps differ from ZIP")
        rel = max(float(np.abs(a - z).max() / np.abs(z).max()) for a, z in zip(native, zips))
        print(f"codec {codec} {pixel_type}: write {write_ms:.3f} ms a map, native decode "
              f"{native_ms:.3f} ms a map, Python decode {python_ms:.3f} ms a map ({n_py} maps, "
              f"native == Python bit for bit); {sum(exact)}/{len(exact)} maps bit for bit the ZIP "
              f"decode, largest |diff| / max |ZIP| {rel:.3g} (host; card {CARD})")
    return dirs[("DWAB", "half")]


def stream_task_config():
    """FIT_DECODER as decoder_task_config, the epochs cut to STREAM_EPOCHS."""
    return dataclasses.replace(decoder_task_config(), epochs=STREAM_EPOCHS,
                               curriculum=STREAM_CURRICULUM)


def same_run(a, b) -> bool:
    """Two fit_task results (params, metrics) bit for bit."""
    from reni_tpu_torch.params import tree_items

    (pa, ma), (pb, mb) = a, b
    leaves_a, leaves_b = dict(tree_items(pa)), dict(tree_items(pb))
    return (ma.keys() == mb.keys() and all(np.array_equal(ma[k], mb[k]) for k in ma)
            and leaves_a.keys() == leaves_b.keys()
            and all(torch.equal(leaves_a[k], leaves_b[k]) for k in leaves_a))


def stream_run(device, images_at, *, sync_hits=None, profile=None, **stream_kw):
    """FIT_DECODER of a fresh cbc student (fit_decoder's model and
    generators) at stream_task_config; returns ((params, metrics), CUDA
    events of each step by resolution, step-kernel launches). With
    ``sync_hits`` the 64x128 steps after warm-up are sync_watched; with
    ``profile`` (a dict) STREAM_PROFILED 64x128 steps are traced by
    torch.profiler into profile["p"]."""
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    model = RENIModel(ckpt.load_model_config(os.path.join(CBC, "checkpoint")))
    params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
    task = stream_task_config()
    events: dict = {}

    def make_step(model, directions, sineweight, res):
        step = tasks.make_fit_decoder_step(model, directions, sineweight,
                                           kld_weighting=task.kld_weighting)
        if sync_hits is not None and res == FIT_RES[1]:
            step = sync_watched(step, sync_hits)
        step = timed(step, events.setdefault(res, []))
        if profile is None or res != FIT_RES[1]:
            return step

        def run(state, batch):
            at = len(events[res])
            if at == STREAM_PROFILED[0]:
                torch.cuda.synchronize()
                profile["p"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                profile["p"].__enter__()
            out = step(state, batch)
            if "p" in profile and at + 1 == STREAM_PROFILED[1]:
                torch.cuda.synchronize()
                profile["p"].__exit__(None, None, None)
            return out

        return run

    torch.cuda.synchronize()
    ts.siren_step_cuda.launches = 0
    result = tasks.fit_task(model, params, task, images_at, torch.Generator().manual_seed(1),
                            step_builder=make_step, **stream_kw)
    torch.cuda.synchronize()
    return result, events, ts.siren_step_cuda.launches


def stage_ms(events: dict) -> dict:
    """{res: (median ms of a step, median ms from a step's start to the
    next's)}: the second includes whatever the card waited for between
    steps (a copy, the host)."""
    out = {}
    for res, evs in events.items():
        steps = [s.elapsed_time(e) for s, e in evs]
        period = [a.elapsed_time(b) for (a, _), (b, _) in zip(evs, evs[1:])]
        out[res] = (statistics.median(steps), statistics.median(period) if period else float("nan"))
    return out


def busy_share(prof) -> tuple[float, float, int]:
    """(the share of the traced window in which the card ran anything,
    host-to-device copy ms in the window, copies) from a torch.profiler
    trace: the union of the kernels' and copies' intervals on every stream
    over the span from the first to the last."""
    from torch.autograd import DeviceType

    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not work:
        return float("nan"), float("nan"), 0
    spans = sorted((e.time_range.start, e.time_range.end) for e in work)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    copies = [e for e in work if "HtoD" in e.name]
    return (busy / window if window else float("nan"),
            sum(e.time_range.elapsed_us() for e in copies) / 1e3, len(copies))


def host_stage_rates(lazy) -> None:
    """Host ms a row on thread pools of STREAM_THREADS threads over
    STREAM_RATE_ROWS rows of a lazy dataset: the native decode alone
    (``exr.read``), the staging alone (``_stage_img`` of a decoded map:
    resize, normalise, nan_to_num), and both (``_stage_row``, what
    DiskRowSource runs) at 64x128 and 16x32 (the files are 64x128 either
    way): how far the pool scales."""
    from concurrent.futures import ThreadPoolExecutor

    from reni_tpu_torch.data import exr

    rows = list(range(STREAM_RATE_ROWS))
    maps = [exr.read(lazy._paths[i]) for i in rows]
    (h0, w0), (h1, w1) = FIT_RES
    cases = (("native decode alone", lambda i: exr.read(lazy._paths[i])),
             (f"staging alone at {h1}x{w1}", lambda i: lazy._stage_img(maps[i], h1, w1, [])),
             (f"decode + stage at {h1}x{w1}", lambda i: lazy._stage_row(i, FIT_RES[1])),
             (f"decode + stage at {h0}x{w0}", lambda i: lazy._stage_row(i, FIT_RES[0])))
    for label, fn in cases:
        line = []
        for n in STREAM_THREADS:
            with ThreadPoolExecutor(n) as pool:
                list(pool.map(fn, rows[:n]))  # warm-up
                t0 = time.perf_counter()
                list(pool.map(fn, rows))
                line.append(f"{n} threads {(time.perf_counter() - t0) * 1e3 / len(rows):.3f}")
        print(f"lazy rows, {label} (ZIP half files), host ms a row over {len(rows)} "
              "rows: " + ", ".join(line) + f" (card {CARD})")


def copy_ms(device) -> None:
    """A FIT_DECODER batch (100 x 8,192 x 3) copied from pinned memory to the
    card on a side stream with non_blocking=True, float32 and bf16: CUDA
    event medians, bytes, GB/s."""
    side = torch.cuda.Stream(device)
    shape = (DEC_BATCH, FIT_RES[1][0] * FIT_RES[1][1], 3)
    for dtype in (torch.float32, torch.bfloat16):
        host = torch.zeros(shape, dtype=dtype, pin_memory=True)
        dev = torch.empty(shape, dtype=dtype, device=device)
        times = []
        for _ in range(STREAM_COPY_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                dev.copy_(host, non_blocking=True)
                end.record(side)
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms, nbytes = statistics.median(times[1:]), host.numel() * host.element_size()
        print(f"H2D copy of a batch ({dtype}): {nbytes} B in {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.2f} GB/s; card {CARD})")


def stream_phase(device, train, maps_root: str, dwab_test: str) -> dict:
    """The streaming tiers (ROADMAP A-9) on FIT_DECODER of the cbc Zoo
    configuration (stream_task_config) on the 1,000 seed-1 training skies:
    (a) resident, (b) stream=True from images_host_at, (c) from disk (a
    lazy dataset's row_source_at, the ZIP files), (d) (c) with
    stream_chunk=STREAM_CHUNK, (e) stream_dtype=bfloat16 from the host.
    (b)-(d) end bit for bit at (a)'s params and metrics, (e) at a resident
    run on bf16-rounded targets; the 64x128 steps of (b) and (c) run
    sync_watched; a torch.profiler stretch of (c) at 64x128 gives the
    card's idle share. Then FIT_LATENT on the Zoo decoder from the 21 DWAB
    test files, streamed from disk through the native decoder, bit for bit
    a resident FIT_LATENT on the eager decode of the same files. Returns
    the launches under ``<kernel>@stream``."""
    import functools

    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    t_phase = time.perf_counter()
    task = stream_task_config()
    steps = STREAM_EPOCHS * (DEC_MAPS // DEC_BATCH)
    print(f"stream runs: FIT_DECODER cbc, batch {DEC_BATCH} on the {DEC_MAPS} seed-1 maps, "
          f"EPOCHS {STREAM_EPOCHS}, curriculum {STREAM_CURRICULUM} ({steps} steps a run)")
    lazy = datasets.get_dataset("RENI_HDR", os.path.join(maps_root, "Train"),
                                PUBLISHED_TRANSFORMS, True, lazy=True)
    sources = []

    def from_disk(res):
        src = lazy.row_source_at(res)
        sources.append(src)
        return src

    rounded = {}

    def bf16_targets(res):
        if res not in rounded:
            rounded[res] = train.images_at(res, device=device).to(torch.bfloat16).float()
        return rounded[res]

    resident = functools.partial(train.images_at, device=device)
    tiers = (("a resident", resident, {}, None),
             ("b host", train.images_host_at, dict(stream=True), []),
             ("c disk", from_disk, dict(stream=True), []),
             (f"d disk chunk {STREAM_CHUNK}", from_disk,
              dict(stream=True, stream_chunk=STREAM_CHUNK), None),
             ("e host bf16", train.images_host_at,
              dict(stream=True, stream_dtype=torch.bfloat16), None),
             ("e' resident on bf16-rounded targets", bf16_targets, {}, None))
    results, launched, prof = {}, 0, {}
    for label, images_at, kw, hits in tiers:
        t0 = time.perf_counter()
        asked0 = len(sources)
        try:
            result, events, n = stream_run(device, images_at, sync_hits=hits,
                                           profile=prof if label == "c disk" else None, **kw)
        except RuntimeError:
            if not hits:
                raise
            msg, frames = hits[0]
            raise SmokeFailure(f"stream {label}: a 64x128 step synchronised the host with the "
                               f"card: {msg!r} at {' <- '.join(reversed(frames))}")
        wall = time.perf_counter() - t0
        check(n == steps, f"stream {label}: {n} step-kernel launches in {steps} steps")
        launched += n
        results[label] = result
        loss = result[1]["fit_decoder_loss"]
        check(bool(np.isfinite(loss).all()), f"stream {label}: non-finite loss")
        ms = stage_ms(events)
        extra = ""
        if len(sources) > asked0:
            rows = STREAM_EPOCHS * -(-DEC_MAPS // DEC_BATCH) * DEC_BATCH
            extra = (f"; DiskRowSource decodes {sum(s.decodes for s in sources[asked0:])} rows "
                     f"for {rows} rows asked")
        if hits is not None:
            extra += (f"; sync check of the {FIT_RES[1][0]}x{FIT_RES[1][1]} steps after "
                      f"{SYNC_WARMUP} of warm-up: no synchronising call")
        print(f"stream {label}: {wall:.2f} s, launches {n}; " + "; ".join(
            f"{r[0]}x{r[1]} step {s:.3f} ms, start to start {p:.3f} ms"
            for r, (s, p) in sorted(ms.items())) + extra + f" (card {CARD})")
    base = results["a resident"]
    MESH_REFS["fit_decoder"] = base[0]
    for label in ("b host", "c disk", f"d disk chunk {STREAM_CHUNK}"):
        check(same_run(results[label], base), f"stream {label}: not bit for bit the resident run")
    check(same_run(results["e host bf16"], results["e' resident on bf16-rounded targets"]),
          "stream e: not bit for bit the resident run on bf16-rounded targets")
    print("stream b, c, d bit for bit the resident run a (params and per-epoch metrics); "
          "e bit for bit the resident run on bf16-rounded targets")
    if "p" in prof:
        busy, h2d_ms, copies = busy_share(prof["p"])
        n_prof = STREAM_PROFILED[1] - STREAM_PROFILED[0]
        print(f"stream c disk at {FIT_RES[1][0]}x{FIT_RES[1][1]}, {n_prof} steps under "
              f"torch.profiler: the card busy {busy:.1%} of the window (idle {1 - busy:.1%}), "
              f"{copies} H2D copies, {h2d_ms / max(copies, 1):.4f} ms a copy (card {CARD})")
    copy_ms(device)
    host_stage_rates(lazy)

    # FIT_LATENT from disk on the DWAB test files
    lat_task = dataclasses.replace(fit_task_config(False), epochs=STREAM_LATENT_EPOCHS,
                                   curriculum=STREAM_LATENT_CURRICULUM)
    model = RENIModel(ckpt.load_model_config(os.path.join(CBC, "checkpoint")))
    eager = datasets.get_dataset("RENI_HDR", dwab_test, PUBLISHED_TRANSFORMS, True)
    lazy_dwab = datasets.get_dataset("RENI_HDR", dwab_test, PUBLISHED_TRANSFORMS, True,
                                     lazy=True)
    latent = {}
    for label, images_at, kw in (
            ("resident", functools.partial(eager.images_at, device=device), {}),
            ("disk", lazy_dwab.row_source_at, dict(stream=True))):
        params = ckpt.load_decoder_only(os.path.join(CBC, "checkpoint"), model, len(eager),
                                        torch.Generator().manual_seed(0), device)
        torch.cuda.synchronize()
        tb.siren_trunk_bwd_cuda.launches = ts.passes_forward.launches = 0
        t0 = time.perf_counter()
        latent[label] = tasks.fit_task(model, params, lat_task, images_at,
                                       torch.Generator().manual_seed(1), **kw)
        torch.cuda.synchronize()
        n = {"siren_bwd": tb.siren_trunk_bwd_cuda.launches,
             "fwd_passes": ts.passes_forward.launches}
        check(n == {"siren_bwd": STREAM_LATENT_EPOCHS, "fwd_passes": STREAM_LATENT_EPOCHS},
              f"FIT_LATENT {label} on the DWAB maps: launches {n}")
        loss = latent[label][1]["fit_latent_loss"]
        print(f"FIT_LATENT {label} on the 21 DWAB test maps: {STREAM_LATENT_EPOCHS} steps in "
              f"{time.perf_counter() - t0:.2f} s, loss {loss[0]:.6g} -> {loss[-1]:.6g}, "
              f"launches {n}")
    check(same_run(latent["disk"], latent["resident"]),
          "FIT_LATENT from the DWAB files on disk is not bit for bit the resident run")
    lazy.close()
    lazy_dwab.close()
    print(f"FIT_LATENT streamed from disk (DWAB, native decoder, one batch an epoch) bit for "
          f"bit the resident run; stream phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"siren_step@stream": launched, "siren_bwd@stream": 2 * STREAM_LATENT_EPOCHS}


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
    """Device time a step over ``n_steps`` steps that torch.profiler traced:
    the decoder's and the render's from the port's spans
    (``utils/profiling.py``: ``kernels.trunk_fwd`` / ``kernels.trunk_bwd``,
    ``render.forward`` / ``render.backward``; each span's time between its
    two device events), the card's busy time from the trace (kernels,
    copies and fills; not the annotations' ranges), beside the median step
    of the unprofiled steps (the profiler slows the host); the rest of the
    busy time is the loss, Adam and the encodings. Printed, not held."""
    from torch.autograd import DeviceType

    from reni_tpu_torch.utils import profiling

    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not work:
        print(f"{label}: the profiler saw no device time (CUDA events only)")
        return
    spans = profiling.snapshot()["spans"]

    def spans_ms(prefix: str) -> float:
        return sum(s["device_ms"] or 0.0 for s in spans if s["name"].startswith(prefix)) / n_steps

    decoder, render = spans_ms("kernels.trunk_"), spans_ms("render.")
    per_step = {}
    for e in work:
        per_step[e.name] = per_step.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n_steps
    total = sum(per_step.values())
    heavy = sorted(per_step.items(), key=lambda kv: -kv[1])[:5]
    print(f"{label}: a step's device time (torch.profiler, {n_steps} steps): the decoder "
          f"{decoder:.3f} ms, the render {render:.3f} ms, busy {total:.3f} ms of a {step_ms:.3f} ms "
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
                # forward kernel, no chain kernel (a replay of the step's
                # CUDA graph counts the launches its capture counted)
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
    """``cli/evaluate.py`` on the six Zoo entries' test latents and the
    seed-1 test maps (the LDR entry on their PNGs under ``maps_root/ldr``),
    through the kernels and the plain decoder on the card; returns the
    forward kernels' launches of the kernel runs under
    ``<kernel>@evaluate``."""
    from reni_tpu_torch.cli import evaluate
    from reni_tpu_torch.kernels import siren_fwd as tk

    t0 = time.perf_counter()
    keys = ("psnr_mean", "ssim_mean", "rotated_reconstruction_psnr", "self_consistency_psnr")
    launches = {"siren_fwd@evaluate": 0, "film_fwd@evaluate": 0}
    for name, transforms, dataset in EVAL_ENTRIES:
        entry = os.path.join(ZOO, name)
        cfg_path = os.path.join(maps_root, f"{name}.json")
        hdr = dataset == "RENI_HDR"
        with open(cfg_path, "w") as f:
            json.dump({"DATASET": {"NAME": dataset, dataset: {
                "PATH": maps_root if hdr else os.path.join(maps_root, "ldr"),
                "TRANSFORMS": transforms, "IS_HDR": hdr}}}, f)
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
        print(f"{name} [{CARD}]: kernels / plain / eval.json " + "; ".join(
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
    print(f"launches during evaluation (kernel runs): {launches}; evaluate phase wall "
          f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    return launches


EXPORT_CHILD = """\
import json, sys
import numpy as np
import torch

device = sys.argv[1]
d = torch.from_numpy(np.load("d.npy")).to(device)
ms = []
for i, path in enumerate(sys.argv[2:]):
    f = torch.export.load(path).module().to(device)
    z = torch.from_numpy(np.load(f"z{i}.npy")).to(device)
    dz = d.expand(z.shape[0], -1, -1)
    with torch.inference_mode():
        out = f(z, dz)
        if device == "cuda":
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                f(z, dz)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms.append(sorted(times)[2])
    np.save(f"out{i}.npy", out.cpu().numpy())
print(json.dumps({"ms": ms, "port_modules": sorted(m for m in sys.modules if m.startswith("reni_tpu"))}))
"""


def export_phase(device, entries) -> None:
    """``cli/export.py`` on the card for the cbc and FiLM Zoo decoders; both
    artifacts loaded in one child process that imports torch alone (it fails
    if any module of the package is loaded), each called on its entry's 21
    test latents at width 256; each output held to the plain decoder
    (float32 bar) and to the fused kernel path (bf16 bars); the daemon
    started with --artifact, one /decode equal to the artifact's direct
    call. Decode times of the artifact (child and this process), the plain
    decoder and the kernel path, CUDA events. The artifact launches none of
    the port's kernels."""
    from reni_tpu_torch.cli import export as cli_export
    from reni_tpu_torch.cli.serve import make_server
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.serve import load_decoder, load_exported

    D = sphere.get_directions(WIDTH, device=device)
    names = (("siren_fwd", CBC), ("film_fwd", FILM))
    with tempfile.TemporaryDirectory() as tmp:
        arts, export_s = [], []
        for i, (name, entry) in enumerate(names):
            arts.append(os.path.join(tmp, f"{name}.pt2"))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                rc = cli_export.main(["--checkpoint", os.path.join(entry, "checkpoint"),
                                      "--out", arts[-1], "--device", DEVICE])
            export_s.append(time.perf_counter() - t0)
            check(rc == 0 and said.getvalue().startswith("exported "), f"{name}: export {rc}")
            np.save(os.path.join(tmp, f"z{i}.npy"), entries[name][2].cpu().numpy())
        np.save(os.path.join(tmp, "d.npy"), D.cpu().numpy())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", EXPORT_CHILD, DEVICE, *arts], cwd=tmp,
                             env=env, capture_output=True, text=True, timeout=CHILD_S)
        child_s = time.perf_counter() - t0
        check(res.returncode == 0, f"the torch-only child failed:\n{res.stderr[-3000:]}")
        child = json.loads(res.stdout.strip().splitlines()[-1])
        check(child["port_modules"] == [], f"the child loaded {child['port_modules']}")
        print(f"torch-only child: loaded and called both artifacts in {child_s:.2f} s [{CARD}]")

        for i, (name, entry) in enumerate(names):
            cfg, dec, Z = entries[name]
            label = os.path.basename(entry)
            art = arts[i]
            out = torch.from_numpy(np.load(os.path.join(tmp, f"out{i}.npy"))).to(device)
            check(tuple(out.shape) == (21, D.shape[1], 3) and bool(torch.isfinite(out).all()),
                  f"{label}: artifact output {tuple(out.shape)}")
            f = load_exported(art, device)
            Db = D.expand(Z.shape[0], -1, -1)
            plain = RENIModel(dataclasses.replace(cfg, use_pallas=False))
            kernel = load_decoder(os.path.join(entry, "checkpoint"), device)
            with torch.inference_mode():
                ref = plain.apply({"decoder": dec}, Z, Db)
                torch.cuda.synchronize()
                counts = (tk.fused_apply.launches, tk.fused_film_apply.launches)
                here = f(Z, Db)
                torch.cuda.synchronize()
                check((tk.fused_apply.launches, tk.fused_film_apply.launches) == counts,
                      f"{label}: the artifact launched a kernel of the port")
                fused = kernel(Z, Db)
                torch.cuda.synchronize()
                check((tk.fused_apply.launches, tk.fused_film_apply.launches) != counts,
                      f"{label}: the kernel path launched no kernel")
                art_ms = time_ms(lambda: f(Z, Db), runs=5, warmup=1)
                plain_ms = time_ms(lambda: plain.apply({"decoder": dec}, Z, Db), runs=5, warmup=1)
                kernel_ms = time_ms(lambda: kernel(Z, Db), runs=10)
            check(torch.equal(here, out), f"{label}: the artifact's decode differs between processes")
            err = (out - ref).abs().max().item()
            check(err <= EXPORT_F32_BAR, f"{label}: artifact vs plain decoder {err}")
            kerr = (out - fused).abs()
            check(kerr.max().item() < MAX_ERR and kerr.mean().item() < MEAN_ERR,
                  f"{label}: artifact vs kernel path {kerr.max().item()}, {kerr.mean().item()}")
            child_ms = f"{child['ms'][i]:.3f} ms" if child["ms"] else "not timed"
            print(f"{label} artifact: export {export_s[i]:.2f} s ({os.path.getsize(art) / 1e6:.2f} "
                  f"MB); 21 x {D.shape[1]}: max |artifact - plain| {err:.3g}, |artifact - kernel "
                  f"path| max {kerr.max().item():.3g} mean {kerr.mean().item():.3g}; decode on the "
                  f"device: artifact {art_ms:.3f} ms (child {child_ms}), plain decoder "
                  f"{plain_ms:.3f} ms, kernel path {kernel_ms:.3f} ms [{CARD}]")

            httpd = make_server(None, os.path.join(entry, "latents_test"), port=0,
                                device=DEVICE, artifact=art)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                code, health = http(base, "/healthz")
                check(code == 200 and health["artifact"] == art and health["dataset_size"] == 21,
                      f"{label}: healthz {health}")
                z4 = Z[:4].cpu().numpy()
                t0 = time.perf_counter()
                code, body = http(base, "/decode", {"z": z4.tolist(), "width": WIDTH,
                                                   "format": "base64"})
                http_ms = (time.perf_counter() - t0) * 1e3
                check(code == 200, f"{label}: /decode {code} {body.get('error')}")
                direct = f(z4, D.expand(4, -1, -1)).cpu().numpy().reshape(body["shape"])
                check(np.array_equal(decoded(body), direct),
                      f"{label}: /decode differs from the artifact's direct call")
                print(f"{label} --artifact daemon: /decode 4 x width {WIDTH} {http_ms:.1f} ms, "
                      f"equal to the artifact's direct call [{CARD}]")
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=60)


def baselines_phase(device, test) -> None:
    """The paper's analytic baselines on two seed-1 test maps (raw
    radiance, 64 x 128): SH projection and reconstruction at the order a
    49-latent budget buys, in float64 on the card, held to the CPU's host
    path within SH_REL_BAR relative; then an SG mixture of 12 lobes fitted
    for 2,000 Adam steps on the card, its last loss below its first over
    SG_RATIO (tests/test_baselines.py's bar). Times by CUDA events (SH) and
    the host clock around the synchronised fit (SG)."""
    from reni_tpu_torch.baselines import spherical_gaussians as sg
    from reni_tpu_torch.baselines import spherical_harmonics as sh
    from reni_tpu_torch.data import datasets

    lmax = sh.sh_order_from_budget(49)
    maps = [datasets.read_hdr(os.path.join(test.dataset_path, n)) for n in test.img_names[:SH_MAPS]]
    for i, img in enumerate(maps):
        h, w, _ = img.shape
        host = sh.project_environment(img.astype(np.float64), lmax)
        host_rec = sh.reconstruct(host, w)
        x = torch.tensor(img, dtype=torch.float64, device=device)
        coeffs = sh.project_environment_torch(x, lmax)
        rec = sh.reconstruct_torch(coeffs, w)
        rel = max(np.abs(coeffs.cpu().numpy() - host).max() / np.abs(host).max(),
                  np.abs(rec.cpu().numpy() - host_rec).max() / np.abs(host_rec).max())
        check(tuple(rec.shape) == img.shape and rel <= SH_REL_BAR, f"SH map {i}: rel {rel}")
        ms = time_ms(lambda: sh.reconstruct_torch(sh.project_environment_torch(x, lmax), w),
                     runs=5, warmup=1)
        print(f"SH lmax {lmax} ({sh.num_coeffs(lmax)} coefficients), seed-1 test map {i} at "
              f"{h}x{w}, float64: card vs CPU max rel {rel:.3g}; project + reconstruct "
              f"{ms:.3f} ms on the device [{CARD}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = sg.fit_environment(maps[0], SG_LOBES, SG_STEPS, device=device)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ratio = float(losses[0] / losses[-1])
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0] / SG_RATIO,
          f"SG fit: loss {losses[0]} -> {losses[-1]}")
    print(f"SG {SG_LOBES} lobes, {SG_STEPS} Adam steps on seed-1 test map 0: {fit_s:.2f} s "
          f"({fit_s * 1e3 / SG_STEPS:.3f} ms a step), loss {losses[0]:.5g} -> {losses[-1]:.5g} "
          f"(ratio {ratio:.1f}, bar {SG_RATIO}) [{CARD}]")


def convert_phase(device, entries) -> dict:
    """The cbc Zoo entry through ``cli/convert.py --to_torch`` (a
    reference-layout Lightning .ckpt) and back with ``--from_torch``: the
    decoder weights bit for bit the entry's, the embedded config the
    entry's model (the reference's fields; fast sine and the trunk's dtype
    are execution knobs it does not carry), and a kernel-path decode of the
    21 test latents at width 256 with the converted weights bit for bit the
    entry's own. Returns the forward kernel's launches there."""
    from reni_tpu_torch.cli import convert as cli_convert
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.params import from_numpy, tree_items
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.utils import convert

    cfg, dec, Z = entries["siren_fwd"]
    ck = os.path.join(CBC, "checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        ref_ckpt, back = os.path.join(tmp, "reference.ckpt"), os.path.join(tmp, "back")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli_convert.main(["--to_torch", ck, "--out", ref_ckpt]) == 0, "--to_torch")
            t1 = time.perf_counter()
            check(cli_convert.main(["--from_torch", ref_ckpt, "--out", back]) == 0, "--from_torch")
        t2 = time.perf_counter()
        saved, _ = ckpt.load_checkpoint(ck)
        got, _ = ckpt.load_checkpoint(back)
        ours, theirs = dict(tree_items(saved["decoder"])), dict(tree_items(got["decoder"]))
        check(sorted(ours) == sorted(theirs) and all(
            ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]) for k in ours),
              "converted decoder weights differ from the entry's")
        back_cfg = ckpt.load_model_config(back)
        check(convert.reference_config(back_cfg) == convert.reference_config(cfg),
              f"converted config {back_cfg} against {cfg}")
        size = os.path.getsize(ref_ckpt)
    model = RENIModel(dataclasses.replace(cfg, use_pallas=True))
    D = sphere.get_directions(WIDTH, device=device)
    torch.cuda.synchronize()
    tk.fused_apply.launches = 0
    with torch.inference_mode():
        a = model.apply({"decoder": dec}, Z, D)
        b = model.apply({"decoder": from_numpy(got["decoder"], device)}, Z, D)
    torch.cuda.synchronize()
    launches = tk.fused_apply.launches
    check(launches == 2 and torch.equal(a, b),
          f"kernel-path decode with the converted weights differs ({launches} launches)")
    print(f"convert {os.path.basename(CBC)}: --to_torch {t1 - t0:.2f} s ({size / 1e6:.2f} MB "
          f".ckpt), --from_torch {t2 - t1:.2f} s; decoder weights and the kernel-path decode of "
          f"21 x {D.shape[1]} bit for bit the entry's [{CARD}]")
    return {"siren_fwd@convert": launches}


FIT_PRIOR_CHILD = """\
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
import torch
from reni_tpu_torch.kernels import siren_bwd as tb, siren_fwd as tk, siren_step as ts
if torch.cuda.is_available():
    torch.cuda.synchronize()
print(json.dumps({"fwd": tk.fused_apply.launches + tk.fused_film_apply.launches,
                  "fwd_passes": ts.passes_forward.launches,
                  "bwd": tb.siren_trunk_bwd_cuda.launches + tb.film_trunk_bwd_cuda.launches}))
"""


def fit_prior_phase(device, test) -> tuple[dict, dict]:
    """``examples/fit_prior_torch.py --checkpoint zoo`` (the best eval card's
    entry) on seed-1 test map 0 through Mask-3 at width 64 for 400 steps, in
    a child process on the card: the loss falls; each step one forward and
    one backward of the port's kernels (the two decodes after the fit one
    forward each). Then, in this process on the script's own inputs
    (``setup``): the backward kernel against its plain version at the fit's
    shape (1 x 2,048, a random cotangent times the masked sine weight) and
    timed there with its bound; the script's ``fit_latent`` through the
    kernels and through their plain versions, held at step 0's loss
    (STEP_LOSS_BAR) and at the fitted decodes' PSNR to the map (PSNR_BAR_DB,
    as the fit_latent phase). Returns (the child's backward launches under
    ``<kernel>@fit_prior``, {kernel: its 1 x 2,048 timings})."""
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.kernels import siren_bwd as tb

    image = os.path.join(test.dataset_path, test.img_names[0])
    argv = [FIT_PRIOR_SCRIPT, "--checkpoint", "zoo", "--image", image, "--mask", MASK,
            "--width", str(FIT_PRIOR_WIDTH), "--steps", str(FIT_PRIOR_STEPS), "--device", DEVICE]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", FIT_PRIOR_CHILD, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=CHILD_S)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"fit_prior child failed:\n{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    n = json.loads(lines[-1])
    losses = [float(line.split("loss=")[1]) for line in lines if line.startswith("step ")]
    summary = next(line for line in lines if f"{FIT_PRIOR_STEPS} steps on " in line)
    entry = next(line for line in lines if line.startswith("using bundled zoo model"))
    check(len(losses) >= 2 and losses[-1] < losses[0], f"fit_prior loss {losses}")
    steps = FIT_PRIOR_STEPS
    check(n["bwd"] == steps and n["fwd"] + n["fwd_passes"] == steps + 2,
          f"fit_prior launches {n} in {steps} steps (a forward and a backward each, two decodes)")
    print(f"fit_prior: {entry.split(':')[0]}; {summary}; logged losses {losses}; launches {n} "
          f"(backward {n['bwd']}); child wall {wall:.1f} s [{CARD}]")

    script = runpy.run_path(FIT_PRIOR_SCRIPT)  # its functions; main is not run
    args = script["parse_args"](argv[1:])
    model, params, target, D, weight = script["setup"](args, device)
    cfg, dec = model.config, params["decoder"]
    name = "film_bwd" if cfg.is_film else "siren_bwd"
    Z = model.latents(params, [0]).detach()
    B, P = Z.shape[0], D.shape[1]
    with torch.no_grad():
        print(f"{name} B={B} P={P} the fit's shape, masked sine-weighted cotangent, "
              f"no weight gradients:")
        w = weight[..., :1]  # the sine weight times the mask, equal over RGB
        err, rel = compare_bwd(cfg, dec, Z, D, None, False, seed=4, weight=w)
        kernel, plain, kw = bwd_fns(cfg, weight_grads=False)
        ops = packed(cfg, dec, Z, D)
        g = cotangent(Z, P, seed=4) * w
        k = encodings.d_features(cfg.equivariance, D).shape[-1]
        flops = B * P * bwd_flops(cfg, k, cfg.out_features, False)
        nbytes = bwd_bytes(ops, k, cfg.out_features, cfg.is_film, cfg.pallas_trunk, False)
        bound_ms, bound_by = bound(flops, nbytes)
        ms = time_ms(lambda: kernel(*ops, g, **kw))
        plain_ms = time_ms(lambda: plain(*ops, g, **kw))
    print(f"{name} B={B} P={P} without weight gradients: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops:.4g} FLOP, "
          f"{nbytes:.4g} B) [{CARD}]")
    timing = {name: {"err": err, "rel": rel, "shape": {
        f"{B}x{P}": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}}}}

    fits = {}
    mask = sphere.get_mask(FIT_PRIOR_WIDTH, MASK, device=device)[0, :, 0] > 0.5
    counter = tb.film_trunk_bwd_cuda if cfg.is_film else tb.siren_trunk_bwd_cuda
    for plain_run in (False, True):
        model, params, target, D, weight = script["setup"](args, device)
        before = counter.launches
        with plain_trunks() if plain_run else contextlib.nullcontext():
            fitted, curve, _, rest_s = script["fit_latent"](
                model, params, target, D, weight, steps, torch.Generator().manual_seed(3),
                log_every=0)
        ran = counter.launches - before
        check(ran == (0 if plain_run else steps),
              f"fit_prior {'plain' if plain_run else 'kernel'} run: {ran} backward launches")
        with torch.no_grad():
            maps = model.apply(fitted, model.latents(fitted, [0]), D)
        check(bool(np.isfinite(curve).all()) and curve[-1] < curve[0]
              and bool(torch.isfinite(maps).all()),
              f"fit_prior {'plain' if plain_run else 'kernels'}: loss {curve[0]} -> {curve[-1]}")
        db = {"all": psnr(maps, target), "observed (mask 1)": psnr(maps, target, mask),
              "hidden (mask 0)": psnr(maps, target, ~mask)}
        fits[plain_run] = (curve, model.latents(fitted, [0]).detach(), db, rest_s)
    (ck, zk, dbk, sk), (cp, zp, dbp, sp) = fits[False], fits[True]
    step0 = abs(ck[0] - cp[0]) / abs(cp[0])
    loss_rel = float(np.max(np.abs(ck - cp) / np.abs(cp)))
    z_rel = ((zk - zp).abs().max() / zp.abs().max()).item()
    check(step0 <= STEP_LOSS_BAR[cfg.pallas_trunk],
          f"fit_prior step-0 loss kernels {ck[0]} vs plain {cp[0]} ({step0:.3g} relative)")
    for key in dbk:
        gap = abs(dbk[key] - dbp[key])
        check(gap <= PSNR_BAR_DB, f"fit_prior PSNR {key} kernels vs plain differ by {gap:.3f} dB")
    print(f"fit_prior kernels vs plain on the script's inputs, {steps} steps each: step-0 loss "
          f"{ck[0]:.6g} / {cp[0]:.6g} ({step0:.3g} relative, bar "
          f"{STEP_LOSS_BAR[cfg.pallas_trunk]}); final loss {ck[-1]:.6g} / {cp[-1]:.6g}; "
          f"largest relative loss difference over the steps {loss_rel:.3g}; fitted latent max "
          f"|diff| / max |plain| {z_rel:.3g}; PSNR (peak 1) of the fitted decode "
          + ", ".join(f"{k} {dbk[k]:.3f} / {dbp[k]:.3f} dB" for k in dbk)
          + f" (bar {PSNR_BAR_DB} dB); {sk * 1e3 / (steps - 1):.3f} / "
          f"{sp * 1e3 / (steps - 1):.3f} ms a step [{CARD}]")
    return {f"{name}@fit_prior": n["bwd"]}, timing


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


def _cli_finals(log_dir: str, tasks=CLI_TASKS) -> dict:
    out = {}
    for task in tasks:
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
    MESH_REFS["cli_finals"] = fa
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
    t2 = time.perf_counter()
    n_c = disk_trainer_run(device, cfg, work, fa["FIT_DECODER"])
    print(f"cli_run phase wall {time.perf_counter() - t0:.1f} s: run A {wall_a:.1f} s, "
          f"run B (both processes) {wall_b:.1f} s, run C {time.perf_counter() - t2:.1f} s")
    return {"siren_step@cli_run": n["siren_step"], "siren_bwd@cli_run": n["siren_bwd"],
            "siren_bwd_fwd_passes@cli_run": n["fwd_passes"], "siren_fwd@cli_run": n["siren_fwd"],
            "siren_step@cli_run_disk": n_c["siren_step"], "siren_fwd@cli_run_disk": n_c["fused"]}


def disk_trainer_run(device, cfg, work: str, final_a: dict) -> dict:
    """Run C: the trainer (cli.run.cli, in this process) on FIT_DECODER alone
    with TPU.STREAM_FROM_DISK at the cli_run cut: the files decode a batch
    at a time (the grids from a DiskRowSource); its fit_decoder_final must
    be run A's bit for bit. Returns its launches."""
    from reni_tpu_torch.cli import run as cli_run
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    cfg = cfg.clone()
    cfg.RENI.TASKS = ["FIT_DECODER"]
    cfg.TPU.STREAM_FROM_DISK = True
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = os.path.join(work, "runs_disk")
    cfg_path = os.path.join(work, "zoo_synthetic_disk.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg.to_dict(), f)
    argv = ["--cfg_path", cfg_path] + ([] if device.type == "cuda" else ["--device", "cpu"])
    torch.cuda.synchronize()
    ts.siren_step_cuda.launches = 0
    tk.fused_fwd_launches = tk.tile_fwd_launches = 0
    t0 = time.perf_counter()
    check(cli_run.cli(argv) == 0, "run C: cli returned non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {"siren_step": ts.siren_step_cuda.launches, "fused": tk.fused_fwd_launches,
         "tile": tk.tile_fwd_launches}
    log_c = cli_run._experiment_runs(cfg)[0]
    with np.load(os.path.join(log_c, "checkpoints", "fit_decoder_final.npz")) as z:
        final_c = {k: z[k] for k in z.files}
    steps = CLI_CUTS["FIT_DECODER"][0] * (SEED_MAPS["train"] // cfg.RENI.FIT_DECODER.BATCH_SIZE)
    grids = len(os.listdir(os.path.join(log_c, "images")))
    print(f"run C (TPU.STREAM_FROM_DISK, FIT_DECODER alone): {steps} steps in {wall:.1f} s "
          f"({wall * 1e3 / steps:.2f} ms a step, host clock; card {CARD}), {grids} grids, "
          f"launches {n}")
    check(n["siren_step"] == steps and n["fused"] == grids and n["tile"] == 0,
          f"run C launches {n}: {steps} steps, {grids} grids")
    check(final_c.keys() == final_a.keys()
          and all(np.array_equal(final_c[k], final_a[k]) for k in final_a),
          "run C's fit_decoder_final is not run A's bit for bit")
    print("run C's fit_decoder_final bit for bit run A's")
    return n


def training_maps(device, train, entry: str = CBC) -> tuple[torch.Tensor, dict]:
    """(a Zoo entry's 1,000 training latents mu, {resolution: the seed-1
    training maps (1000, P, 3) on the card} at FIT_DECODER's stages)."""
    mu = training_latents(entry, device)
    maps = {res: train.images_at(res, device=device)
            for res, _ in decoder_task_config().resolution_stages()}
    return mu, maps


def decoder_task_config(epochs: int | None = None, curriculum=None):
    """FIT_DECODER's task: DEC_EPOCHS and DEC_CURRICULUM unless given."""
    from reni_tpu_torch.train.optim import OptimConfig
    from reni_tpu_torch.train.tasks import TaskConfig

    return TaskConfig(
        task="FIT_DECODER",
        optim=OptimConfig(lr_start=1e-5, lr_end=1e-7, optimizer="adam", beta1=0.0, beta2=0.9),
        batch_size=DEC_BATCH, epochs=epochs or DEC_EPOCHS, multi_res_training=True,
        initial_resolution=FIT_RES[0], final_resolution=FIT_RES[1],
        curriculum=curriculum or DEC_CURRICULUM, kld_weighting=1e-4,
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
        if not y.numel():  # dWs of a one-layer FiLM trunk
            continue
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        report.append(f"{err / scale:.2g}")
        check(err <= bar * scale, f"gradient {i}: max |diff| {err:.3g} > {bar} x {scale:.3g}")
    print(f"  loss {loss:.6g} (relative error {loss_rel:.2g}); max |diff| / max |plain| per "
          f"gradient: {' '.join(report)} (bar {bar}); two calls bitwise equal")
    return worst, worst_rel


def compare_step_phase(name, cfg, dec, mu, maps, device) -> tuple[list, list]:
    """The compare_step cases of the step kernel ``name`` (siren_step or
    film_step), then its chain kernel (compare_chain_step); returns the
    absolute and relative errors."""
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
    err, rel = compare_chain_step(cfg.is_film, device)
    return errs + err, rels + rel


def chain_cases(film: bool, device, B: int, seed: int):
    """(label, operands, cotangent, loss operands, keywords) of each CHAIN
    trunk of a conditioning at B x 8,192 (random weights, ``wide_operands``),
    checked to be off the pass designs."""
    from reni_tpu_torch.kernels import siren_step as ts

    for H, n_mm in CHAIN[film]:
        label = f"chain kernel, {'film' if film else 'cbc'} bfloat16 {n_mm} x {H}"
        check(ts.pass_design("bfloat16", H, n_mm) is None, f"{label}: on a pass design")
        yield (label, *wide_operands(film, H, n_mm, device, B=B, seed=seed),
               wide_kw(film, "bfloat16"))


def compare_chain_step(film: bool, device) -> tuple[list, list]:
    """The step's chain kernel (csrc/siren_step.cuh) against its plain
    version on the CHAIN trunks at FIT_DECODER's 100 x 8,192 (compare_step:
    the loss and every gradient, two calls bit for bit), no pass launched."""
    from reni_tpu_torch.kernels import siren_step as ts

    errs, rels = [], []
    kernel = step_fns(SimpleNamespace(is_film=film))[0]
    for label, ops, g, loss_ops, kw in chain_cases(film, device, DEC_BATCH, seed=14):
        print(f"{'film' if film else 'siren'}_step B={DEC_BATCH} P={g.shape[1]} {label}:")
        calls, n0 = dict(ts.pass_launches), kernel.launches
        with torch.no_grad():
            err, rel = compare_step(SimpleNamespace(is_film=film), (*ops, *loss_ops),
                                    dict(kw, out_act="tanh", gscale=1.0 / (3 * g.shape[1])))
        check(kernel.launches == n0 + 2 and ts.pass_launches == calls,
              f"{label}: the step did not run the chain kernel")
        errs.append(err)
        rels.append(rel)
        del ops, g, loss_ops
    torch.cuda.empty_cache()
    return errs, rels


def compare_chain_bwd(film: bool, device) -> tuple[list, list]:
    """The backward's chain kernel (csrc/siren_bwd.cuh) against its plain
    version on the CHAIN trunks at FIT_LATENT's 21 x 8,192, with and without
    weight gradients, two calls bit for bit, no pass launched."""
    from reni_tpu_torch.kernels import siren_step as ts

    errs, rels = [], []
    kernel, plain, _ = bwd_fns(SimpleNamespace(is_film=film, fast_sine=True,
                                               pallas_trunk="bfloat16",
                                               first_omega_0=30.0, hidden_omega_0=30.0))
    for label, ops, g, _, kw in chain_cases(film, device, 21, seed=13):
        for wgrad in (False, True):
            tag = f"{label}, {'' if wgrad else 'no '}weight gradients"
            bkw = dict(kw, weight_grads=wgrad)
            calls, n0 = dict(ts.pass_launches), kernel.launches
            with torch.no_grad():
                got, again, ref = kernel(*ops, g, **bkw), kernel(*ops, g, **bkw), plain(*ops, g, **bkw)
            torch.cuda.synchronize()
            check(kernel.launches == n0 + 2 and ts.pass_launches == calls,
                  f"{tag}: the backward did not run the chain kernel")
            same_bits(tag, got, again)
            err, rel = held(tag, got, ref, BWD_BAR["bfloat16"])
            print(f"{'film' if film else 'siren'}_bwd B=21 P={g.shape[1]} {tag}: worst max |diff| / "
                  f"max |plain| {rel:.2g} (bar {BWD_BAR['bfloat16']}); two calls bitwise equal")
            errs.append(err)
            rels.append(rel)
            del got, again, ref
        del ops, g
    torch.cuda.empty_cache()
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


def time_plan_passes(label, plan, ops, kw, device, runs: int = 10) -> tuple[dict, dict]:
    """The passes of ``plan`` timed alone, each with its bytes, FLOPs and
    achieved rates, and (with weight gradients) the weight-gradient product
    over their scratch (``wgrad_timings``), then the design's byte floor
    (printed); returns ({pass: ms}, the product's numbers or {})."""
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
    wgrad = {}
    if plan.weight_grads:
        wgrad = wgrad_timings(label, plan, work.sc_h, work.sc_dz)
        total += plan.wgrad_cost()[1]
    del work, prep
    torch.cuda.empty_cache()
    print(f"  {label}: the design's byte floor {total:.4g} B ({total / plan.rows:.0f} per row) -> "
          f"{total / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12:.2f} TB/s; sum of the passes"
          f"{' and dWs' if plan.weight_grads else ''} "
          f"{sum(passes.values()) + wgrad.get('wgrad_ms', 0.0):.4f} ms")
    return passes, wgrad


def wgrad_timings(label, plan, sc_h, sc_dz, runs: int = 5) -> dict:
    """dWs = h^T dz over a plan's scratch: the kernel held once against
    ``weight_grads_reference``, the float64 product (bf16: 1e-4 x its max
    |dWs|; two calls bitwise equal), then timed with the sum of its split-K
    partials and alone, beside its bound (its FLOP at the trunk's peak, its
    bytes at PEAK_BYTES), its plain version and, as a yardstick only (the
    port never calls it), torch.bmm of the same scratch (TF32 off)."""
    from reni_tpu_torch.kernels import anatomy as ta

    dws, again = ta.weight_grads_cuda(sc_h, sc_dz), ta.weight_grads_cuda(sc_h, sc_dz)
    check(torch.equal(dws, again), f"{label}: dWs differs between two calls")
    ref = ta.weight_grads_reference(sc_h, sc_dz)
    rel = ((dws - ref).abs().max() / ref.abs().max()).item()
    check(plan.trunk != "bfloat16" or rel <= 1e-4,  # wgrad_f32 is held in its own tests
          f"{label}: wgrad_bf16 off the float64 product: {rel:.3g} > 1e-4 x max |dWs|")
    del dws, again, ref
    flops, nbytes = plan.wgrad_cost()
    bound_ms, bound_by = bound(flops, nbytes,
                               PEAK_BF16_FLOPS if plan.trunk == "bfloat16" else PEAK_F32_FLOPS)
    out = {
        "wgrad_ms": time_ms(lambda: ta.weight_grads_cuda(sc_h, sc_dz), runs=runs, warmup=1),
        "wgrad_alone_ms": time_ms(lambda: ta.weight_grads_cuda(sc_h, sc_dz, reduce=False),
                                  runs=runs, warmup=1),
        "wgrad_library_ms": time_ms(lambda: torch.bmm(sc_h.transpose(1, 2), sc_dz), runs=runs,
                                    warmup=1),
        "wgrad_plain_ms": time_ms(lambda: ta.weight_grads_reference(sc_h, sc_dz), runs=3,
                                  warmup=1),
        "wgrad_bound_ms": bound_ms, "wgrad_bound_by": bound_by, "wgrad_max_rel_err": rel,
    }
    name = "wgrad_bf16" if plan.trunk == "bfloat16" else "wgrad_f32"
    print(f"  {label} dWs ({name}, {sc_h.shape[0]} x {sc_h.shape[1]:,} x {sc_h.shape[2]}): "
          f"alone {out['wgrad_alone_ms']:.4f} ms, with its split-K sum {out['wgrad_ms']:.4f} ms; "
          f"{nbytes:.4g} B, {flops:.4g} FLOP -> {nbytes / (out['wgrad_ms'] * 1e-3) / 1e12:.3f} "
          f"TB/s, {flops / (out['wgrad_ms'] * 1e-3) / 1e12:.1f} TFLOP/s; bound {bound_ms:.4f} ms "
          f"({bound_by}); yardstick (not called by the port): torch.bmm of the same scratch "
          f"{out['wgrad_library_ms']:.4f} ms; plain (float64) {out['wgrad_plain_ms']:.4f} ms; "
          f"max |diff| / max |plain| {rel:.3g} ({CARD})")
    return out


def pass_timings(name, cfg, ops, kw, device) -> dict:
    """The passes of one step timed alone at the step's shape, then dWs alone
    over the step's own scratch beside torch.bmm of it (``time_plan_passes``).
    Returns the numbers for the kernels line."""
    from reni_tpu_torch.kernels import siren_step as ts

    plan = ts.step_plan_cuda(cfg.is_film, ops, device)
    passes, wgrad = time_plan_passes(name, plan, ops, kw, device)
    return {"passes_ms": passes, **wgrad}


def bwd_pass_timings(name, cfg, dec, Z, device) -> dict:
    """Each pass of the backward timed alone at 21 x 8,192, without and with
    weight gradients (the design's byte floor printed); returns the times for
    the kernels line."""
    out = {}
    for weight_grads in (False, True):
        plan, ops, kw = bwd_plan(cfg, dec, Z, device, weight_grads)
        tag = "wgrad" if weight_grads else "no_wgrad"
        passes, wgrad = time_plan_passes(f"{name} 21 x 8,192 ({tag})", plan, ops, kw, device,
                                         runs=25)
        out[f"passes_ms_21x8192_{tag}"] = passes
        out.update({f"{k}_21x8192": v for k, v in wgrad.items()})
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


def fit_decoder(device, entry: str, *, plain: bool, train, sync_hits: list | None = None,
                config=None, task=None):
    """One FIT_DECODER run of a fresh student of ``entry``'s configuration
    (or ``config``) on the dataset ``train`` (its ``images_at`` handed to
    ``fit_task``), through the step kernel or (``plain``) its plain version,
    under ``decoder_task_config()`` (or ``task``); returns (trained params,
    model, per-stage step times in ms, metrics, launches {step, fwd, bwd}
    during the run). With ``sync_hits`` the final stage's steps after
    warm-up are ``sync_watched`` into it."""
    import functools

    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    model = RENIModel(config or ckpt.load_model_config(os.path.join(entry, "checkpoint")))
    params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
    task = task or decoder_task_config()
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
        compare_probe("wgrad_bf16 alone (against the float64 product)", [dws],
                      [ta.weight_grads_reference(sc_h, sc_dz)], 1e-4)
        del sc_h, sc_dz, dws, again, got, ref, shipped_bwd
        torch.cuda.synchronize()
        ta.fwd_variant_cuda.launches = ta.bwd_variant_cuda.launches = 0
        ta.weight_grads_cuda.launches = 0
        ta.bwd_variant_cuda.routes.update(passes=0, chain=0)
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
    version at 21 x 8,192: the row-tile kernel, on its 32-row tile, and past
    the 16-row tile the passes' output mode (siren_step.passes_output)."""
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    kw0 = dict(omega0=30.0, omega_h=30.0, fast_sine=True)
    for trunk, H in WIDE:
        ops = wide_trunk(H, device)
        kw = dict(kw0, trunk=trunk)
        check(tk.unsupported_reason(ops[0].shape[1], H, 21, trunk) is None,
              f"the forward declines H = {H} ({trunk})")
        route = tk.fwd_route(trunk, H, ops[3].shape[0])
        count = lambda: tk.tile_fwd_launches if route == "tile" else ts.passes_output.launches
        before = count()
        with torch.no_grad():
            out, again = tk.siren_trunk_cuda(*ops, **kw), tk.siren_trunk_cuda(*ops, **kw)
            ref = tk.siren_trunk_reference(*ops, **kw)
        torch.cuda.synchronize()
        check(count() == before + 2, f"H = {H} ({trunk}) did not take the {route} route")
        same_bits(f"siren_fwd H={H} {trunk}", (out,), (again,))
        err = (out - ref).abs()
        mx, mean = err.max().item(), err.mean().item()
        how = f"a {tk.tile_rows(H, trunk)}-row tile" if route == "tile" else "the passes"
        print(f"siren_fwd H={H} {trunk} ({how}) B=21 P=8192: max abs err {mx:.3g}, mean "
              f"{mean:.3g}; two calls bitwise equal")
        if trunk == "float32":
            check(mx < F32_MAX_ERR[True], f"H = {H} float32 forward off the float32 bar")
        else:
            check(mx < MAX_ERR and mean < MEAN_ERR, f"H = {H} bf16 forward off the bf16 bar")
        errors["siren_fwd"].append(mx)
        rel_errors["siren_fwd"].append(mx / ref.abs().max().item())


def compare_c8(device, errors, rel_errors) -> dict:
    """C-8, batches past the grid's old y limit of 65,535 images, at
    C8_SHAPE: the forward on both routes (the fused kernel in bf16, the
    row-tile kernel in float32), the backward with and without weight
    gradients and the step on the wgmma passes (bf16) and on the tiled
    passes (float32), each against its plain version at the existing bars
    and called twice for the same bits. Appends the forward's and the
    backward's errors; returns the step's (max abs, max rel) by trunk."""
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    B, P, H, n_mm = C8_SHAPE
    step_errs = {}
    for trunk in ("bfloat16", "float32"):
        ops, g, loss_ops = wide_operands(False, H, n_mm, device, B=B, P=P, seed=41)
        kw = wide_kw(False, trunk)
        route, design = tk.fwd_route(trunk, H, n_mm), ts.pass_design(trunk, H, n_mm)
        check((route, design) == (("fused", "wgmma") if trunk == "bfloat16" else ("tile", "tiled")),
              f"C-8 {trunk}: routes {route}, {design}")
        label = f"C-8 {trunk} {n_mm} x {H} B={B} P={P}"
        with torch.no_grad():
            out, again = tk.siren_trunk_cuda(*ops, **kw), tk.siren_trunk_cuda(*ops, **kw)
            ref = tk.siren_trunk_reference(*ops, **kw)
            torch.cuda.synchronize()
            same_bits(f"{label} forward", (out,), (again,))
            err = (out - ref).abs()
            mx, mean = err.max().item(), err.mean().item()
            if trunk == "float32":
                check(mx < F32_MAX_ERR[kw["fast_sine"]], f"{label} forward off the float32 bar")
            else:
                check(mx < MAX_ERR and mean < MEAN_ERR, f"{label} forward off the bf16 bar")
            errors["siren_fwd"].append(mx)
            rel_errors["siren_fwd"].append(mx / ref.abs().max().item())
            del out, again, ref
            report = [f"forward ({route}) max {mx:.3g} mean {mean:.3g}"]
            for wgrad in (False, True):
                bkw = dict(kw, weight_grads=wgrad)
                got, again = tb.siren_trunk_bwd_cuda(*ops, g, **bkw), tb.siren_trunk_bwd_cuda(
                    *ops, g, **bkw)
                ref = tb.siren_trunk_bwd_reference(*ops, g, **bkw)
                torch.cuda.synchronize()
                tag = f"{label} backward {'with' if wgrad else 'without'} weight gradients"
                same_bits(tag, got, again)
                err, rel = held(tag, got, ref, BWD_BAR[trunk])
                errors["siren_bwd"].append(err)
                rel_errors["siren_bwd"].append(rel)
                report.append(f"backward {'w' if wgrad else 'no w'} {rel:.2g}")
                del got, again, ref
            print(f"{label}: {'; '.join(report)}; step ({design} passes):")
            step_errs[trunk] = compare_step(SimpleNamespace(is_film=False), (*ops, *loss_ops),
                                            dict(kw, out_act="tanh", gscale=1.0 / (3 * P)))
        del ops, g, loss_ops
        torch.cuda.empty_cache()
    return step_errs


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


# ---------------------------------------------------------------------------
# mesh: the data x pixel mesh and multi-process runs (ROADMAP A-11)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_ranks(work: str, job: dict, n: int) -> subprocess.Popen:
    """Start ``n`` ranks of ``job`` (``mesh_rank``) as processes on the one
    card (``cuda:0`` each, ``LOCAL_RANK=0``), their rendezvous on a free
    localhost port; returns a handle for ``mesh_wait``."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(job, f)
    port = str(_free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        log = open(os.path.join(work, f"rank_{r}.log"), "w")
        procs.append((subprocess.Popen(
            MESH_CHILD + [work], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True), log))
    return procs


def mesh_wait(work: str, procs) -> list[tuple[dict, dict]]:
    """Wait for every rank (MESH_CHILD_S each; all are killed when one does
    not end) and return each rank's (results, arrays); a rank that fails
    fails the phase with the end of its log."""
    import signal

    limit = time.monotonic() + MESH_CHILD_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, limit - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=60)
            log.close()
    out = []
    for r, (p, _) in enumerate(procs):
        with open(os.path.join(work, f"rank_{r}.log")) as f:
            text = f.read()
        check(p.returncode == 0, f"mesh rank {r} of {work} exited {p.returncode}:\n{text[-3000:]}")
        with open(os.path.join(work, f"rank_{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(work, f"rank_{r}.npz")) as z:
            out.append((res, {k: z[k] for k in z.files}))
    return out


def _mesh_model(entry: str, device):
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt

    return RENIModel(ckpt.load_model_config(os.path.join(entry, "checkpoint")))


def _step_grads(model, params, images, device, mesh=None, held=None) -> tuple[dict, dict, dict]:
    """One FIT_DECODER step (decoder_task_config's optimizer, the fresh
    student of fit_decoder) on ``images`` (the whole batch, or on ``mesh``
    this rank's block of it): (loss metrics, the gradients that reached the
    optimizer, the updated trainable leaves), all as numpy. On a model axis
    the decoder is cut to the rank's slices for the step
    (``shard_for_stage``): the gradients are the slices', the leaves
    gathered whole after it, and ``held`` receives the slices the rank
    updated. ``held["ms"]`` is the step's time (host clock, the card
    synchronised around it)."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.parallel import mesh as pmesh
    from reni_tpu_torch.params import tree_items
    from reni_tpu_torch.train import tasks

    task = decoder_task_config()
    optim = dataclasses.replace(task.optim, epochs=task.epochs, steps_per_epoch=10)
    state = tasks.init_train_state(model, params, optim, torch.Generator().manual_seed(1))
    step = tasks.make_fit_decoder_step(model, sphere.get_directions(FIT_RES[1][1], device=device),
                                       sphere.get_sineweight(FIT_RES[1][1], device=device),
                                       kld_weighting=task.kld_weighting)
    names, leaves = zip(*tree_items(state.trainable))
    grads = {}
    real = state.optimizer.step

    def recorded():
        grads.update({n: p.grad.detach().cpu().numpy() for n, p in zip(names, leaves)})
        real()

    state.optimizer.step = recorded
    B, P = DEC_BATCH, images.shape[1] if mesh is None else FIT_RES[1][0] * FIT_RES[1][1]
    idx = torch.arange(B, device=device)
    bmask = torch.ones(B, device=device)
    gather = pmesh.shard_for_stage(state, mesh) if mesh is not None and mesh.n_model > 1 else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pmesh.kernel_mesh(mesh, P):
        state, m = step(state, (images, idx, bmask))
    torch.cuda.synchronize()
    if held is not None:
        held["ms"] = (time.perf_counter() - t0) * 1e3
        held.update({n: t.detach().cpu().numpy() for n, t in tree_items(state.trainable)})
    if gather is not None:
        gather()
    return ({k: v.item() for k, v in m.items()}, grads,
            {n: t.detach().cpu().numpy() for n, t in tree_items(state.trainable)})


def _mesh_part_step(part, device, mesh, res, arrays) -> None:
    """(a) one FIT_DECODER step of each conditioning on this rank's block of
    the 100 x 8,192 batch, twice from the same state."""
    from reni_tpu_torch.kernels import siren_step as ts

    batch = torch.from_numpy(np.load(part["batch"])).to(device)
    P = batch.shape[1]
    block = batch[mesh.rows(DEC_BATCH)][:, mesh.pixels(P)]
    for conf, entry in (("cbc", CBC), ("film", FILM)):
        model = _mesh_model(entry, device)
        counter = ts.film_step_cuda if model.config.is_film else ts.siren_step_cuda
        counter.launches = 0
        runs = []
        for _ in range(1 if part.get("once") else 2):
            params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
            runs.append(_step_grads(model, params, block, device, mesh))
        res[f"step_{conf}_launches"] = counter.launches
        res[f"step_{conf}_metrics"] = runs[0][0]
        res[f"step_{conf}_same_bits"] = runs[0][0] == runs[1][0] and all(
            np.array_equal(runs[0][i][k], runs[1][i][k]) for i in (1, 2) for k in runs[0][i])
        for i, what in ((1, "grad"), (2, "param")):
            arrays.update({f"step_{conf}/{what}/{k}": v for k, v in runs[0][i].items()})


def _mesh_part_fit(part, device, mesh, res, arrays) -> None:
    """(b) FIT_DECODER of the cbc configuration at stream_task_config on the
    1,000 seed-1 maps, resident and from disk in chunks of STREAM_CHUNK."""
    import functools

    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    train_dir = os.path.join(part["maps"], "Train")
    eager = datasets.get_dataset("RENI_HDR", train_dir, PUBLISHED_TRANSFORMS, True)
    lazy = datasets.get_dataset("RENI_HDR", train_dir, PUBLISHED_TRANSFORMS, True, lazy=True)
    decoded: list = []
    lock = threading.Lock()
    stage_row = lazy._stage_row

    def recorded(i, r):
        with lock:
            decoded.append(int(i))
        return stage_row(i, r)

    lazy._stage_row = recorded
    model = _mesh_model(CBC, device)
    task = stream_task_config()
    for label, images_at, kw in (
            ("resident", functools.partial(eager.images_at, device=device), {}),
            ("disk", lazy.row_source_at, dict(stream=True, stream_chunk=STREAM_CHUNK))):
        events: dict = {}

        def make_step(model, directions, sineweight, r):
            step = tasks.make_fit_decoder_step(model, directions, sineweight,
                                               kld_weighting=task.kld_weighting)
            return timed(step, events.setdefault(r, []))

        params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
        decoded.clear()
        torch.cuda.synchronize()
        ts.siren_step_cuda.launches = 0
        t0 = time.perf_counter()
        trained, metrics = tasks.fit_task(model, params, task, images_at,
                                          torch.Generator().manual_seed(1), mesh=mesh,
                                          step_builder=make_step, **kw)
        torch.cuda.synchronize()
        res[f"fit_{label}"] = {
            "wall_s": time.perf_counter() - t0, "launches": ts.siren_step_cuda.launches,
            "ms": {f"{r[0]}x{r[1]}": v for r, v in stage_ms(events).items()},
            "loss": [float(x) for x in metrics["fit_decoder_loss"]],
            "decoded": sorted(decoded)}
        arrays.update({f"fit_{label}/{k}": v
                       for k, v in ckpt._flatten(ckpt.fetch_tree(trained)).items()})
    eager.close()
    lazy.close()


def _mesh_part_decode(part, device, mesh, res, arrays) -> None:
    """(d) decode_sharded of the cbc entry's 21 test latents at WIDTH."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.parallel import mesh as pmesh

    cfg, dec, Z = load_entry(CBC, device)
    model = _mesh_model(CBC, device)
    D = sphere.get_directions(WIDTH, device=device)
    tk.fused_apply.launches = 0
    out = pmesh.decode_sharded(model, {"decoder": dec}, Z, D, mesh)
    torch.cuda.synchronize()
    res["decode_launches"] = tk.fused_apply.launches
    arrays["decode"] = out.cpu().numpy()


def _mesh_part_latent(part, device, mesh, res, arrays) -> None:
    """(c) FIT_LATENT with shard_latents on the cbc decoder, the 21 test maps."""
    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_step as ts

    test = datasets.get_dataset("RENI_HDR", os.path.join(part["maps"], "Test"),
                                PUBLISHED_TRANSFORMS, True)
    tb.siren_trunk_bwd_cuda.launches = ts.passes_forward.launches = 0
    params, metrics = mesh_fit_latent(device, test, mesh=mesh, shard_latents=True)
    res["latent_launches"] = {"siren_bwd": tb.siren_trunk_bwd_cuda.launches,
                              "fwd_passes": ts.passes_forward.launches}
    res["latent_loss"] = [float(x) for x in metrics["fit_latent_loss"]]
    arrays["latent/mu"] = params["latents"]["mu"].cpu().numpy()
    test.close()


def _mesh_part_trainer(part, device, mesh, res, arrays) -> None:
    """(e) the trainer's chain through run_with_retries on the 2 x 1 mesh."""
    from reni_tpu_torch.cli import run as cli_run
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts
    from reni_tpu_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(part["cfg"])
    counters = {"siren_step": ts.siren_step_cuda, "siren_bwd": tb.siren_trunk_bwd_cuda,
                "siren_fwd": tk.fused_apply, "fwd_passes": ts.passes_forward}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _, log_dir = cli_run.run_with_retries(cfg, mesh=part["mesh"], backend="gloo", device=DEVICE,
                                          retries=part.get("retries", 0))
    torch.cuda.synchronize()
    res["trainer"] = {"wall_s": time.perf_counter() - t0, "log_dir": log_dir,
                      "launches": {k: fn.launches for k, fn in counters.items()}}


MESH_PARTS = {"step": _mesh_part_step, "fit": _mesh_part_fit, "decode": _mesh_part_decode,
              "latent": _mesh_part_latent, "trainer": _mesh_part_trainer}  # + the tp phase's


def mesh_rank(work: str) -> None:
    """A rank of the mesh phase (``python chip_smoke.py --mesh-rank WORK``
    under torchrun's variables): joins the gloo group on the card, runs
    WORK/job.json's parts on its mesh and writes WORK/rank_<r>.json and
    .npz."""
    from reni_tpu_torch.parallel import mesh as pmesh
    from reni_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "job.json")) as f:
        job = json.load(f)
    multihost.initialize(backend="gloo", device=DEVICE)
    device = multihost.rank_device(DEVICE)
    mesh = pmesh.make_mesh(*job["mesh"], device=device)
    res, arrays = {"coords": [mesh.data_index, mesh.pixel_index, mesh.model_index]}, {}
    for part in job["parts"]:
        if part["kind"] == "trainer":
            MESH_PARTS["trainer"](part, device, mesh, res, arrays)
        else:
            t0 = time.perf_counter()
            MESH_PARTS[part["kind"]](part, device, mesh, res, arrays)
            res[f"{part['kind']}_s"] = time.perf_counter() - t0
    np.savez(os.path.join(work, f"rank_{mesh.rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank_{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.barrier("done")


def mesh_fit_latent(device, test, **kw):
    """FIT_LATENT of the cbc Zoo decoder on the 21 seed-1 test maps at
    STREAM_LATENT_EPOCHS (batch 21; on a data axis of 2 padded to 22)."""
    import functools

    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    task = dataclasses.replace(fit_task_config(False), epochs=STREAM_LATENT_EPOCHS,
                               curriculum=STREAM_LATENT_CURRICULUM)
    model = RENIModel(ckpt.load_model_config(os.path.join(CBC, "checkpoint"), fixed_decoder=True))
    params = ckpt.load_decoder_only(os.path.join(CBC, "checkpoint"), model, len(test),
                                    torch.Generator().manual_seed(0), device)
    return tasks.fit_task(model, params, task, functools.partial(test.images_at, device=device),
                          torch.Generator().manual_seed(1), **kw)


def decoder_psnr(model, params: dict, maps: torch.Tensor, device) -> float:
    """PSNR of a decoder's decodes of its latent table (mu, or Z) at the
    maps' grid (FIT_RES[1]) against the maps."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.params import map_tree

    params = map_tree(lambda t: torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                                                else t, device=device), params)
    D = sphere.get_directions(FIT_RES[1][1], device=device)
    with torch.no_grad():
        lat = model.latents(params)
        out = torch.cat([model.apply(params, z, D) for z in lat.split(DEC_BATCH)])
    check(bool(torch.isfinite(out).all()), "non-finite decodes")
    return psnr(out, maps)


def mesh_step_check(device, work: str, batch: np.ndarray, n_data: int, n_pixel: int,
                    parts: tuple = (), meanwhile=None) -> tuple[dict, dict, list, object]:
    """(a): ranks on an n_data x n_pixel mesh each run one FIT_DECODER step
    of both conditionings on their block of ``batch`` (100 x P) through the
    step kernel, then the job's further ``parts``; held against the
    single-device kernel step, run here meanwhile: the loss to
    STEP_LOSS_BAR relative, every gradient within BWD_BAR x max |single|
    (the bf16 step bar). Two calls give the same bits and the replicated
    leaves are bitwise equal on every rank after the optimizer's step (not
    held to the single-device step's leaves: Adam's first step is about lr x
    sign(g), which a gradient near zero flips). ``meanwhile()`` runs here
    too, before the wait. Returns the ranks' launches by conditioning, the
    single-device Cond-by-Concat step's gradients, every rank's (results,
    arrays) and what ``meanwhile`` returned."""
    path = os.path.join(work, "batch.npy")
    os.makedirs(work, exist_ok=True)
    np.save(path, batch)
    ranks = mesh_ranks(work, {"mesh": [n_data, n_pixel],
                              "parts": [{"kind": "step", "batch": path}, *parts]},
                       n_data * n_pixel)
    images = torch.from_numpy(batch).to(device)
    singles = {}
    for conf, entry in (("cbc", CBC), ("film", FILM)):
        model = _mesh_model(entry, device)
        params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
        singles[conf] = _step_grads(model, params, images, device)
    extra = meanwhile() if meanwhile is not None else None
    outs = mesh_wait(work, ranks)
    launches = {}
    bar = STEP_LOSS_BAR["bfloat16"]
    for conf in ("cbc", "film"):
        metrics, grads, _ = singles[conf]
        res0, arr0 = outs[0]
        rel = abs(res0[f"step_{conf}_metrics"]["loss"] - metrics["loss"]) / abs(metrics["loss"])
        worst = 0.0
        for k, v in grads.items():
            scale = max(float(np.abs(v).max()), 1e-30)
            err = float(np.abs(arr0[f"step_{conf}/grad/{k}"] - v).max()) / scale
            worst = max(worst, err)
            check(err <= BWD_BAR["bfloat16"],
                  f"mesh step {conf} gradient {k}: {err:.3g} x max |single| > the bf16 bar")
        check(rel <= bar, f"mesh step {conf}: loss off the single-device step by {rel:.3g}")
        equal = all(np.array_equal(arr[k], arr0[k]) for _, arr in outs for k in arr0
                    if k.startswith(f"step_{conf}/"))
        check(equal, f"mesh step {conf}: the ranks' gradients or leaves differ")
        check(all(r[f"step_{conf}_same_bits"] for r, _ in outs),
              f"mesh step {conf}: two calls did not give the same bits")
        launches[conf] = sum(r[f"step_{conf}_launches"] for r, _ in outs)
        check(launches[conf] == 2 * len(outs), f"mesh step {conf}: launches {launches[conf]}")
        print(f"mesh (a) {conf} step on {n_data} x {n_pixel} ranks, each "
              f"{DEC_BATCH // n_data} x {batch.shape[1] // n_pixel:,}: loss "
              f"{res0[f'step_{conf}_metrics']['loss']:.8g} vs single {metrics['loss']:.8g} "
              f"(rel {rel:.3g}); worst gradient {worst:.3g} x max |single|; two calls the same "
              f"bits; every rank's gradients and updated leaves the same bits")
    return launches, singles["cbc"][1], outs, extra


def mesh_phase(device, train, test, maps_root: str) -> dict:
    """The data x pixel mesh on the one card (ROADMAP A-11): ranks as
    processes on cuda:0, their collectives over gloo (NCCL refuses two ranks
    on one card); each rank launches the kernels on its own block. (a) a
    step of each conditioning on a 2 x 2 mesh; (b) FIT_DECODER on 2 x 2,
    resident and from disk in chunks; (d) decode_sharded on 4 ranks; then
    (c) FIT_LATENT with sharded latents on 2 x 1 and (e) the trainer's chain
    on 2 x 1 side by side; (f) an NCCL group of one rank in this process.
    Returns the ranks' launches under ``<kernel>@mesh``."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.parallel import mesh as pmesh
    from reni_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    work = os.path.join(maps_root, "mesh")
    print(f"mesh: every rank is a process on cuda:0 ({CARD}); the ranks share the one card and "
          f"their collectives go over gloo (NCCL takes one rank a card): the times below are "
          f"not scaling numbers")
    maps64 = train.images_at(FIT_RES[1], device=device)
    launches = {}
    cfg, dec, Z = load_entry(CBC, device)
    model = _mesh_model(CBC, device)
    maps_test = test.images_at(FIT_RES[1], device=device)

    def references():
        # the single-device runs of (c) and (d), while the ranks run
        with torch.no_grad():
            decode = model.apply({"decoder": dec}, Z, sphere.get_directions(WIDTH, device=device))
        torch.cuda.synchronize()
        latent, _ = mesh_fit_latent(device, test)
        return decode, decoder_psnr(model, latent, maps_test, device)

    # (a), (b) and (d) in one set of four ranks
    step_n, grads, outs, (plain_decode, psnr_latent_single) = mesh_step_check(
        device, os.path.join(work, "abd"), maps64[:DEC_BATCH].cpu().numpy(), 2, 2,
        parts=({"kind": "fit", "maps": maps_root}, {"kind": "decode"}), meanwhile=references)
    print("mesh (a), (b), (d) ranks' wall seconds by part: " + "; ".join(
        f"rank {r} " + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in res.items() if k.endswith("_s"))
        for r, (res, _) in enumerate(outs)))

    # (b)
    psnr_single = decoder_psnr(model, MESH_REFS["fit_decoder"], maps64, device)
    steps = STREAM_EPOCHS * (DEC_MAPS // DEC_BATCH)
    fit_n = 0
    for label in ("resident", "disk"):
        per_rank = [r[f"fit_{label}"] for r, _ in outs]
        trained = ckpt_unflatten({k[len(f"fit_{label}/"):]: v for k, v in outs[0][1].items()
                                  if k.startswith(f"fit_{label}/")})
        got = decoder_psnr(model, trained, maps64, device)
        n = [r["launches"] for r in per_rank]
        check(n == [steps] * 4, f"mesh (b) {label}: step-kernel launches {n}, {steps} a rank")
        fit_n += sum(n)
        for r, (res, arr) in enumerate(outs[1:], 1):
            check(all(np.array_equal(arr[k], outs[0][1][k]) for k in arr
                      if k.startswith(f"fit_{label}/")),
                  f"mesh (b) {label}: rank {r}'s trained params are not rank 0's")
        print(f"mesh (b) FIT_DECODER cbc {label} on 2 x 2 ({steps} steps, batch {DEC_BATCH}: "
              f"{DEC_BATCH // 2} rows x half the pixels a rank): PSNR at "
              f"{FIT_RES[1][0]}x{FIT_RES[1][1]} {got:.3f} dB vs the single-device resident run "
              f"{psnr_single:.3f} dB ({got - psnr_single:+.3f}); wall "
              f"{max(p['wall_s'] for p in per_rank):.1f} s; ms a step (median, start to start) "
              + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f}" for k, v in per_rank[0]["ms"].items())
              + f" (card {CARD})")
        check(abs(got - psnr_single) <= PSNR_BAR_DB,
              f"mesh (b) {label}: PSNR {got:.3f} vs {psnr_single:.3f} dB")
        if label == "disk":
            asked = STREAM_EPOCHS * DEC_MAPS // 2
            for r, (res, _) in enumerate(outs):
                d = res["coords"][0]
                mine = {b * DEC_BATCH + d * DEC_BATCH // 2 + i for b in range(DEC_MAPS // DEC_BATCH)
                        for i in range(DEC_BATCH // 2)}
                rows = res["fit_disk"]["decoded"]
                print(f"mesh (b) rank {r} (data {d}, pixel {res['coords'][1]}): DiskRowSource "
                      f"decoded {len(rows)} rows for the {asked} rows it was asked for, "
                      f"{len(set(rows))} distinct, all of its own data rank")
                check(set(rows) == mine, f"mesh (b) rank {r} decoded rows not its own")
    same = all(np.array_equal(outs[0][1][f"fit_disk/{k[len('fit_resident/'):]}"], v)
               for k, v in outs[0][1].items() if k.startswith("fit_resident/"))
    print(f"mesh (b) the disk run bit for bit the resident run: {same}")

    # (d)
    got = outs[0][1]["decode"]
    ref = plain_decode.cpu().numpy()
    for r, (_, arr) in enumerate(outs):
        check(np.array_equal(arr["decode"], got), f"mesh (d) rank {r}'s decode is not rank 0's")
    dec_n = sum(r["decode_launches"] for r, _ in outs)
    check(dec_n == 4, f"mesh (d) forward-kernel launches {dec_n}")
    if np.array_equal(got, ref):
        print(f"mesh (d) decode_sharded of the 21 test latents x {ref.shape[1]:,} directions on 4 "
              f"ranks ({ref.shape[1] // 4:,} each): bit for bit the single-device kernel decode")
    else:
        err = np.abs(got - ref)
        print(f"mesh (d) decode_sharded: not the single-device bits (max {err.max():.3g}, mean "
              f"{err.mean():.3g}): held to the forward bars")
        check(err.max() < MAX_ERR and err.mean() < MEAN_ERR, "mesh (d) off the forward bars")

    # (c) and (e) side by side, two ranks each
    cfg_path = os.path.join(work, "chain.json")
    chain = cli_config(maps_root, os.path.join(work, "runs"))
    chain.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT"]
    with open(cfg_path, "w") as f:
        json.dump(chain.to_dict(), f)
    ranks_c = mesh_ranks(os.path.join(work, "c"), {"mesh": [2, 1], "parts": [
        {"kind": "latent", "maps": maps_root}]}, 2)
    ranks_e = mesh_ranks(os.path.join(work, "e"), {"mesh": [2, 1], "parts": [
        {"kind": "trainer", "cfg": cfg_path, "mesh": "2x1"}]}, 2)
    outs_c = mesh_wait(os.path.join(work, "c"), ranks_c)
    outs_e = mesh_wait(os.path.join(work, "e"), ranks_e)
    mu = outs_c[0][1]["latent/mu"]
    check(mu.shape == (SEED_MAPS["test"], 49, 3), f"mesh (c) latent table {mu.shape}")
    check(np.array_equal(outs_c[1][1]["latent/mu"], mu), "mesh (c) ranks' latents differ")
    got = decoder_psnr(model, {"decoder": dec, "latents": {"mu": mu}}, maps_test, device)
    lat_n = {k: sum(r["latent_launches"][k] for r, _ in outs_c)
             for k in ("siren_bwd", "fwd_passes")}
    check(lat_n == {"siren_bwd": 2 * STREAM_LATENT_EPOCHS, "fwd_passes": 2 * STREAM_LATENT_EPOCHS},
          f"mesh (c) launches {lat_n}")
    print(f"mesh (c) FIT_LATENT on 2 x 1 with sharded latents (21 maps, batch padded to 22, "
          f"{STREAM_LATENT_EPOCHS} epochs): PSNR {got:.3f} dB vs single-device "
          f"{psnr_latent_single:.3f} dB ({got - psnr_latent_single:+.3f}); loss "
          f"{outs_c[0][0]['latent_loss'][0]:.6g} -> {outs_c[0][0]['latent_loss'][-1]:.6g}; "
          f"launches {lat_n}")
    check(abs(got - psnr_latent_single) <= PSNR_BAR_DB, f"mesh (c) PSNR {got:.3f}")

    # (e)
    log_dir = outs_e[0][0]["trainer"]["log_dir"]
    check(outs_e[1][0]["trainer"]["log_dir"] == log_dir, "mesh (e) ranks ran in two run dirs")
    runs = sorted(os.listdir(os.path.dirname(log_dir)))
    check(runs == ["version_0"], f"mesh (e) run dirs {runs}")
    rows = _cli_rows(log_dir)
    epochs = [r["step"] for r in rows if "fit_decoder_loss" in r]
    check(epochs == list(range(CLI_EVERY, CLI_CUTS["FIT_DECODER"][0] + 1, CLI_EVERY)),
          f"mesh (e) FIT_DECODER rows {epochs}: rank 0 alone writes one a segment")
    finals = _cli_finals(log_dir, ("FIT_DECODER", "FIT_LATENT"))
    ref = MESH_REFS["cli_finals"]
    dec_model = _mesh_model(CBC, device)
    for task, maps in (("FIT_DECODER", maps64), ("FIT_LATENT", maps_test)):
        a = decoder_psnr(dec_model, ckpt_unflatten(ref[task]), maps, device)
        b = decoder_psnr(dec_model, ckpt_unflatten(finals[task]), maps, device)
        print(f"mesh (e) the trainer's {task} final on 2 x 1: PSNR {b:.3f} dB vs cli_run's run A "
              f"{a:.3f} dB ({b - a:+.3f})")
        check(abs(b - a) <= PSNR_BAR_DB, f"mesh (e) {task} PSNR {b:.3f} vs {a:.3f}")
    trainer_n = [r["trainer"]["launches"] for r, _ in outs_e]
    print(f"mesh (e) chain wall {max(r['trainer']['wall_s'] for r, _ in outs_e):.1f} s; launches "
          f"by rank {trainer_n}")
    dsteps = CLI_CUTS["FIT_DECODER"][0] * DEC_MAPS // DEC_BATCH
    check(all(n["siren_step"] == dsteps for n in trainer_n), f"mesh (e) step launches {trainer_n}")

    # (f) NCCL with one rank, in this process
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multihost.initialize(device="cuda")
        check(torch.distributed.get_backend() == "nccl", "multihost chose another backend")
        grads = [torch.from_numpy(v).to(device) for v in grads.values()]
        bucket = [g.clone() for g in grads]
        pmesh.all_reduce_sum(bucket, torch.distributed.group.WORLD)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(bucket, grads)),
              "mesh (f) an NCCL all_reduce over one rank changed the bits")
        print(f"mesh (f) NCCL group of one rank through multihost.initialize: the "
              f"single-device step's gradients ({sum(g.numel() for g in grads):,} values, "
              f"{sum(g.numel() for g in grads) * 4 / 1e6:.2f} MB) through all_reduce unchanged")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    total = time.perf_counter() - t0
    print(f"mesh phase wall {total:.1f} s")
    trainer = {k: sum(n[k] for n in trainer_n) for k in trainer_n[0]}
    return {"siren_step@mesh": step_n["cbc"] + fit_n + trainer["siren_step"],
            "film_step@mesh": step_n["film"],
            "siren_fwd@mesh": dec_n + trainer["siren_fwd"],
            "siren_bwd@mesh": lat_n["siren_bwd"] + trainer["siren_bwd"]}


# ---------------------------------------------------------------------------
# tp: the tensor-parallel model axis (ROADMAP A-11b)
# ---------------------------------------------------------------------------


def _tp_model(entry: str, device, **over):
    """A Zoo entry's model config as the trainer runs it on a model axis:
    use_pallas off (the kernels take whole weights, as JAX's do)."""
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt

    return RENIModel(ckpt.load_model_config(os.path.join(entry, "checkpoint"), use_pallas=False,
                                            **over))


def _kernel_launches() -> int:
    """Every kernel wrapper's count, summed (none may launch on a model axis)."""
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    return sum(fn.launches for fn in (tk.fused_apply, tk.fused_film_apply, tb.siren_trunk_bwd_cuda,
                                      tb.film_trunk_bwd_cuda, ts.siren_step_cuda,
                                      ts.film_step_cuda, ts.passes_forward))


def _mesh_part_tp_step(part, device, mesh, res, arrays) -> None:
    """tp (a): one FIT_DECODER step of each conditioning through the sharded
    plain decoder on the whole 100 x 8,192 batch, twice from the same state
    (once with ``part["once"]``)."""
    batch = torch.from_numpy(np.load(part["batch"])).to(device)
    before = _kernel_launches()
    for conf, entry in (("cbc", CBC), ("film", FILM)):
        model = _tp_model(entry, device)
        runs, held = [], []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(1 if part.get("once") else 2):
            params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
            held.append({})
            runs.append(_step_grads(model, params, batch, device, mesh, held[-1]))
        res[f"tp_{conf}_metrics"] = runs[0][0]
        res[f"tp_{conf}_ms"] = [h.pop("ms") for h in held]
        res[f"tp_{conf}_peak_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                                     if device.type == "cuda" else 0.0)
        res[f"tp_{conf}_same_bits"] = None if len(runs) == 1 else runs[0][0] == runs[1][0] and all(
            np.array_equal(runs[0][i][k], runs[1][i][k]) for i in (1, 2) for k in runs[0][i])
        for what, tree in (("grad", runs[0][1]), ("param", runs[0][2]), ("held", held[0])):
            arrays.update({f"tp_{conf}/{what}/{k}": v for k, v in tree.items()})
    res["tp_step_launches"] = _kernel_launches() - before


def tp_task_config():
    """tp (b): FIT_DECODER as decoder_task_config, cut to TP_FIT_EPOCHS at
    16x32 (a 32x64 step through gloo takes 0.9-1.3 s on 2 x 1 x 2)."""
    return dataclasses.replace(decoder_task_config(), epochs=TP_FIT_EPOCHS,
                               multi_res_training=False, final_resolution=FIT_RES[0])


def _mesh_part_tp_fit(part, device, mesh, res, arrays) -> None:
    """tp (b): FIT_DECODER cbc on 2 x 1 x 2, resident and from disk in
    chunks of STREAM_CHUNK."""
    import functools

    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    train_dir = os.path.join(part["maps"], "Train")
    eager = datasets.get_dataset("RENI_HDR", train_dir, PUBLISHED_TRANSFORMS, True)
    lazy = datasets.get_dataset("RENI_HDR", train_dir, PUBLISHED_TRANSFORMS, True, lazy=True)
    model = _tp_model(CBC, device)
    task = tp_task_config()
    before = _kernel_launches()
    for label, images_at, kw in (
            ("resident", functools.partial(eager.images_at, device=device), {}),
            ("disk", lazy.row_source_at, dict(stream=True, stream_chunk=STREAM_CHUNK))):
        events: dict = {}

        def make_step(model, directions, sineweight, r):
            step = tasks.make_fit_decoder_step(model, directions, sineweight,
                                               kld_weighting=task.kld_weighting)
            return timed(step, events.setdefault(r, []))

        params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained, metrics = tasks.fit_task(model, params, task, images_at,
                                          torch.Generator().manual_seed(1), mesh=mesh,
                                          step_builder=make_step, **kw)
        torch.cuda.synchronize()
        res[f"tp_fit_{label}"] = {
            "wall_s": time.perf_counter() - t0,
            "ms": {f"{r[0]}x{r[1]}": v for r, v in stage_ms(events).items()},
            "loss": [float(x) for x in metrics["fit_decoder_loss"]]}
        arrays.update({f"tp_fit_{label}/{k}": v
                       for k, v in ckpt._flatten(ckpt.fetch_tree(trained)).items()})
    res["tp_fit_launches"] = _kernel_launches() - before
    eager.close()
    lazy.close()


def tp_latent_task_config():
    """tp (c): FIT_LATENT as fit_task_config, cut to one epoch at 16x32 and
    one at 32x64."""
    return dataclasses.replace(fit_task_config(False), epochs=TP_FIT_EPOCHS,
                               curriculum=TP_FIT_CURRICULUM, final_resolution=TP_FIT_RES)


def tp_fit_latent(device, test, **kw):
    """FIT_LATENT of the cbc Zoo decoder (plain) on the 21 test maps at
    tp_latent_task_config."""
    import functools

    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    model = _tp_model(CBC, device, fixed_decoder=True)
    params = ckpt.load_decoder_only(os.path.join(CBC, "checkpoint"), model, len(test),
                                    torch.Generator().manual_seed(0), device)
    return tasks.fit_task(model, params, tp_latent_task_config(),
                          functools.partial(test.images_at, device=device),
                          torch.Generator().manual_seed(1), **kw)


def _mesh_part_tp_latent(part, device, mesh, res, arrays) -> None:
    """tp (c): FIT_LATENT on 1 x 1 x 2 with the frozen decoder sharded."""
    from reni_tpu_torch.data import datasets

    test = datasets.get_dataset("RENI_HDR", os.path.join(part["maps"], "Test"),
                                PUBLISHED_TRANSFORMS, True)
    before = _kernel_launches()
    t0 = time.perf_counter()
    params, metrics = tp_fit_latent(device, test, mesh=mesh)
    torch.cuda.synchronize()
    res["tp_latent"] = {"wall_s": time.perf_counter() - t0,
                        "loss": [float(x) for x in metrics["fit_latent_loss"]],
                        "launches": _kernel_launches() - before}
    arrays["tp_latent/mu"] = params["latents"]["mu"].cpu().numpy()
    test.close()


MESH_PARTS.update(tp_step=_mesh_part_tp_step, tp_fit=_mesh_part_tp_fit,
                  tp_latent=_mesh_part_tp_latent)


def _whole_grads(outs, conf: str, n_model: int) -> tuple[dict, dict]:
    """Rank slices' gradients of tp (a) put together along each leaf's
    model dim (``state_sharding``'s spec), by model coordinate."""
    from reni_tpu_torch.parallel import mesh as pmesh

    arr0 = outs[0][1]
    names = [k[len(f"tp_{conf}/grad/"):] for k in arr0 if k.startswith(f"tp_{conf}/grad/")]
    whole_params = {k: arr0[f"tp_{conf}/param/{k}"] for k in names}
    specs = pmesh.state_sharding(pmesh.Mesh(1, 1, n_model), ckpt_unflatten(whole_params),
                                 shard_model=True)
    by_m = sorted(outs, key=lambda o: o[0]["coords"][2])
    out = {}
    for k in names:
        spec = specs[k]
        parts = [arr[f"tp_{conf}/grad/{k}"] for _, arr in by_m]
        out[k] = np.concatenate(parts, axis=spec.index("model")) if "model" in spec else parts[0]
    return out, specs


def tp_step_check(device, work: str, n_model: int, singles: dict, batch_path: str,
                  parts: tuple = (), once: bool = False) -> list:
    """tp (a) on a 1 x 1 x n_model mesh: each rank's step against the
    single-device plain step (``singles``): the loss to TP_LOSS_BAR
    relative, every gradient put together from the ranks' slices within
    TP_GRAD_BAR x max |single|; two calls the same bits (one call with
    ``once``); the replicated leaves' gradients and every updated leaf the
    same bits on every rank, and each rank's updated slice the same bits as
    its part of the gathered leaf. Then the job's further ``parts``.
    Returns every rank's (results, arrays)."""
    ranks = mesh_ranks(work, {"mesh": [1, 1, n_model], "parts": [
        {"kind": "tp_step", "batch": batch_path, "once": once}, *parts]}, n_model)
    outs = mesh_wait(work, ranks)
    for conf in ("cbc", "film"):
        metrics, grads, _, single_ms = singles[conf]
        res0, arr0 = outs[0]
        rel = abs(res0[f"tp_{conf}_metrics"]["loss"] - metrics["loss"]) / abs(metrics["loss"])
        whole, specs = _whole_grads(outs, conf, n_model)
        worst = 0.0
        for k, v in grads.items():
            err = float(np.abs(whole[k] - v).max()) / max(float(np.abs(v).max()), 1e-30)
            worst = max(worst, err)
            check(err <= TP_GRAD_BAR, f"tp (a) {conf} on 1x1x{n_model}: gradient {k} off by "
                                      f"{err:.3g} x max |single|")
        check(rel <= TP_LOSS_BAR, f"tp (a) {conf} on 1x1x{n_model}: loss off by {rel:.3g}")
        check(once or all(r[f"tp_{conf}_same_bits"] for r, _ in outs),
              f"tp (a) {conf}: two calls did not give the same bits")
        for r, (res, arr) in enumerate(outs):
            m = res["coords"][2]
            for k, spec in specs.items():
                g = arr[f"tp_{conf}/grad/{k}"]
                if "model" not in spec:
                    check(np.array_equal(g, arr0[f"tp_{conf}/grad/{k}"]),
                          f"tp (a) {conf}: rank {r}'s gradient of the replicated {k} differs")
                p = arr[f"tp_{conf}/param/{k}"]
                check(np.array_equal(p, arr0[f"tp_{conf}/param/{k}"]),
                      f"tp (a) {conf}: rank {r}'s gathered {k} is not rank 0's")
                mine = arr[f"tp_{conf}/held/{k}"]
                if "model" in spec:
                    d = spec.index("model")
                    n = p.shape[d] // n_model
                    p = np.take(p, range(m * n, (m + 1) * n), axis=d)
                check(np.array_equal(mine, p),
                      f"tp (a) {conf}: rank {r}'s updated slice of {k} is not its part of the "
                      "gathered leaf")
        H = 256
        mb = DEC_BATCH * batch_pixels(batch_path) * H * 4 / 1e6
        ms = [r[f"tp_{conf}_ms"] for r, _ in outs]
        print(f"tp (a) {conf} step on 1 x 1 x {n_model} ranks ({DEC_BATCH} x "
              f"{batch_pixels(batch_path):,}, H {H // n_model} columns a rank): loss "
              f"{res0[f'tp_{conf}_metrics']['loss']:.8g} vs the single-device plain step "
              f"{metrics['loss']:.8g} (rel {rel:.3g}); worst gradient {worst:.3g} x max |single|; "
              + ("one call" if once else "two calls the same bits")
              + f"; replicated gradients and every gathered leaf the same bits on every rank; "
              f"a model reduction moves {mb:.1f} MB; ms a step by rank "
              + "; ".join(f"{r}: " + ", ".join(f"{x:.1f}" for x in v) for r, v in enumerate(ms))
              + f" (single plain {single_ms:.1f}; gloo through the host, card {CARD}); peak "
              + f"{max(r[f'tp_{conf}_peak_gb'] for r, _ in outs):.1f} GB allocated a rank")
    n = sum(r["tp_step_launches"] for r, _ in outs)
    check(n == 0, f"tp (a): {n} kernel launches under the model axis")
    return outs


def batch_pixels(path: str) -> int:
    """Pixels of the saved tp (a) batch (100, P, 3)."""
    return int(np.load(path, mmap_mode="r").shape[1])


def tp_chain_config(maps_root: str, runs: str):
    """tp (d): cli_config's chain cut to TP_CHAIN_CUTS, TPU.USE_PALLAS as
    published (the trainer turns it off on the model axis), a checkpoint
    every epoch."""
    cfg = cli_config(maps_root, runs)
    for task, (epochs, curriculum, final) in TP_CHAIN_CUTS.items():
        t = cfg.RENI[task]
        t.EPOCHS = epochs
        if curriculum is None:
            t.MULTI_RES_TRAINING = False
        else:
            t.CURRICULUM = curriculum
        if final is not None:
            t.FINAL_RESOLUTION = final
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 1
    cfg.TRAINER.LOGGER.LOG_IMAGES = False
    cfg.TRAINER.LOGGER.TB.LOG_GRAPH = False  # cli_run covers the graph; 4-12 s a process
    return cfg


def _write_config(cfg, path: str) -> str:
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    return path


def _kill_at(procs, latest: str, limit_s: float) -> int:
    """SIGKILL every rank of ``procs`` once ``latest`` (a checkpoint's
    .json) reports an epoch; returns it."""
    import signal

    limit = time.monotonic() + limit_s
    epoch = None
    while epoch is None and time.monotonic() < limit:
        try:
            with open(latest) as f:
                epoch = int(json.load(f)["epoch"])
        except (OSError, ValueError, KeyError):
            time.sleep(0.005)
    for p, log in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
        log.close()
    check(epoch is not None, f"tp (d): {latest} never reported an epoch")
    return epoch


def tp_phase(device, train, test, maps_root: str) -> None:
    """The tensor-parallel model axis on the one card (ROADMAP A-11b): ranks
    as processes on cuda:0, their collectives over gloo; the decoder is the
    sharded plain decoder (parallel/tp.py), the kernels declined as in JAX.
    (b) FIT_DECODER cbc on 2 x 1 x 2, resident and from disk in chunks, and
    (d) the trainer's chain on --mesh 1x1x2 uncut and killed then
    relaunched, side by side; beside them (a) one FIT_DECODER step of the
    cbc (5x256) and FiLM (mapping 3x256) Zoo configurations at 100 x 8,192
    on 1 x 1 x 2 against the single-device plain step, and (c) FIT_LATENT
    with the frozen decoder sharded on 1 x 1 x 2 (in (a)'s ranks); then (a)
    on 1 x 1 x 4, alone, one call. Each
    trained run within PSNR_BAR_DB of its single-device plain run; the
    relaunched chain bit for bit the uncut one. Times are not scaling
    numbers."""
    import functools

    from reni_tpu_torch.cli import run as cli_run
    from reni_tpu_torch.train import tasks

    t0 = time.perf_counter()
    work = os.path.join(maps_root, "tp")
    os.makedirs(work, exist_ok=True)
    print(f"tp: every rank is a process on cuda:0 ({CARD}); the model axis' reductions go "
          f"through gloo and the host: the times below are not scaling numbers")
    maps64 = train.images_at(FIT_RES[1], device=device)
    maps_test = test.images_at(FIT_RES[1], device=device)
    batch_path = os.path.join(work, "batch.npy")
    np.save(batch_path, maps64[:DEC_BATCH].cpu().numpy())

    # (a)'s single-device plain steps, then the plain references of (b)-(d)
    singles = {}
    for conf, entry in (("cbc", CBC), ("film", FILM)):
        model = _tp_model(entry, device)
        params = model.init(torch.Generator().manual_seed(0), DEC_MAPS, device=device)
        held: dict = {}
        singles[conf] = _step_grads(model, params, maps64[:DEC_BATCH], device, held=held) + (
            held["ms"],)
    torch.cuda.empty_cache()
    model = _tp_model(CBC, device)
    plain_b, _ = tasks.fit_task(model, model.init(torch.Generator().manual_seed(0), DEC_MAPS,
                                                  device=device), tp_task_config(),
                                functools.partial(train.images_at, device=device),
                                torch.Generator().manual_seed(1))
    psnr_b = decoder_psnr(model, plain_b, maps64, device)
    plain_c, _ = tp_fit_latent(device, test)
    psnr_c = decoder_psnr(model, plain_c, maps_test, device)
    chain = tp_chain_config(maps_root, os.path.join(work, "plain"))
    chain.TPU.USE_PALLAS = False
    plain_path = _write_config(chain, os.path.join(work, "plain.json"))
    torch.cuda.empty_cache()

    # (b), (d) uncut and (d) killed first, side by side; the killed chain's relaunch
    # and (a) with (c) on 1 x 1 x 2 run beside them, the plain chain here meanwhile
    cfg_uncut = _write_config(tp_chain_config(maps_root, os.path.join(work, "uncut")),
                              os.path.join(work, "uncut.json"))
    killed_cfg = tp_chain_config(maps_root, os.path.join(work, "killed"))
    cfg_killed = _write_config(killed_cfg, os.path.join(work, "killed.json"))
    killed_dir = cli_run._experiment_runs(killed_cfg)[1]  # its version_0, before it starts
    ranks_b = mesh_ranks(os.path.join(work, "b"), {"mesh": [2, 1, 2], "parts": [
        {"kind": "tp_fit", "maps": maps_root}]}, 4)
    trainer = {"kind": "trainer", "mesh": "1x1x2", "retries": 1}
    ranks_u = mesh_ranks(os.path.join(work, "d_uncut"), {"mesh": [1, 1, 2], "parts": [
        dict(trainer, cfg=cfg_uncut)]}, 2)
    ranks_k = mesh_ranks(os.path.join(work, "d_killed"), {"mesh": [1, 1, 2], "parts": [
        dict(trainer, cfg=cfg_killed)]}, 2)
    killed = _kill_at(ranks_k, os.path.join(killed_dir, "checkpoints", "fit_decoder_latest.json"),
                      MESH_CHILD_S)
    ranks_r = mesh_ranks(os.path.join(work, "d_relaunched"), {"mesh": [1, 1, 2], "parts": [
        dict(trainer, cfg=cfg_killed)]}, 2)
    t_plain = time.perf_counter()
    check(cli_run.cli(["--cfg_path", plain_path] + ([] if device.type == "cuda" else [
        "--device", "cpu"])) == 0, "tp (d): the plain chain failed")
    plain_s = time.perf_counter() - t_plain
    plain_log = cli_run._experiment_runs(chain)[0]

    # (a) and (c) on 1 x 1 x 2
    outs2 = tp_step_check(device, os.path.join(work, "a2"), 2, singles, batch_path,
                          parts=({"kind": "tp_latent", "maps": maps_root},))
    mu = outs2[0][1]["tp_latent/mu"]
    check(np.array_equal(outs2[1][1]["tp_latent/mu"], mu), "tp (c): the ranks' latents differ")
    got = decoder_psnr(model, {"decoder": plain_c["decoder"], "latents": {"mu": torch.from_numpy(
        mu).to(device)}}, maps_test, device)
    lat = outs2[0][0]["tp_latent"]
    print(f"tp (c) FIT_LATENT on 1 x 1 x 2, the frozen decoder sharded ({TP_FIT_EPOCHS} epochs, "
          f"{FIT_RES[0][0]}x{FIT_RES[0][1]} and {TP_FIT_RES[0]}x{TP_FIT_RES[1]}): PSNR "
          f"{got:.3f} dB vs the single-device plain run {psnr_c:.3f} dB ({got - psnr_c:+.3f}); "
          f"loss {lat['loss'][0]:.6g} -> {lat['loss'][-1]:.6g}; wall {lat['wall_s']:.1f} s")
    check(abs(got - psnr_c) <= PSNR_BAR_DB, f"tp (c) PSNR {got:.3f} vs {psnr_c:.3f}")
    check(all(r["tp_latent"]["launches"] == 0 for r, _ in outs2), "tp (c) launched a kernel")

    outs_b = mesh_wait(os.path.join(work, "b"), ranks_b)
    outs_u = mesh_wait(os.path.join(work, "d_uncut"), ranks_u)
    outs_r = mesh_wait(os.path.join(work, "d_relaunched"), ranks_r)

    # (a) on 1 x 1 x 4, alone on the card (four ranks of the 100 x 8,192 step),
    # one call: 1 x 1 x 2 checked that two calls give the same bits
    tp_step_check(device, os.path.join(work, "a4"), 4, singles, batch_path, once=True)

    # (b)
    fit = {}
    for label in ("resident", "disk"):
        trained = ckpt_unflatten({k[len(f"tp_fit_{label}/"):]: v for k, v in outs_b[0][1].items()
                                  if k.startswith(f"tp_fit_{label}/")})
        for r, (_, arr) in enumerate(outs_b[1:], 1):
            check(all(np.array_equal(arr[k], outs_b[0][1][k]) for k in arr
                      if k.startswith(f"tp_fit_{label}/")),
                  f"tp (b) {label}: rank {r}'s trained params are not rank 0's")
        fit[label] = decoder_psnr(model, trained, maps64, device)
        per_rank = [r[f"tp_fit_{label}"] for r, _ in outs_b]
        print(f"tp (b) FIT_DECODER cbc {label} on 2 x 1 x 2 ({TP_FIT_EPOCHS} epochs of "
              f"{DEC_MAPS // DEC_BATCH} steps at {FIT_RES[0][0]}x{FIT_RES[0][1]}, "
              f"{DEC_BATCH // 2} rows and 128 columns a rank; a model reduction moves "
              f"{DEC_BATCH // 2 * FIT_RES[0][0] * FIT_RES[0][1] * 256 * 4 / 1e6:.1f} MB): PSNR at "
              f"{FIT_RES[1][0]}x{FIT_RES[1][1]} {fit[label]:.3f} dB vs the single-device plain "
              f"run {psnr_b:.3f} dB ({fit[label] - psnr_b:+.3f}); wall "
              f"{max(p['wall_s'] for p in per_rank):.1f} s; ms a step (median) "
              + "; ".join(f"{k} {v[0]:.1f}" for k, v in per_rank[0]["ms"].items())
              + f" (card {CARD})")
        check(abs(fit[label] - psnr_b) <= PSNR_BAR_DB, f"tp (b) {label} PSNR {fit[label]:.3f}")
    same = all(np.array_equal(outs_b[0][1][f"tp_fit_disk/{k[len('tp_fit_resident/'):]}"], v)
               for k, v in outs_b[0][1].items() if k.startswith("tp_fit_resident/"))
    print(f"tp (b) the disk run bit for bit the resident run: {same}")
    check(same, "tp (b): the disk run is not the resident run bit for bit")
    check(all(r["tp_fit_launches"] == 0 for r, _ in outs_b), "tp (b) launched a kernel")

    # (d)
    log_u = outs_u[0][0]["trainer"]["log_dir"]
    log_r = outs_r[0][0]["trainer"]["log_dir"]
    check(log_r == killed_dir and os.listdir(os.path.dirname(log_r)) == ["version_0"],
          f"tp (d): the relaunch ran in {log_r}, not the killed run's {killed_dir}")
    with open(os.path.join(work, "d_relaunched", "rank_0.log")) as f:
        text = f.read()
    check("[relaunch] adopting" in text, "tp (d): the relaunch did not adopt the killed run")
    with open(os.path.join(work, "d_uncut", "rank_0.log")) as f:
        check("TPU.USE_PALLAS off on the model axis" in f.read(),
              "tp (d): no line says USE_PALLAS is off on the model axis")
    fu, fr, fp = (_cli_finals(d) for d in (log_u, log_r, plain_log))
    bitwise = {t: fu[t].keys() == fr[t].keys() and all(np.array_equal(fu[t][k], fr[t][k])
                                                         for k in fu[t]) for t in CLI_TASKS}
    print(f"tp (d) the chain on --mesh 1x1x2, killed at FIT_DECODER epoch {killed} and "
          f"relaunched with --retries 1: finals bit for bit the uncut chain's: {bitwise}")
    for task in ("FIT_DECODER", "FIT_LATENT"):
        check(bitwise[task], f"tp (d) {task}: the relaunch's final is not the uncut chain's")
    if not bitwise["FIT_INVERSE"]:
        a, b = fu["FIT_INVERSE"]["latents/mu"], fr["FIT_INVERSE"]["latents/mu"]
        rel = float(np.abs(b - a).max() / np.abs(a).max())
        print(f"tp (d) FIT_INVERSE final latents, relaunch vs uncut: {rel:.3g} of max |uncut|")
        check(rel <= CLI_INVERSE_BAR, f"tp (d) FIT_INVERSE finals differ by {rel:.3g}")
    for task, maps in (("FIT_DECODER", maps64), ("FIT_LATENT", maps_test),
                       ("FIT_INVERSE", maps_test)):
        a = decoder_psnr(model, ckpt_unflatten(fp[task]), maps, device)
        b = decoder_psnr(model, ckpt_unflatten(fu[task]), maps, device)
        print(f"tp (d) {task} final on 1 x 1 x 2: PSNR {b:.3f} dB vs the single-device plain "
              f"chain {a:.3f} dB ({b - a:+.3f})")
        check(abs(b - a) <= PSNR_BAR_DB, f"tp (d) {task} PSNR {b:.3f} vs {a:.3f}")
    n = [r["trainer"]["launches"] for r, _ in outs_u + outs_r]
    check(all(sum(x.values()) == 0 for x in n), f"tp (d) kernel launches {n}")
    print(f"tp (d) chain walls: uncut {max(r['trainer']['wall_s'] for r, _ in outs_u):.1f} s, "
          f"relaunch {max(r['trainer']['wall_s'] for r, _ in outs_r):.1f} s, the plain chain "
          f"here {plain_s:.1f} s")
    print(f"tp phase wall {time.perf_counter() - t0:.1f} s; kernel launches under the model "
          f"axis: 0 (declined, as in JAX)")


# ---------------------------------------------------------------------------
# faults: the chip lock, the yield, the RSS exit, the watchdog, the
# precompiler (ROADMAP A-13)
# ---------------------------------------------------------------------------


def _trainer_proc(device, cfg_path: str, log: str, env: dict) -> subprocess.Popen:
    """``python -m reni_tpu_torch.cli.run --cfg_path CFG --retries 1`` with
    ``env`` added, its output in ``log``."""
    cmd = [sys.executable, "-m", "reni_tpu_torch.cli.run", "--cfg_path", cfg_path,
           "--retries", "1"] + ([] if device.type == "cuda" else ["--device", "cpu"])
    out = open(log, "w")
    p = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, **env), stdout=out,
                         stderr=subprocess.STDOUT, start_new_session=True)
    p.log = out
    return p


def _trainer_wait(p: subprocess.Popen) -> tuple[int, str]:
    import signal

    try:
        rc = p.wait(timeout=CLI_PROBE_S)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=60)
        p.log.close()
    with open(p.log.name) as f:
        return rc, f.read()


def _events(log_dir: str) -> list:
    return [r for r in _cli_rows(log_dir) if "event" in r]


def _config_written(runs: str) -> bool:
    """Has a trainer made its run dir under ``runs`` (main writes its
    config.json once run_with_retries holds the chip lock)?"""
    return any("config.json" in files for _, _, files in os.walk(runs))


def faults_phase(device, maps_root: str) -> None:
    """The trainer's fault machinery (utils/chiplock.py, the hang watchdog,
    RENI_TPU_RSS_EXIT_GB, TPU.PRECOMPILE) single-process on the card, on
    cli_run's configuration and its FIT_DECODER at that cut, each run a
    ``python -m reni_tpu_torch.cli.run --retries 1`` process, in two waves.
    First, side by side: a stop file makes one run checkpoint and exit 115,
    an RSS bound below its RSS makes another exit 114 (the lock off for
    both), and a third run holds the chip lock under
    RENI_TPU_HANG_EXIT_S=30 (no hang exit) while a fourth, with
    TPU.PRECOMPILE, is launched once the lock is held and waits for it.
    Then, beside that fourth run, the first two's relaunches. The holder,
    the waiter and each relaunch end bit for bit at cli_run's run A."""
    t0 = time.perf_counter()
    work = os.path.join(maps_root, "faults")
    os.makedirs(work, exist_ok=True)
    ref = MESH_REFS["cli_finals"]["FIT_DECODER"]
    runs = {}
    for name in ("stop", "rss", "holder", "second"):
        cfg = cli_config(maps_root, os.path.join(work, name))
        cfg.RENI.TASKS = ["FIT_DECODER"]
        cfg.TRAINER.LOGGER.LOG_IMAGES = False
        cfg.TRAINER.LOGGER.TB.LOG_GRAPH = False  # cli_run covers the graph; 4-12 s a process
        cfg.TPU.PRECOMPILE = name == "second"
        runs[name] = (cfg, _write_config(cfg, os.path.join(work, f"{name}.json")))

    def final(cfg) -> bool:
        log_dir = _cli_finals_dir(cfg)
        with np.load(os.path.join(log_dir, "checkpoints", "fit_decoder_final.npz")) as z:
            got = {k: z[k] for k in z.files}
        return got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)

    def launch(name: str, log: str, env: dict) -> subprocess.Popen:
        return _trainer_proc(device, runs[name][1], os.path.join(work, log), env)

    stop = os.path.join(work, "stop_file")
    open(stop, "w").close()
    off = {"RENI_TPU_CHIP_LOCK": ""}
    lock = os.path.join(work, "chip.lock")
    first = {"stop": launch("stop", "stop_1.log", dict(off, RENI_TPU_STOP_FILE=stop)),
             "rss": launch("rss", "rss_1.log", dict(off, RENI_TPU_RSS_EXIT_GB="0.001")),
             "holder": launch("holder", "holder.log", {"RENI_TPU_CHIP_LOCK": lock,
                                                       "RENI_TPU_HANG_EXIT_S": "30"})}
    limit = time.monotonic() + CLI_PROBE_S
    holder_runs = runs["holder"][0].TRAINER.LOGGER.TB.SAVE_DIR
    while (first["holder"].poll() is None and not _config_written(holder_runs)
           and time.monotonic() < limit):
        time.sleep(0.05)
    second = launch("second", "second.log", {"RENI_TPU_CHIP_LOCK": lock})
    got = {k: _trainer_wait(p) for k, p in first.items()}
    check(got["stop"][0] == 115, f"faults: the stop-file run exited {got['stop'][0]}:\n"
                                 f"{got['stop'][1][-2000:]}")
    check(not os.path.exists(stop), "faults: the yield did not consume the stop file")
    check(got["rss"][0] == 114, f"faults: the RSS run exited {got['rss'][0]}:\n"
                                f"{got['rss'][1][-2000:]}")
    check(got["holder"][0] == 0, f"faults: the lock's holder exited {got['holder'][0]}:\n"
                                 f"{got['holder'][1][-2000:]}")
    for name, event in (("stop", "chip_yield"), ("rss", "rss_exit")):
        ev = _events(_cli_finals_dir(runs[name][0]))
        check([e["event"] for e in ev] == [event], f"faults: {name} events {ev}")
        print(f"faults: {name} run exited {got[name][0]} at FIT_DECODER epoch {ev[0]['epoch']} "
              f"after its checkpoint ({event}"
              + (f", RSS {ev[0]['rss_gb']} GB" if name == "rss" else "") + ")")
    relaunch = {k: launch(k, f"{k}_2.log", off) for k in ("stop", "rss")}
    done = {k: _trainer_wait(p) for k, p in relaunch.items()}
    rc2, text2 = _trainer_wait(second)
    for k, (rc, text) in done.items():
        check(rc == 0 and "[relaunch] adopting" in text, f"faults: {k}'s relaunch exited {rc} "
                                                          f"or did not adopt:\n{text[-2000:]}")
        check(final(runs[k][0]), f"faults: {k}'s relaunch is not cli_run's run A bit for bit")
    events = [e["event"] for e in _events(_cli_finals_dir(runs["stop"][0]))]
    check(events == ["chip_yield", "relaunch_adopt"], f"faults: the stop run's events {events}")
    check(_events(_cli_finals_dir(runs["holder"][0])) == [],
          "faults: the lock's holder logged an event (a hang exit?)")
    check(final(runs["holder"][0]), "faults: the lock's holder is not run A bit for bit")
    check(rc2 == 0 and "waiting for chip lock" in text2,
          f"faults: the second launch exited {rc2} or did not wait for the lock:\n{text2[-2000:]}")
    # the lock's holder releases it after its last write, its final checkpoint
    t_end = os.path.getmtime(os.path.join(_cli_finals_dir(runs["holder"][0]), "checkpoints",
                                          "fit_decoder_final.json"))
    began = os.path.getmtime(os.path.join(_cli_finals_dir(runs["second"][0]), "config.json"))
    check(began >= t_end, "faults: the second launch started before the lock was free")
    check(final(runs["second"][0]), "faults: the second launch is not run A bit for bit")
    report = [line for line in text2.splitlines() if "TPU.PRECOMPILE: built" in line]
    check(len(report) == 1, f"faults: no precompile report in {text2[-1000:]}")
    print("faults: both relaunches adopted their runs and ended bit for bit at run A's "
          "fit_decoder_final; the lock's holder, under RENI_TPU_HANG_EXIT_S=30, logged no hang "
          "exit and ended at run A's bits; the second launch waited for the lock, started "
          f"{began - t_end:.1f} s after the holder's last write, and with TPU.PRECOMPILE ended "
          f"at run A's bits. {report[0].strip()} (build_all built every library before this "
          "phase)")
    print(f"faults phase wall {time.perf_counter() - t0:.1f} s")


def _cli_finals_dir(cfg) -> str:
    """The newest run dir of ``cfg``'s experiment."""
    from reni_tpu_torch.cli import run as cli_run

    return cli_run._experiment_runs(cfg)[0]


def ckpt_unflatten(flat: dict) -> dict:
    from reni_tpu_torch.train import checkpoint as ckpt

    return ckpt._unflatten(flat)

# ---------------------------------------------------------------------------
# the wide phase: the tiled passes
# ---------------------------------------------------------------------------


def wide_operands(film: bool, H: int, n_mm: int, device, B: int = 21, P: int = 8192,
                  seed: int = 9):
    """Random trunk operands of width ``H`` with ``n_mm`` H x H products
    (``wide_trunk``; FiLM: the same weights, T = n_mm + 1 bias rows and
    frequencies near 30), an output cotangent and the loss operands (a
    masked last image)."""
    ops = wide_trunk(H, device, B, P, n_mm, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if film:
        d, a, _, ws, _, wf, bf = ops
        T = n_mm + 1
        rand = lambda *shape: torch.rand(shape, generator=gen, device=device) * 2 - 1
        ops = (d, a, ws, 0.05 * rand(T, H), wf, bf, 30 + 5 * rand(B, 1, T * H), rand(B, 1, T * H))
    g = torch.randn((B, P, 8), generator=gen, device=device)
    tgt, sw = torch.zeros(B, P, 8, device=device), torch.zeros(1, P, 8, device=device)
    tgt[..., :3] = torch.rand((B, P, 3), generator=gen, device=device) - 0.5
    sw[..., :3] = torch.rand((1, P, 3), generator=gen, device=device)
    bm = torch.ones(B, 1, 8, device=device)
    bm[-1] = 0.0
    return ops, g, (tgt, sw, bm)


def wide_kw(film: bool, trunk: str) -> dict:
    """The trunk's keywords: the fast sine with bf16, the exact one with
    float32 (both sine modes of the tiled passes run)."""
    kw = dict(trunk=trunk, fast_sine=trunk == "bfloat16")
    if not film:
        kw.update(omega0=30.0, omega_h=30.0)
    return kw


def held(label: str, got, ref, bar: float) -> tuple[float, float]:
    """Each result within ``bar`` x max |plain|, finite, of its shape: the
    largest max |diff| and max |diff| / max |plain|."""
    worst, worst_rel = 0.0, 0.0
    for i, (x, y) in enumerate(zip(got, ref)):
        if y is None:
            check(x is None, f"{label}: result {i} computed without weight gradients")
            continue
        check(tuple(x.shape) == tuple(y.shape) and bool(torch.isfinite(x).all()),
              f"{label}: result {i} of shape {tuple(x.shape)} or not finite")
        if not y.numel():
            continue
        err, scale = (x - y).abs().max().item(), y.abs().max().item()
        check(err <= bar * scale, f"{label}: result {i} max |diff| {err:.3g} > {bar} x {scale:.3g}")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
    return worst, worst_rel


def route_calls() -> dict:
    """Calls into the pass libraries by route (siren_step.pass_calls by
    design and trunk): the wgmma passes, the tiled passes in bf16 and in
    float32."""
    from reni_tpu_torch.kernels import siren_step as ts

    return {"wgmma": ts.pass_calls("wgmma"), "tiled_bf16": ts.pass_calls("tiled", "bfloat16"),
            "tiled_f32": ts.pass_calls("tiled", "float32")}


def same_bits(label: str, a, b) -> None:
    check(all(x is None or torch.equal(x, y) for x, y in zip(a, b)),
          f"{label}: two calls on the same inputs differ")


def wide_compare(device) -> dict:
    """(a) Every tiled route against its plain version at 21 x 8,192
    (WIDE_KERNELS, cbc and FiLM, and WIDE_ONE_LAYER's one-layer FiLM
    trunks, the last pass alone): the step (loss and every gradient), the
    backward with and without weight gradients and the differentiable
    forward's hand-off (the fwd passes' output, then the backward from
    their scratch), each called twice for the same bits. Returns {kernel:
    (max abs err, max rel err)}."""
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.kernels import siren_step as ts

    errs = {name: [0.0, 0.0] for name in ("siren_step", "film_step", "siren_bwd", "film_bwd")}
    routes = route_calls()
    cases = [(trunk, H, n_mm, film) for trunk, H, n_mm in WIDE_KERNELS for film in (False, True)]
    for trunk, H, n_mm, film in cases + [(trunk, H, 0, True) for trunk, H in WIDE_ONE_LAYER]:
        label = f"{'film' if film else 'cbc'} {trunk} {n_mm} x {H}"
        check(ts.pass_design(trunk, H, n_mm) == "tiled", f"{label}: not on the tiled route")
        ops, g, loss_ops = wide_operands(film, H, n_mm, device)
        kw, bar = wide_kw(film, trunk), BWD_BAR[trunk]
        skw = dict(kw, out_act="tanh", gscale=1.0 / (3 * g.shape[1]))
        print(f"wide {label} step B=21 P={g.shape[1]}:")
        with torch.no_grad():
            err, rel = compare_step(SimpleNamespace(is_film=film), (*ops, *loss_ops), skw)
        e = errs["film_step" if film else "siren_step"]
        e[0], e[1] = max(e[0], err), max(e[1], rel)
        kernel, plain, _ = bwd_fns(SimpleNamespace(is_film=film, fast_sine=kw["fast_sine"],
                                                   pallas_trunk=trunk,
                                                   first_omega_0=30.0, hidden_omega_0=30.0))
        plain_fwd = tk.film_trunk_reference if film else tk.siren_trunk_reference
        report = []
        for wgrad in (False, True):
            bkw = dict(kw, weight_grads=wgrad)
            with torch.no_grad():
                got, again, ref = (kernel(*ops, g, **bkw), kernel(*ops, g, **bkw),
                                   plain(*ops, g, **bkw))
                out, handed = ts.passes_forward(film, ops, kw, wgrad)
                via = ts.passes_bwd_handoff(handed, g)
                out2, handed2 = ts.passes_forward(film, ops, kw, wgrad)
                via2 = ts.passes_bwd_handoff(handed2, g)
                ref_out = plain_fwd(*ops, **kw)
            torch.cuda.synchronize()
            tag = f"{label} backward {'with' if wgrad else 'without'} weight gradients"
            same_bits(tag, got, again)
            same_bits(f"{tag}, hand-off", (out, *via), (out2, *via2))
            fe = (out - ref_out).abs()
            if trunk == "float32":
                check(fe.max().item() < F32_MAX_ERR[kw["fast_sine"]],
                      f"{tag}: the hand-off's forward off the float32 bar")
            else:
                check(fe.max().item() < MAX_ERR and fe.mean().item() < MEAN_ERR,
                      f"{tag}: the hand-off's forward off the bf16 bar")
            e = errs["film_bwd" if film else "siren_bwd"]
            for what, res in (("kernel", got), ("hand-off", via)):
                err, rel = held(f"{tag} ({what})", res, ref, bar)
                e[0], e[1] = max(e[0], err), max(e[1], rel)
                report.append(f"{'w' if wgrad else 'no w'} {what} {rel:.2g}")
            report.append(f"hand-off fwd max {fe.max().item():.3g}")
            del got, again, ref, out, handed, via, out2, handed2, via2
        print(f"wide {label} backward, max |diff| / max |plain| (bar {bar}): "
              f"{'; '.join(report)}; two calls bitwise equal")
        del ops, g, loss_ops
        torch.cuda.empty_cache()
    grew = {k: v - routes[k] for k, v in route_calls().items()}
    print(f"wide (a) pass calls by route: {grew}")
    check(grew["tiled_bf16"] > 0 and grew["tiled_f32"] > 0 and grew["wgmma"] == 0,
          f"the tiled routes did not run: {grew}")
    return {k: tuple(v) for k, v in errs.items()}


def step_split(film: bool, args, kw, device) -> dict:
    """The passes and dWs of one step on the pass route, by CUDA events:
    every pass and the slot sums, then dWs = h^T dz alone over their scratch
    (wgrad_bf16 / wgrad_f32 and the sum of its split-K partials,
    ``wgrad_timings``: beside torch.bmm of the same scratch)."""
    from reni_tpu_torch.kernels import siren_step as ts

    plan = ts.step_plan_cuda(film, args, device, trunk=kw["trunk"])
    prep, work = ts.pass_operands(plan, args, kw), ts.PassWork.for_plan(plan, plan.trunk, device)
    n = len(plan.passes)
    passes = time_ms(lambda: ts._pass_call(plan, prep, work, 0, n, ts.FINISH_IMG | ts.FINISH_W),
                     runs=5, warmup=1)
    out = wgrad_timings(f"{'film' if film else 'siren'}_step {plan.n_mm} x {plan.hidden} "
                        f"{plan.trunk}", plan, work.sc_h, work.sc_dz)
    del prep, work
    return {"passes_ms": passes, **out}


def wide_timings(device) -> dict:
    """The tiled routes at WIDE_TIMED: the step at FIT_DECODER's 100 x 8,192
    and the backward without weight gradients at FIT_LATENT's 21 x 8,192,
    each trunk, cbc and FiLM, and the float32 step at WIDE_ZOO_F32, against
    the plain version; the bound (the function's bytes, and its operations
    at the trunk's peak: bf16 tensor cores or float32 FFMA), the passes'
    byte floor (StepPlan.pass_cost) and the step's split between the passes
    and dWs (step_split). Returns {kernel: {route: numbers}}; the Zoo
    width's row under the route's name with "@5x256"."""
    from reni_tpu_torch.kernels import siren_step as ts

    H, n_mm = WIDE_TIMED
    out: dict = {}
    cases = [(trunk, film, name, B, H, n_mm - film, "")
             for trunk in ("bfloat16", "float32") for film in (False, True)
             # the Zoo's 5 trunk layers: FiLM has one product fewer
             for name, B in ((("film_step" if film else "siren_step"), 100),
                             (("film_bwd" if film else "siren_bwd"), 21))]
    cases.append(("float32", False, "siren_step", 100, *WIDE_ZOO_F32,
                  "@{1}x{0}".format(*WIDE_ZOO_F32)))
    for trunk, film, name, B, H, depth, key in cases:
        route = f"tiled_{'bf16' if trunk == 'bfloat16' else 'f32'}"
        peak = PEAK_BF16_FLOPS if trunk == "bfloat16" else PEAK_F32_FLOPS
        kw = wide_kw(film, trunk)
        ops, g, loss_ops = wide_operands(film, H, depth, device, B=B, seed=31)
        P = g.shape[1]
        if name.endswith("step"):
            kernel, plain = step_fns(SimpleNamespace(is_film=film))
            args, fkw = (*ops, *loss_ops), dict(kw, out_act="tanh", gscale=1.0 / (3 * P))
            plan = ts.step_plan_cuda(film, args, device, trunk=trunk)
            nbytes = step_bytes(args, 4, 3, film, trunk)
        else:
            kernel, plain, _ = bwd_fns(SimpleNamespace(
                is_film=film, fast_sine=kw["fast_sine"], pallas_trunk=trunk,
                first_omega_0=30.0, hidden_omega_0=30.0), weight_grads=False)
            args, fkw = (*ops, g), dict(kw, weight_grads=False)
            plan = ts.step_plan_cuda(film, args, device, bwd=True, weight_grads=False,
                                     trunk=trunk)
            nbytes = bwd_bytes(ops, 4, 3, film, trunk, False)
        flops = (sum(plan.pass_cost(k)[0] for k in range(len(plan.passes)))
                 + plan.wgrad_cost()[0])
        with torch.no_grad():
            ms = time_ms(lambda: kernel(*args, **fkw), runs=5, warmup=1)
            plain_ms = time_ms(lambda: plain(*args, **fkw), runs=2, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes, peak)
        floor_ms = byte_floor_ms(plan)
        split = ""
        row = {"shape": f"{B}x{P} {depth}x{H}", "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "byte_floor_ms": floor_ms}
        if name.endswith("step"):
            with torch.no_grad():
                row.update(step_split(film, args, fkw, device))
            split = (f"; the passes {row['passes_ms']:.4f} ms, dWs "
                     f"{row['wgrad_ms']:.4f} ms")
        print(f"wide {name} {route} {depth} x {H} B={B} P={P}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {flops:.4g} FLOP "
              f"at {peak / 1e12:.0f} TFLOP/s, {nbytes:.4g} B), the passes' byte floor "
              f"{floor_ms:.4f} ms -> {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s{split} "
              f"({CARD})")
        out.setdefault(name, {})[route + key] = row
        del ops, g, loss_ops, args
        torch.cuda.empty_cache()
    return out


def wide_fit_decoder(device, train) -> dict:
    """(b) FIT_DECODER of the Zoo's cbc configuration widened to WIDE_FIT's
    width (a fresh init; no checkpoint exists at that width) on the seed-1
    maps at batch 100, WIDE_FIT's epochs and curriculum ending at 64 x 128,
    through the step kernel (the tiled passes) and through the plain step;
    the students' PSNR within PSNR_BAR_DB. Returns the kernel run's step
    launches and ms a step per stage."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.train import checkpoint as ckpt

    H, epochs, curriculum = WIDE_FIT
    config = dataclasses.replace(ckpt.load_model_config(os.path.join(CBC, "checkpoint")),
                                 hidden_features=H)
    task = decoder_task_config(epochs, curriculum)
    steps = epochs * (DEC_MAPS // DEC_BATCH)
    target = train.images_at(FIT_RES[1], device=device)
    D = sphere.get_directions(FIT_RES[1][1], device=device)
    result, out = {}, {}
    for plain in (False, True):
        run = "plain" if plain else "kernel"
        t0 = time.perf_counter()
        trained, model, ms, metrics, n, _ = fit_decoder(device, CBC, plain=plain, train=train,
                                                        config=config, task=task)
        wall = time.perf_counter() - t0
        tag = f"wide FIT_DECODER cbc {config.hidden_layers} x {H} [{run}]"
        want = {"step": 0 if plain else steps, "fwd": 0, "bwd": 0}
        check(n == want, f"{tag}: launches {n}, expected {want}")
        loss = metrics["fit_decoder_loss"]
        check(bool(np.isfinite(loss).all()), f"{tag}: non-finite loss")
        stages = {f"{r[0]}x{r[1]}": t for r, t in sorted(ms.items())}
        with torch.no_grad():
            mu = trained["latents"]["mu"]
            decoded = torch.cat([model.apply(trained, z, D) for z in mu.split(DEC_BATCH)])
        check(bool(torch.isfinite(decoded).all()), f"{tag}: non-finite decodes")
        result[plain] = psnr(decoded, target)
        print(f"{tag}: {steps} steps in {wall:.1f} s; ms a step by stage "
              f"{ {k: round(v, 3) for k, v in stages.items()} }; loss {loss[0]:.6g} -> "
              f"{loss[-1]:.6g}; PSNR {result[plain]:.3f} dB ({CARD})")
        if not plain:
            out = {"launches": n["step"], "ms_by_stage": stages}
        del trained, model, decoded
        torch.cuda.empty_cache()
    gap = result[False] - result[True]
    print(f"wide FIT_DECODER {H}: PSNR kernel - plain {gap:+.3f} dB")
    check(abs(gap) <= PSNR_BAR_DB, f"wide FIT_DECODER: PSNR kernel vs plain differ by {gap:.3f} dB")
    return out


def wide_chains(device, maps_root: str) -> dict:
    """(c) The trainer's chain (cli.run) FIT_DECODER -> FIT_LATENT ->
    FIT_INVERSE on configs/zoo_synthetic.yaml's configuration at each of
    WIDE_CHAINS (width, layers, trunk: TPU.PRECISION), cut to
    WIDE_CLI_CUTS: every task's every step through the kernels (the step
    kernel, the hand-off's forward passes and the backward) on the tiled
    route, nothing raised. Returns each chain's launches by trunk."""
    from reni_tpu_torch.kernels import siren_step as ts

    launches = {}
    for H, L, trunk in WIDE_CHAINS:
        work = os.path.join(maps_root, f"wide_{trunk}_{L}x{H}")
        os.makedirs(work, exist_ok=True)
        cfg = cli_config(maps_root, os.path.join(work, "runs"))
        cfg.RENI.HIDDEN_FEATURES, cfg.RENI.HIDDEN_LAYERS, cfg.TPU.PRECISION = H, L, trunk
        for task, (epochs, curriculum) in WIDE_CLI_CUTS.items():
            cfg.RENI[task].EPOCHS = epochs
            if curriculum:
                cfg.RENI[task].CURRICULUM = curriculum
        cfg.TRAINER.LOGGER.LOG_IMAGES = False
        path = os.path.join(work, "chain.json")
        with open(path, "w") as f:
            json.dump(cfg.to_dict(), f)
        steps = {t: cfg.RENI[t].EPOCHS * -(-(SEED_MAPS["train"] if t == "FIT_DECODER"
                                             else SEED_MAPS["test"]) // cfg.RENI[t].BATCH_SIZE)
                 for t in CLI_TASKS}
        routes = route_calls()
        t0 = time.perf_counter()
        log, seconds, n = cli_chain(device, cfg, path)
        grew = {k: v - routes[k] for k, v in route_calls().items()}
        tag = f"wide chain {trunk} {L} x {H}"
        print(f"{tag}: {time.perf_counter() - t0:.1f} s; task seconds "
              f"{ {t: round(v['task'], 2) for t, v in seconds.items()} }; launches {n}; "
              f"pass calls by route {grew}")
        route = f"tiled_{'bf16' if trunk == 'bfloat16' else 'f32'}"
        check(n["siren_step"] == steps["FIT_DECODER"], f"{tag}: step kernel {n['siren_step']}")
        fit_steps = steps["FIT_LATENT"] + steps["FIT_INVERSE"]
        check(n["siren_bwd"] == n["fwd_passes"] == fit_steps,
              f"{tag}: backward {n['siren_bwd']}, forward passes {n['fwd_passes']}: {fit_steps}")
        check(grew[route] > 0 and grew["wgmma"] == 0, f"{tag}: pass calls by route {grew}")
        for t in CLI_TASKS:
            loss = [r[f"{t.lower()}_loss"] for r in _cli_rows(log) if f"{t.lower()}_loss" in r]
            check(bool(loss) and bool(np.isfinite(loss).all()), f"{tag} {t}: loss {loss}")
        launches[trunk] = n
    return launches


def wide_phase(device, train, maps_root: str) -> dict:
    """The wide phase: (a) wide_compare, the kernels line's timings
    (wide_timings), then the main path on the tiled routes, the pass
    counts zeroed just before and read by route just after: (b) wide_fit_decoder,
    (c) wide_chains. Returns {kernel: {route: numbers}} for the kernels
    line."""
    from reni_tpu_torch.kernels import siren_step as ts

    t0 = time.perf_counter()
    errs = wide_compare(device)
    rows = wide_timings(device)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    ts.pass_launches.update({k: 0 for k in ts.pass_launches})
    fit = wide_fit_decoder(device, train)
    chains = wide_chains(device, maps_root)
    torch.cuda.synchronize()
    launched = route_calls()
    print(f"wide main path (b) + (c): pass calls by route {launched} ({time.perf_counter() - t1:.1f} s)")
    check(launched["tiled_bf16"] > 0 and launched["tiled_f32"] > 0,
          f"the main path did not take both tiled routes: {launched}")
    # calls of each wrapper on the main path (both are Cond-by-Concat: FiLM's
    # tiled routes run in (a) alone)
    bf16, f32 = chains["bfloat16"], chains["float32"]
    calls = {"siren_step": {"tiled_bf16": fit["launches"] + bf16["siren_step"],
                            "tiled_f32": f32["siren_step"]},
             "siren_bwd": {"tiled_bf16": bf16["siren_bwd"], "tiled_f32": f32["siren_bwd"]}}
    for name, by_route in rows.items():
        for route, row in by_route.items():
            row.update(source=SOURCE_TILED, launches=calls.get(name, {}).get(route, 0),
                       max_abs_err=errs[name][0], max_rel_err=errs[name][1])
    rows["siren_step"]["tiled_bf16"]["fit_decoder_ms_by_stage"] = fit["ms_by_stage"]
    print(f"wide phase wall {time.perf_counter() - t0:.1f} s")
    return rows


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
    # the chip lock and stop file of the trainers this script starts, in its
    # own temporary directory (their defaults are shared by every job that
    # runs with the same TMPDIR)
    arbitration = tempfile.TemporaryDirectory()
    os.environ.setdefault("RENI_TPU_CHIP_LOCK", os.path.join(arbitration.name, "chip.lock"))
    os.environ.setdefault("RENI_TPU_STOP_FILE", os.path.join(arbitration.name, "stop"))

    phase("build")
    build_all()
    global CARD
    CARD = card_line()

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
    c8_step = compare_c8(dev, errors, rel_errors)
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
        err, rel = compare_chain_bwd(cfg.is_film, dev)
        errors[name] += err
        rel_errors[name] += rel
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

    phase("export")
    export_phase(dev, entries)

    phase("fit_latent")
    launches.update(fit_latent_phase(dev))
    print(f"backward launches during FIT_LATENT (kernel runs): "
          f"{ {k: launches[k] for k in ('siren_bwd', 'film_bwd')} }; per stage "
          f"{ {k: v for k, v in launches.items() if '@' in k} }")

    phase("seed_maps")
    maps_dir = tempfile.TemporaryDirectory()
    train, test = seed_maps(dev, maps_dir.name)

    phase("codecs")
    dwab_test = codecs_phase(maps_dir.name)

    phase("stream")
    launches.update(stream_phase(dev, train, maps_dir.name, dwab_test))

    phase("fit_inverse")
    launches.update(fit_inverse_phase(dev, test, {k: entries[k] for k in ("siren_fwd", "film_fwd")}))

    phase("evaluate")
    launches.update(evaluate_phase(dev, maps_dir.name))

    phase("baselines")
    baselines_phase(dev, test)

    phase("convert")
    launches.update(convert_phase(dev, entries))

    phase("fit_prior")
    fit_prior_launches, fit_prior_bwd = fit_prior_phase(dev, test)
    launches.update(fit_prior_launches)
    for name, v in fit_prior_bwd.items():
        errors[name].append(v["err"])
        rel_errors[name].append(v["rel"])

    phase("cli_run")
    launches.update(cli_run_phase(dev, maps_dir.name))

    phase("mesh")
    launches.update(mesh_phase(dev, train, test, maps_dir.name))

    phase("tp")
    torch.cuda.empty_cache()
    tp_phase(dev, train, test, maps_dir.name)

    phase("faults")
    faults_phase(dev, maps_dir.name)

    phase("wide")
    torch.cuda.empty_cache()
    wide_rows = wide_phase(dev, train, maps_dir.name)
    maps_dir.cleanup()
    arbitration.cleanup()
    for name, tag in (("siren_bwd", "siren_bwd@fit_inverse"), ("film_bwd", "film_bwd@fit_inverse"),
                      ("siren_fwd", "siren_fwd@evaluate"), ("film_fwd", "film_fwd@evaluate"),
                      ("siren_bwd", "siren_bwd@cli_run"), ("siren_fwd", "siren_fwd@cli_run"),
                      ("siren_fwd", "siren_fwd@convert"), ("siren_bwd", "siren_bwd@stream"),
                      ("siren_fwd", "siren_fwd@cli_run_disk"), ("siren_fwd", "siren_fwd@mesh"),
                      ("siren_bwd", "siren_bwd@mesh")):
        launches[name] += launches[tag]
    for tag in [k for k in launches if k.endswith("@fit_prior")]:
        launches[tag.split("@")[0]] += launches[tag]
    print(f"launches by kernel, all paths so far: "
          f"{ {k: launches[k] for k in ('siren_fwd', 'film_fwd', 'siren_bwd', 'film_bwd')} }")

    phase("compare_step at full width and at FIT_DECODER's shapes")
    cfg_cbc, dec_cbc, _ = entries["siren_fwd"]
    mu, maps = training_maps(dev, train)
    errors["siren_step"], rel_errors["siren_step"] = compare_step_phase(
        "siren_step", cfg_cbc, dec_cbc, mu, maps, dev)
    for err, rel in c8_step.values():
        errors["siren_step"].append(err)
        rel_errors["siren_step"].append(rel)
    err, rel = compare_passes("siren_step", cfg_cbc, dec_cbc, mu, maps, dev)
    errors["siren_step"] += err
    rel_errors["siren_step"] += rel

    phase("fit_decoder")
    launches["siren_step"] = fit_decoder_phase(dev, train)
    print(f"step-kernel launches during FIT_DECODER (kernel run): {launches['siren_step']}")
    launches["siren_step"] += (launches["siren_step@cli_run"] + launches["siren_step@stream"]
                               + launches["siren_step@cli_run_disk"] + launches["siren_step@mesh"])

    phase("compare_film_step at full width and at FIT_DECODER's shapes")
    cfg_film, dec_film, _ = entries["film_fwd"]
    mu_film, maps_film = training_maps(dev, train, FILM)
    errors["film_step"], rel_errors["film_step"] = compare_step_phase(
        "film_step", cfg_film, dec_film, mu_film, maps_film, dev)
    err, rel = compare_passes("film_step", cfg_film, dec_film, mu_film, maps_film, dev)
    errors["film_step"] += err
    rel_errors["film_step"] += rel

    phase("fit_decoder_film")
    launches["film_step"] = fit_decoder_phase(dev, train, FILM) + launches["film_step@mesh"]
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
            if name in fit_prior_bwd:  # fit_prior's 1 x 2,048, timed in its phase
                shapes.update({f"{k}_fit_prior": v
                               for k, v in fit_prior_bwd[name]["shape"].items()})
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
    for row in rows:  # the tiled routes of the wide phase beside each kernel's own numbers
        if row["name"] in wide_rows:
            row["wide_routes"] = wide_rows[row["name"]]
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
