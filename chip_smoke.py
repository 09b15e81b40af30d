#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (reni_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one NVIDIA GPU

Phases (any failure exits non-zero and prints no result line):

1. build       - compile kernels/csrc/siren_fwd.cu and siren_bwd.cu with nvcc
                 (sm_90a), both at once
2. compare     - at full width (N=49, 5x256 SIREN, 21 test latents x 32,768
                 directions, bf16 trunk, fast sine) each forward kernel
                 against its plain PyTorch version on the card: shared (1, P)
                 grid, per-image (B, P) grids, and the float32 trunk once;
                 then the shared grids of FIT_LATENT's three stages (21 x
                 512, 2,048 and 8,192 directions); both the Cond-by-Concat
                 and the FiLM Zoo decoder
3. compare_bwd - the same for each backward kernel, every gradient, with
                 and without the weight gradients: shared and per-image
                 grids, and the float32 trunk once; then FIT_LATENT's three
                 stage grids without weight gradients, as FIT_LATENT runs
                 them; bars max |kernel - plain| <= 1e-2 (bf16) / 1e-4
                 (float32) x max |plain|. The kernels line reports the
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
                 before and read just after: both kernels must have launched
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
6. timings     - each kernel and its plain version: the forward at the
                 phase-2 shapes, the backward at 21 x 32,768 and 21 x 8,192
                 with and without weight gradients; median of CUDA-event
                 timed runs after warm-up; the bound is the larger of FLOPs
                 / 989 TFLOP/s (bf16 dense) and bytes / 3.35 TB/s (H100 SXM
                 data sheet), both counted without the kernels' padding
7. report      - one JSON line of kernels, the card's name and power limit,
                 then {"ok": true, "device": {...}} as the last line
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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
SOURCE_BWD = "reni_tpu_torch/kernels/csrc/siren_bwd.cu"
KERNEL_SOURCES = ("siren_fwd", "siren_bwd")
# backward bars: max |kernel - plain| <= BAR x max |plain|, per gradient
BWD_BAR = {"bfloat16": 1e-2, "float32": 1e-4}
BWD_WIDTHS = (256, 128)  # 21 x 32,768 and 21 x 8,192 directions
MASK = os.path.join(ROOT, "data", "Masks", "Mask-3.png")
# FIT_LATENT: the published task (config.yaml RENI.FIT_LATENT) with the
# epochs cut from 2,400 to 300
FIT_EPOCHS, FIT_CURRICULUM = 300, (100, 200)
FIT_RES = ((16, 32), (64, 128))  # initial and final resolution
PSNR_BAR_DB = 0.1  # ROADMAP yardstick for trained runs


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
    service's decode alone (device work + copy to host), and the device
    time of the decoder call (CUDA events)."""
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
    print(f"{name} width {width} x {latents.shape[0]}: HTTP round trip "
          f"{statistics.median(http_ms):.2f} ms, service.decode "
          f"{statistics.median(svc_ms):.2f} ms, decoder call on the device "
          f"{statistics.median(dev_ms):.2f} ms")


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


def compare_bwd(cfg, dec, Z, D, trunk, weight_grads, seed) -> tuple[float, float]:
    """Backward kernel vs plain version, every gradient; returns the largest
    max |difference| and the largest max |difference| / max |plain| (the
    quantity the bar holds: the gradients' scales differ by orders of
    magnitude)."""
    kernel, plain, kw = bwd_fns(cfg, trunk, weight_grads)
    ops = packed(cfg, dec, Z, D)
    g = cotangent(Z, D.shape[1], seed)
    got, ref = kernel(*ops, g, **kw), plain(*ops, g, **kw)
    torch.cuda.synchronize()
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


def fit_latent(entry: str, device, *, masked: bool, plain: bool, targets: dict):
    """One FIT_LATENT run from fresh latents, through the kernels or (``plain``)
    their plain versions; returns (fitted maps at the final resolution,
    per-stage step times in ms, metrics, launches {fwd, bwd} during the run)."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.kernels import siren_bwd as tb
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.models.reni import RENIModel
    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.train import tasks

    path = os.path.join(entry, "checkpoint")
    cfg = ckpt.load_model_config(path, fixed_decoder=True)
    model = RENIModel(cfg)
    params = ckpt.load_decoder_only(path, model, 21, torch.Generator().manual_seed(0), device)
    task = fit_task_config(masked)
    events: dict = {}

    def timed_step(model, directions, sineweight, res):
        step = tasks.make_fit_latent_step(
            model, directions, sineweight, alpha=task.prior_loss_weight,
            beta=task.cosine_similarity_weight,
        )
        evs = events.setdefault(res, [])

        def run(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            evs.append((start, end))
            return out

        return run

    fwd = tk.fused_film_apply if cfg.is_film else tk.fused_apply
    bwd = tb.film_trunk_bwd_cuda if cfg.is_film else tb.siren_trunk_bwd_cuda
    torch.cuda.synchronize()
    fwd.launches = bwd.launches = 0
    with plain_trunks() if plain else contextlib.nullcontext():
        fitted, metrics = tasks.fit_task(
            model, params, task, lambda res: targets[res], torch.Generator().manual_seed(1),
            mask_path=task.mask_path, step_builder=timed_step,
        )
    torch.cuda.synchronize()
    launches = {"fwd": fwd.launches, "bwd": bwd.launches}
    ms = {res: statistics.median(s.elapsed_time(e) for s, e in evs) for res, evs in events.items()}
    with torch.no_grad():
        maps = model.apply(fitted, fitted["latents"]["mu"],
                           sphere.get_directions(FIT_RES[1][1], device=device))
    return maps, ms, metrics, launches


def fit_latent_phase(device) -> dict:
    """FIT_LATENT through the kernels and through their plain versions;
    returns the backward launches of the kernel runs per kernel name."""
    from reni_tpu_torch.core import sphere
    from reni_tpu_torch.serve import load_decoder

    launches = {"siren_bwd": 0, "film_bwd": 0}
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
            maps, ms, metrics, n = fit_latent(entry, device, masked=masked, plain=plain,
                                              targets=targets)
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(maps).all()), f"{label}: non-finite fitted maps")
            steps = FIT_EPOCHS  # one batch of 21 per epoch
            if plain:
                check(n == {"fwd": 0, "bwd": 0}, f"{label}: the plain run launched kernels {n}")
            else:
                check(n == {"fwd": steps, "bwd": steps},
                      f"{label}: {n} launches in {steps} steps (one each per step)")
                launches[name] += n["bwd"]
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
                      f"epoch loss {loss[off]:.6g} -> {loss[off + n_ep - 1]:.6g}")
                off += n_ep
            print(f"{label} [{run}] {steps} steps in {wall:.1f} s, launches {n}; PSNR at "
                  f"{FIT_RES[1][0]}x{FIT_RES[1][1]} " + ", ".join(f"{k} {v:.3f} dB" for k, v in db.items()))
        for k in result[False]:
            gap = abs(result[False][k] - result[True][k])
            check(gap <= PSNR_BAR_DB, f"{label}: PSNR {k} kernels vs plain differ by {gap:.3f} dB")
        print(f"{label}: PSNR kernels - plain " + ", ".join(
            f"{k} {result[False][k] - result[True][k]:+.3f} dB" for k in result[False]))
    return launches


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
    for name, entry in (("siren_fwd", CBC), ("film_fwd", FILM)):
        cfg, dec, Z = load_entry(entry, dev)
        check(tuple(Z.shape) == (21, 49, 3), f"test latents {tuple(Z.shape)}")
        entries[name] = (cfg, dec, Z)
        with torch.inference_mode():
            for label, grid, trunk in (
                ("shared (1, P) grid", D, None),
                ("per-image (B, P) grids", per_image_grids(D, Z.shape[0], seed=0), None),
                ("float32 trunk, shared grid", D, "float32"),
                *((label, grid, None) for label, grid in fit_grids),
            ):
                mx, mean, scale = compare(cfg, dec, Z, grid, trunk)
                errors[name].append(mx)
                rel_errors[name].append(mx / scale)
                print(f"{name} {os.path.basename(entry)} B={Z.shape[0]} P={grid.shape[1]} "
                      f"{label}: max abs err {mx:.3g}, mean {mean:.3g}")
                if (trunk or cfg.pallas_trunk) == "float32":
                    bar = F32_MAX_ERR[cfg.fast_sine]
                    check(mx < bar, f"{name} {label} off the float32 bar {bar}")
                else:
                    check(mx < MAX_ERR and mean < MEAN_ERR, f"{name} {label} off the bf16 bar")

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
                *((f"{label}, no weight gradients", grid, None, False)
                  for label, grid in fit_grids),
            ):
                print(f"{name} B={Z.shape[0]} P={grid.shape[1]} {label}:")
                err, rel = compare_bwd(cfg, dec, Z, grid, trunk, wgrad, seed=2)
                errors[name].append(err)
                rel_errors[name].append(rel)

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
    serve_entry(CBC, expected["siren_fwd"], rotation_width=WIDTH, concurrent=True)
    serve_entry(FILM, expected["film_fwd"], rotation_width=WIDTH, concurrent=False)
    torch.cuda.synchronize()
    launches = {"siren_fwd": tk.fused_apply.launches, "film_fwd": tk.fused_film_apply.launches}
    print(f"launches during serving: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the serving path")

    phase("fit_latent")
    launches.update(fit_latent_phase(dev))
    print(f"backward launches during FIT_LATENT (kernel runs): "
          f"{ {k: launches[k] for k in ('siren_bwd', 'film_bwd')} }")

    phase("timings")
    rows = []
    replaces = {
        "siren_fwd": "reni_tpu/kernels/siren_pallas.py:140",
        "film_fwd": "reni_tpu/kernels/siren_pallas.py:201",
        "siren_bwd": "reni_tpu/kernels/siren_pallas.py:151",
        "film_bwd": "reni_tpu/kernels/siren_pallas.py:221",
    }
    with torch.inference_mode():
        for name in ("siren_fwd", "film_fwd"):
            cfg, dec, Z = entries[name]
            d_feats = encodings.d_features(cfg.equivariance, D)
            B, P, H = Z.shape[0], D.shape[1], cfg.hidden_features
            ops = packed(cfg, dec, Z, D)
            if name == "siren_fwd":
                kw = dict(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0,
                          trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine)
                kernel, plain = tk.siren_trunk_cuda, tk.siren_trunk_reference
                n_mm = ops[3].shape[0]
            else:
                kw = dict(trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine)
                kernel, plain = tk.film_trunk_cuda, tk.film_trunk_reference
                n_mm = ops[2].shape[0]
            k, n_out = d_feats.shape[-1], cfg.out_features
            flops = 2.0 * B * P * (k * H + n_mm * H * H + H * n_out)
            nbytes = min_bytes(ops, k, n_out, cfg.is_film, cfg.pallas_trunk) + B * P * n_out * 4
            bound_ms, bound_by = bound(flops, nbytes)
            ms = time_ms(lambda: kernel(*ops, **kw))
            plain_ms = time_ms(lambda: plain(*ops, **kw))
            print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {flops:.4g} FLOP, {nbytes:.4g} B) -> "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(errors[name]), "max_rel_err": max(rel_errors[name]),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
        for fwd_name, name in (("siren_fwd", "siren_bwd"), ("film_fwd", "film_bwd")):
            cfg, dec, Z = entries[fwd_name]
            row = None
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
                    plain_ms = time_ms(lambda: plain(*ops, g, **kw), runs=runs)
                    print(f"{name} B={B} P={P} {'with' if wgrad else 'without'} weight "
                          f"gradients: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                          f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} FLOP, {nbytes:.4g} B) "
                          f"-> {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
                    if row is None:  # 21 x 32,768 without weight gradients (FIT_LATENT's mode)
                        row = {
                            "name": name, "route": "cuda", "source": SOURCE_BWD,
                            "replaces": replaces[name], "launches": launches[name],
                            "max_abs_err": max(errors[name]),
                            "max_rel_err": max(rel_errors[name]),
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        }
            rows.append(row)
    print(f"total_s {time.perf_counter() - t_start:.1f}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
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
