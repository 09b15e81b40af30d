#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (reni_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one NVIDIA GPU

Phases (any failure exits non-zero and prints no result line):

1. build    - compile kernels/csrc/siren_fwd.cu with nvcc (sm_90a)
2. compare  - at full width (N=49, 5x256 SIREN, 21 test latents x 32,768
              directions, bf16 trunk, fast sine) each CUDA kernel against
              its plain PyTorch version on the card: shared (1, P) grid,
              per-image (B, P) grids, and the float32 trunk once; both the
              Cond-by-Concat and the FiLM Zoo decoder
3. serve    - the serving path (reni_tpu_torch.cli.serve.make_server) on
              127.0.0.1 with a 20 ms batching window: /healthz,
              /decode_idx for all 21 latents at widths 128, 130 and 256
              (130 gives 8,450 pixels, not a multiple of 8: the kernel
              masks its tail tile and still serves it),
              /decode with rotation_y=90 checked against a column roll of
              the unrotated decode, concurrent requests that the
              micro-batcher coalesces; served arrays checked against a
              direct load_decoder call. Launch counts are zeroed just
              before and read just after: both kernels must have launched
4. timings  - each kernel and its plain version at the phase-2 shapes:
              median of 25 CUDA-event timed runs after warm-up; the bound
              is the larger of FLOPs / 989 TFLOP/s (bf16 dense) and bytes /
              3.35 TB/s (H100 SXM data sheet), both counted without the
              kernel's channel padding
5. report   - one JSON line of kernels, the card's name and power limit,
              then {"ok": true, "device": {...}} as the last line
"""

from __future__ import annotations

import base64
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
    """Kernel vs plain version through the public wrappers -> (max, mean)."""
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
    return err.max().item(), err.mean().item()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the plain versions are the float32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reni_tpu_torch.kernels import _build
    from reni_tpu_torch.kernels import siren_fwd as tk
    from reni_tpu_torch.core import encodings, sphere
    from reni_tpu_torch.serve import load_decoder

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    phase("build")
    t0 = time.perf_counter()
    lib = _build.build("siren_fwd")
    print(f"build_s {time.perf_counter() - t0:.2f} ({lib.name})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    phase("compare at full width")
    D = sphere.get_directions(WIDTH, device=dev)
    errors = {"siren_fwd": [], "film_fwd": []}
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
            ):
                mx, mean = compare(cfg, dec, Z, grid, trunk)
                errors[name].append(mx)
                print(f"{name} {os.path.basename(entry)} B={Z.shape[0]} P={D.shape[1]} "
                      f"{label}: max abs err {mx:.3g}, mean {mean:.3g}")
                if (trunk or cfg.pallas_trunk) == "float32":
                    bar = F32_MAX_ERR[cfg.fast_sine]
                    check(mx < bar, f"{name} {label} off the float32 bar {bar}")
                else:
                    check(mx < MAX_ERR and mean < MEAN_ERR, f"{name} {label} off the bf16 bar")

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

    phase("timings")
    rows = []
    replaces = {
        "siren_fwd": "reni_tpu/kernels/siren_pallas.py:140",
        "film_fwd": "reni_tpu/kernels/siren_pallas.py:201",
    }
    with torch.inference_mode():
        for name in ("siren_fwd", "film_fwd"):
            cfg, dec, Z = entries[name]
            d_feats = encodings.d_features(cfg.equivariance, D)
            B, P, H = Z.shape[0], D.shape[1], cfg.hidden_features
            if name == "siren_fwd":
                ops = tk.pack_inputs(dec, cfg.equivariance, cfg.latent_dim, Z, d_feats)
                kw = dict(omega0=cfg.first_omega_0, omega_h=cfg.hidden_omega_0,
                          trunk=cfg.pallas_trunk, fast_sine=cfg.fast_sine)
                kernel, plain = tk.siren_trunk_cuda, tk.siren_trunk_reference
                n_mm = ops[3].shape[0]
            else:
                ops = tk.pack_film_inputs(dec, cfg.equivariance, Z, d_feats, H)
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
                "max_abs_err": max(errors[name]), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
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
