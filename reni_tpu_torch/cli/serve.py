"""HTTP serving daemon for a decoder, on the card.

    python -m reni_tpu_torch.cli.serve --decoder data/Zoo/<entry>/checkpoint \
        [--checkpoint data/Zoo/<entry>/latents_test]  # latents for /decode_idx
        [--device cuda] [--port 8742] [--warmup 128,256] [--batch_window_ms 20]
    python -m reni_tpu_torch.cli.serve --artifact decoder.pt2 [--checkpoint ...]

The counterpart of ``reni_tpu/cli/serve.py``: a stdlib HTTP front end over
one of two decoders, exactly one of them given. ``--decoder`` takes a
checkpoint and decodes through the fused CUDA kernels
(``reni_tpu_torch.serve.load_decoder``): the fast path. ``--artifact``
takes a ``torch.export`` artifact (``cli/export.py``), the plain decoder's
PyTorch operations without the model code (``serve.load_exported``), as the
JAX daemon's ``--artifact`` serves its ``jax.export`` one.

Endpoints (JSON in, JSON out; radiance in the model's normalised space):

- ``GET  /healthz``                      -> {"ok": true, ...}
- ``POST /decode``  {"z": [[...x3]...] | [[[...]]], "width": W,
                     "format": "list" | "base64", "rotation_y": degrees}
      z: one (N, 3) latent or a batch (B, N, 3). Decodes the full
      equirectangular grid at W x W/2 -> {"shape": [B, H, W, 3], "data"}.
- ``POST /decode_idx`` {"idx": [0, 3], "width": W, ...}  (needs --checkpoint)

``rotation_y`` rotates the illumination about the up axis by rotating the
LATENTS (Z @ R); for SO2/SO3 decoders the output equals the unrotated
decode shifted right by width * deg/360 columns. A decoder trained with
EQUIVARIANCE None rejects it. With ``--decoder`` the equivariance is the
decoder checkpoint's; with ``--artifact`` it is ``--checkpoint``'s, and
unknown (rotation allowed) without one, as in the JAX daemon.

``--batch_window_ms W`` coalesces concurrent same-width decodes arriving
within W ms into one batched decode; /healthz then reports
requests/dispatches/coalesced_rows.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from reni_tpu_torch.core import sphere


def _rotate(z: np.ndarray, rotation_y: float) -> np.ndarray:
    """Latent rotation for ``rotation_y`` degrees (positive shifts the map
    rightward)."""
    r = sphere.rotation_y(-np.deg2rad(float(rotation_y))).astype(np.float32)
    return z @ r


class _MicroBatcher:
    """Coalesces concurrent decode requests of the same width into one
    batched decode (opt-in, ``--batch_window_ms``). A worker thread sleeps
    ``window`` after the first queued request, then drains every same-width
    request that fits under the daemon's batch cap into a single decode;
    rotation is applied per request before enqueueing, so differently
    rotated requests coalesce."""

    def __init__(self, service: "DecoderService", window_ms: float):
        self.service = service
        self.window = float(window_ms) / 1000.0
        self._q = collections.deque()
        self._cv = threading.Condition()
        self.stats = {"requests": 0, "dispatches": 0, "coalesced_rows": 0}
        threading.Thread(target=self._loop, daemon=True).start()

    def decode(self, z: np.ndarray, width: int) -> np.ndarray:
        slot: dict = {"ev": threading.Event()}
        with self._cv:
            self._q.append((np.asarray(z, np.float32), int(width), slot))
            self._cv.notify()
        slot["ev"].wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
            if self.window:
                time.sleep(self.window)  # let concurrent requests arrive
            with self._cv:
                first = self._q.popleft()
                group = [first]
                rows = first[0].shape[0]
                rest = collections.deque()
                while self._q:
                    item = self._q.popleft()
                    if (
                        item[1] == first[1]
                        and rows + item[0].shape[0] <= self.service.max_batch
                    ):
                        group.append(item)
                        rows += item[0].shape[0]
                    else:
                        rest.append(item)  # different width / over cap
                self._q.extend(rest)  # preserve arrival order
            self.stats["requests"] += len(group)
            self.stats["dispatches"] += 1
            self.stats["coalesced_rows"] += rows
            try:
                zs = np.concatenate([g[0] for g in group], axis=0)
                out = self.service.decode(zs, first[1])
            except Exception as e:  # fan the failure out to every waiter
                for _, _, slot in group:
                    slot["err"] = e
                    slot["ev"].set()
                continue
            o = 0
            for z, _, slot in group:
                slot["out"] = out[o : o + z.shape[0]]
                o += z.shape[0]
                slot["ev"].set()


class DecoderService:
    """Decoder (a checkpoint's, through the kernels, or an artifact) +
    optional latent table; thread-safe decode calls."""

    def __init__(
        self,
        decoder_path: str | None,
        checkpoint_path: str | None = None,
        max_width: int = 2048,
        max_batch: int = 64,
        batch_window_ms: float = 0.0,
        device=None,
        artifact_path: str | None = None,
    ):
        from reni_tpu_torch import serve as _serve
        from reni_tpu_torch.train import checkpoint as ckpt

        if (decoder_path is None) == (artifact_path is None):
            raise ValueError("give exactly one of a decoder checkpoint and an artifact")
        self.decoder_path = decoder_path
        self.artifact_path = artifact_path
        self.max_width = int(max_width)
        self.max_batch = int(max_batch)
        self.latents = None
        # rotation_y relies on rotation equivariance: the decoder's config,
        # or for an artifact --checkpoint's (None = unknown)
        if artifact_path is None:
            self.fn = _serve.load_decoder(decoder_path, device)
            self.equivariance = self.fn.config.equivariance
        else:
            self.fn = _serve.load_exported(artifact_path, device)
            self.equivariance = None
            if checkpoint_path is not None:
                try:
                    self.equivariance = ckpt.load_model_config(checkpoint_path).equivariance
                except (OSError, KeyError, ValueError, TypeError):
                    pass  # a checkpoint without a model config: unknown
        self.device = self.fn.device
        if checkpoint_path is not None:
            params, _ = ckpt.load_checkpoint(checkpoint_path)
            lat = params.get("latents") or {}
            table = lat.get("mu", lat.get("Z"))
            if table is None:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} contains no latent "
                    "table ('mu' or 'Z'); start without --checkpoint"
                )
            self.latents = np.asarray(table, np.float32)
        self._dirs: dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()
        self.batcher = (
            _MicroBatcher(self, batch_window_ms) if batch_window_ms > 0 else None
        )

    def directions(self, width: int) -> torch.Tensor:
        """The (1, P, 3) direction grid for ``width``, cached on the device."""
        with self._lock:
            d = self._dirs.get(width)
            if d is None:
                d = sphere.get_directions(width, device=self.device)
                self._dirs[width] = d
            return d

    def decode(self, z: np.ndarray, width: int, rotation_y: float = 0.0) -> np.ndarray:
        """z: (B, N, 3) -> (B, W//2, W, 3) radiance; rotation_y in degrees
        rotates the illumination via latent rotation."""
        if rotation_y:
            z = _rotate(z, rotation_y)
        d = self.directions(width)
        # a stride-0 view: the kernel reads it as one shared grid
        d = d.expand(z.shape[0], *d.shape[1:])
        out = self.fn(np.asarray(z, np.float32), d).cpu().numpy()
        return out.reshape(z.shape[0], width // 2, width, out.shape[-1])

    def decode_idx(self, idx, width: int, rotation_y: float = 0.0) -> np.ndarray:
        if self.latents is None:
            raise ValueError("no latent table: start the daemon with --checkpoint")
        return self.submit(
            self.latents[np.asarray(idx, dtype=np.int64)], width, rotation_y
        )

    def warmup(self, widths, batch: int = 1) -> None:
        """Decode a zero latent at each width, so the first real request
        does not pay the kernel build and the weight upload."""
        z = np.zeros((batch, self.fn.latent_dim, 3), np.float32)
        for w in widths:
            self.decode(z, int(w))

    def submit(self, z: np.ndarray, width: int, rotation_y: float = 0.0) -> np.ndarray:
        """decode(), through the micro-batcher when enabled; rotation is a
        per-request latent transform applied here, so differently rotated
        requests still coalesce."""
        if self.batcher is None:
            return self.decode(z, width, rotation_y)
        if rotation_y:
            z = _rotate(z, rotation_y)
        return self.batcher.decode(z, width)


def _encode(out: np.ndarray, fmt: str) -> dict:
    body = {"shape": list(out.shape)}
    if fmt == "base64":
        body["dtype"] = "float32"
        body["data"] = base64.b64encode(
            np.ascontiguousarray(out, dtype=np.float32).tobytes()
        ).decode("ascii")
    else:
        body["data"] = out.tolist()
    return body


def make_handler(service: DecoderService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = {
                    "ok": True,
                    "decoder": service.decoder_path,
                    "artifact": service.artifact_path,
                    "device": str(service.device),
                    "has_latents": service.latents is not None,
                    "dataset_size": None
                    if service.latents is None
                    else int(service.latents.shape[0]),
                }
                if service.batcher is not None:
                    body["batching"] = {
                        "window_ms": service.batcher.window * 1000.0,
                        **service.batcher.stats,
                    }
                self._reply(200, body)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _bad(self, msg: str):
            self._reply(400, {"error": msg})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                width = int(req.get("width", 128))
                fmt = req.get("format", "list")
                rot = float(req.get("rotation_y", 0.0))
                if not math.isfinite(rot):
                    # json.loads accepts NaN/Infinity
                    return self._bad(f"rotation_y must be finite, got {rot}")
                if rot and service.equivariance == "None":
                    return self._bad(
                        "this decoder was trained with EQUIVARIANCE None — "
                        "latent rotation does not rotate its illumination"
                    )
                # request caps: one oversized width/batch would allocate
                # O(B * W^2) floats on host and device
                if not 2 <= width <= service.max_width or width % 2:
                    return self._bad(
                        f"width must be even and in [2, {service.max_width}], "
                        f"got {width}"
                    )
                if self.path == "/decode":
                    z = np.asarray(req["z"], dtype=np.float32)
                    if z.ndim == 2:
                        z = z[None]
                    if z.shape[0] > service.max_batch:
                        return self._bad(
                            f"batch {z.shape[0]} exceeds the daemon cap "
                            f"({service.max_batch})"
                        )
                    out = service.submit(z, width, rot)
                elif self.path == "/decode_idx":
                    idx = np.asarray(req["idx"]).reshape(-1)
                    if idx.size > service.max_batch:
                        return self._bad(
                            f"batch {idx.size} exceeds the daemon cap "
                            f"({service.max_batch})"
                        )
                    out = service.decode_idx(idx, width, rot)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                self._reply(200, _encode(out, fmt))
            except Exception as e:  # surface errors as JSON, keep serving
                self._bad(f"{type(e).__name__}: {e}")

    return Handler


def make_server(
    decoder: str | None,
    checkpoint: str | None = None,
    host: str = "127.0.0.1",
    port: int = 0,
    max_width: int = 2048,
    max_batch: int = 64,
    batch_window_ms: float = 0.0,
    device=None,
    artifact: str | None = None,
) -> ThreadingHTTPServer:
    """Build (not run) the server over ``decoder`` (a checkpoint) or
    ``artifact``; ``.server_address`` has the bound port."""
    service = DecoderService(
        decoder, checkpoint, max_width=max_width, max_batch=max_batch,
        batch_window_ms=batch_window_ms, device=device, artifact_path=artifact,
    )
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.reni_service = service  # for --warmup and tests
    return httpd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--decoder", help="checkpoint with the decoder weights (the CUDA kernels)")
    which.add_argument("--artifact", help="decoder .pt2 from cli/export.py (the plain decoder)")
    parser.add_argument("--checkpoint", default=None, help="checkpoint with latents for /decode_idx")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8742)
    parser.add_argument(
        "--max_width", type=int, default=2048,
        help="largest accepted decode width (memory cap; W x W/2 grid)",
    )
    parser.add_argument(
        "--max_batch", type=int, default=64,
        help="largest accepted decode batch (memory cap)",
    )
    parser.add_argument(
        "--batch_window_ms", type=float, default=0.0,
        help="coalesce concurrent same-width decode requests arriving "
        "within this window into one batched decode (0 = off)",
    )
    parser.add_argument(
        "--warmup", default="",
        help="comma-separated widths to decode once at startup (e.g. 128,256) "
        "so the first request does not pay the kernel build",
    )
    args = parser.parse_args(argv)
    httpd = make_server(
        args.decoder, args.checkpoint, args.host, args.port,
        max_width=args.max_width, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, device=args.device, artifact=args.artifact,
    )
    if args.warmup:
        widths = [int(w) for w in args.warmup.split(",") if w]
        httpd.reni_service.warmup(widths)
        print(f"warmed up widths {widths}")
    print(f"serving {args.decoder or args.artifact} on http://{args.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
