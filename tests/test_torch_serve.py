"""The port's serving path (reni_tpu_torch.serve + cli/serve.py) on the CPU,
mirroring tests/test_serve.py: health, /decode, /decode_idx, request caps,
rotation_y rules and micro-batching, with decodes held against JAX
``RENIModel.apply`` on the same checkpoint."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reni_tpu.core import sphere as jsph
from reni_tpu.models.reni import RENIConfig, RENIModel
from reni_tpu.train import checkpoint as jck
from reni_tpu_torch import serve as tserve
from reni_tpu_torch.cli.serve import make_server


def _checkpoint(tmp_path, seed, **kw):
    """The port serves through the fused trunk; with the float32 trunk it
    holds to JAX's plain decoder at the f32 bars."""
    cfg = RENIConfig(**{**dict(latent_dim=4, hidden_layers=1, hidden_features=16,
                               output_activation=None, pallas_trunk="float32"), **kw})
    model = RENIModel(cfg)
    params = model.init(jax.random.PRNGKey(seed), dataset_size=4)
    ck = str(tmp_path / "ck")
    jck.save_checkpoint(ck, params, model_config=cfg, metadata={"epoch": 1})
    return model, params, ck


class _Daemon:
    def __init__(self, ck, **kw):
        self.httpd = make_server(ck, ck, port=0, device="cpu", **kw)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)

    def post(self, path, payload):
        body = payload if isinstance(payload, str) else json.dumps(payload)
        req = urllib.request.Request(self.base + path, body.encode(),
                                     {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        try:
            with urllib.request.urlopen(self.base + path, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def _jax_decode(model, params, Z, width):
    D = jsph.get_directions(width)
    out = np.asarray(model.apply(params, jnp.asarray(Z), D))
    return out.reshape(Z.shape[0], width // 2, width, out.shape[-1])


def test_http_serving_daemon(tmp_path):
    model, params, ck = _checkpoint(tmp_path, 5)
    with _Daemon(ck) as d:
        code, health = d.get("/healthz")
        assert code == 200 and health["ok"] and health["has_latents"]
        assert health["dataset_size"] == 4 and health["device"] == "cpu"

        width = 16
        Z = np.asarray(model.latents(params, jnp.arange(2)))
        code, body = d.post("/decode", {"z": Z.tolist(), "width": width, "format": "base64"})
        assert code == 200 and body["shape"] == [2, 8, 16, 3]
        out = np.frombuffer(base64.b64decode(body["data"]), np.float32).reshape(body["shape"])
        np.testing.assert_allclose(out, _jax_decode(model, params, Z, width), atol=1e-5)

        code, body = d.post("/decode", {"z": Z[0].tolist(), "width": width})  # one (N, 3)
        assert code == 200 and body["shape"] == [1, 8, 16, 3]

        code, body = d.post("/decode_idx", {"idx": [0, 2], "width": width})
        assert code == 200 and body["shape"] == [2, 8, 16, 3]
        Zi = np.asarray(model.latents(params, jnp.asarray([0, 2])))
        np.testing.assert_allclose(np.asarray(body["data"]), _jax_decode(model, params, Zi, width),
                                   atol=1e-5)

        code, body = d.post("/decode", {"width": width})  # missing z
        assert code == 400 and "error" in body
        assert d.get("/nope")[0] == 404
        assert d.post("/nope", {"width": 16})[0] == 404


def test_http_request_caps(tmp_path):
    _, _, ck = _checkpoint(tmp_path, 6)
    with _Daemon(ck, max_width=32, max_batch=2) as d:
        for width in (15, 0, 64):
            code, body = d.post("/decode_idx", {"idx": [0], "width": width})
            assert code == 400 and "width must be even" in body["error"]
        code, body = d.post("/decode_idx", {"idx": [0, 1, 2], "width": 16})
        assert code == 400 and "exceeds the daemon cap" in body["error"]
        code, body = d.post("/decode", {"z": np.zeros((3, 4, 3)).tolist(), "width": 16})
        assert code == 400 and "exceeds the daemon cap" in body["error"]
        assert d.post("/decode_idx", {"idx": [0, 1], "width": 32})[0] == 200


def test_http_rotation_equivariance(tmp_path):
    model, params, ck = _checkpoint(tmp_path, 7, hidden_features=32, equivariance="SO2")
    with _Daemon(ck) as d:
        width, cols = 32, 4  # 4 columns = 45 degrees at W=32
        plain = np.asarray(d.post("/decode_idx", {"idx": [0, 1], "width": width})[1]["data"])
        rot = np.asarray(d.post("/decode_idx", {"idx": [0, 1], "width": width,
                                                "rotation_y": 360.0 * cols / width})[1]["data"])
        np.testing.assert_allclose(rot, np.roll(plain, cols, axis=2), atol=2e-5)
        Z = np.asarray(model.latents(params, jnp.arange(1)))
        r1 = np.asarray(d.post("/decode", {"z": Z.tolist(), "width": width,
                                           "rotation_y": 90.0})[1]["data"])
        r0 = np.asarray(d.post("/decode", {"z": Z.tolist(), "width": width})[1]["data"])
        np.testing.assert_allclose(r1, np.roll(r0, width // 4, axis=2), atol=2e-5)


def test_http_micro_batching(tmp_path):
    """Concurrent same-width decodes coalesce into fewer dispatches, each
    request's result equal to the JAX decode of its (rotated) latent."""
    model, params, ck = _checkpoint(tmp_path, 11, hidden_features=32, equivariance="SO2")
    with _Daemon(ck, batch_window_ms=700.0) as d:
        width, results = 16, {}
        rots = {0: 0.0, 1: 90.0, 2: 0.0, 3: 180.0}

        def one(i):
            results[i] = np.asarray(d.post("/decode_idx", {"idx": [i], "width": width,
                                                           "rotation_y": rots[i]})[1]["data"])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and set(results) == {0, 1, 2, 3}

        d.httpd.reni_service.warmup([16], batch=2)
        stats = d.get("/healthz")[1]["batching"]
        assert stats["requests"] == 4 and stats["dispatches"] < 4, stats

        for i in range(4):
            z = np.asarray(model.latents(params, jnp.asarray([i])))
            if rots[i]:
                z = z @ np.asarray(jsph.rotation_y(-np.deg2rad(rots[i])), np.float32)
            np.testing.assert_allclose(results[i], _jax_decode(model, params, z, width),
                                       atol=1e-5, err_msg=str(i))


def test_http_rotation_guards(tmp_path):
    _, _, ck = _checkpoint(tmp_path, 9, equivariance="None")
    with _Daemon(ck) as d:
        code, body = d.post("/decode_idx", '{"idx": [0], "width": 16, "rotation_y": NaN}')
        assert code == 400 and "finite" in body["error"]
        code, body = d.post("/decode_idx", '{"idx": [0], "width": 16, "rotation_y": 45.0}')
        assert code == 400 and "EQUIVARIANCE None" in body["error"]
        assert d.post("/decode_idx", '{"idx": [0], "width": 16}')[0] == 200


def test_decode_idx_needs_latent_table(tmp_path):
    from reni_tpu_torch.cli.serve import DecoderService

    _, _, ck = _checkpoint(tmp_path, 10)
    svc = DecoderService(ck, None, device="cpu")
    with pytest.raises(ValueError, match="--checkpoint"):
        svc.decode_idx([0], 16)


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_load_decoder_fused_path_matches_jax(tmp_path, conditioning):
    """A kernel-width decoder (H=128, use_pallas, bf16 trunk, fast sine):
    the port's fused path (plain trunk on the CPU) against the JAX Pallas
    kernel in interpret mode, within the bf16 bars."""
    model, params, ck = _checkpoint(
        tmp_path, 12, conditioning=conditioning, hidden_features=128, hidden_layers=2,
        mapping_layers=1, mapping_features=32, use_pallas=True, fast_sine=True,
        output_activation="tanh", pallas_trunk="bfloat16",
    )
    fn = tserve.load_decoder(ck, "cpu")
    Z = np.asarray(model.latents(params, jnp.arange(3)))
    width = 16
    out = fn(Z, np.asarray(jsph.get_directions(width))).numpy()
    ref = _jax_decode(model, params, Z, width).reshape(out.shape)
    err = np.abs(out - ref)
    assert err.max() < 0.05 and err.mean() < 0.01, (err.max(), err.mean())
    with _Daemon(ck) as d:
        code, body = d.post("/decode_idx", {"idx": [0, 1, 2], "width": width})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["data"]).reshape(out.shape), out, atol=1e-6)
