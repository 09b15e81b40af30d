"""The port's serving export (reni_tpu_torch.serve.export_decoder /
load_exported, cli/export.py, cli/serve.py --artifact) on the CPU, beside
the JAX package's (reni_tpu/serve.py, tests/test_serve.py): the loaded
artifact bit for bit the plain decoder at three (B, P) shapes incl. width
256 and B = 1, a child process that imports only torch, the export CLI, the
daemon serving an artifact as it serves a checkpoint, and the artifact
against JAX's ``export_decoder`` on the same params at the float32 forward
bar."""

import base64
import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu import serve as jserve
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import checkpoint as jck
from reni_tpu_torch import params as tparams
from reni_tpu_torch import serve as tserve
from reni_tpu_torch.cli.export import main as export_main
from reni_tpu_torch.cli.serve import DecoderService, make_server
from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import checkpoint as tck

F32_BAR = 5e-5  # ROADMAP: float32 forwards of two paths
SHAPES = [(1, 32), (3, 64), (2, 256)]  # (B, width): P = 512, 2,048, 32,768
CONFIGS = {
    "Cond-by-Concat": dict(latent_dim=6, hidden_layers=2, hidden_features=256),
    "FiLM": dict(conditioning="FiLM", latent_dim=6, hidden_layers=2, hidden_features=256,
                 mapping_layers=2, mapping_features=64),
}


def _model(conditioning, seed=0):
    """A 2 x 256 decoder of the Zoo's kind (tanh, fast sine, use_pallas on:
    the export takes the plain decoder all the same)."""
    cfg = RENIConfig(**CONFIGS[conditioning], use_pallas=True, fast_sine=True)
    model = RENIModel(cfg)
    return model, model.init(torch.Generator().manual_seed(seed), dataset_size=3, device="cpu")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{conditioning: (model, params, artifact path)}, exported once."""
    out = {}
    for conditioning in CONFIGS:
        model, params = _model(conditioning)
        path = str(tmp_path_factory.mktemp("export") / "decoder.pt2")
        tserve.save_exported(tserve.export_decoder(model, params), path)
        out[conditioning] = model, params, path
    return out


def _plain(model, params, Z, D):
    plain = RENIModel(dataclasses.replace(model.config, use_pallas=False))
    with torch.no_grad():
        return plain.apply(params, Z, D)


@pytest.mark.parametrize("conditioning", list(CONFIGS))
@pytest.mark.parametrize("B,width", SHAPES)
def test_artifact_is_the_plain_decoder_bit_for_bit(artifacts, conditioning, B, width):
    model, params, path = artifacts[conditioning]
    f = tserve.load_exported(path, "cpu")
    assert f.latent_dim == model.config.latent_dim
    rng = np.random.default_rng(B)
    Z = torch.tensor(rng.normal(size=(B, model.config.latent_dim, 3)), dtype=torch.float32)
    D = sphere.get_directions(width, device="cpu").expand(B, -1, -1)
    out = f(Z, D)
    assert out.shape == (B, width * width // 2, 3)
    assert torch.equal(out, _plain(model, params, Z, D))


def test_a_torch_only_process_loads_and_calls_it(artifacts, tmp_path):
    """``torch.export.load`` of both artifacts in one child whose path cannot
    reach the package (no PYTHONPATH, another directory): the decoder's code
    is in the file."""
    Z = np.random.default_rng(5).normal(size=(2, 6, 3)).astype(np.float32)
    D = sphere.get_directions(16, device="cpu").expand(2, -1, -1).numpy()
    np.save(tmp_path / "z.npy", Z)
    np.save(tmp_path / "d.npy", np.ascontiguousarray(D))
    paths = [artifacts[c][2] for c in CONFIGS]
    code = (
        "import sys, numpy as np, torch\n"
        "z, d = torch.from_numpy(np.load('z.npy')), torch.from_numpy(np.load('d.npy'))\n"
        f"for i, path in enumerate({paths!r}):\n"
        "    out = torch.export.load(path).module()(z, d)\n"
        "    np.save(f'out{i}.npy', out.detach().numpy())\n"
        "assert not [m for m in sys.modules if m.startswith('reni_tpu')]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for i, c in enumerate(CONFIGS):
        model, params, _ = artifacts[c]
        ref = _plain(model, params, torch.from_numpy(Z), torch.from_numpy(D))
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"), ref.numpy())


@pytest.mark.parametrize("conditioning", list(CONFIGS))
def test_artifact_moves_to_another_device(artifacts, conditioning):
    """Traced on the CPU, the graph names no device: its weights move with
    ``.to`` and it runs there (the meta device stands in for the card)."""
    model, _, path = artifacts[conditioning]
    f = torch.export.load(path).module().to("meta")
    out = f(torch.empty(1, model.config.latent_dim, 3, device="meta"),
            torch.empty(1, 77, 3, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (1, 77, 3)
    assert "cpu" not in torch.export.load(path).graph_module.code


def test_export_cli_from_checkpoint(tmp_path, capsys):
    model, params = _model("Cond-by-Concat", seed=3)
    ck = str(tmp_path / "ck")
    tck.save_checkpoint(ck, params, model_config=model.config, metadata={"epoch": 1})
    out = str(tmp_path / "dec.pt2")
    assert export_main(["--checkpoint", ck, "--out", out, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"exported VariationalAutoDecoder/Cond-by-Concat/SO2 N=6 2x256 -> {out}")
    f = tserve.load_exported(out, "cpu")
    Z = model.latents(params, [0, 2]).detach()
    D = sphere.get_directions(16, device="cpu")
    assert torch.equal(f(Z, D.expand(2, -1, -1)), _plain(model, params, Z, D))


def test_export_needs_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = _model("Cond-by-Concat")
    ck = str(tmp_path / "ck")
    tck.save_checkpoint(ck, params, model_config=model.config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_main(["--checkpoint", ck, "--out", str(tmp_path / "a.pt2")])
    assert not (tmp_path / "a.pt2").exists()


# ---------------------------------------------------------------------------
# the daemon with --artifact
# ---------------------------------------------------------------------------


def _jax_checkpoint(tmp_path, seed, **kw):
    # the float32 trunk: the --decoder daemon's fused path then holds to the
    # plain decoder at the float32 bar
    cfg = JConfig(**{**dict(latent_dim=4, hidden_layers=1, hidden_features=16,
                            output_activation=None, pallas_trunk="float32"), **kw})
    model = JModel(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), dataset_size=4))
    ck = str(tmp_path / f"ck{seed}")
    jck.save_checkpoint(ck, params, model_config=cfg, metadata={"epoch": 1})
    art = str(tmp_path / f"dec{seed}.pt2")
    assert export_main(["--checkpoint", ck, "--out", art, "--device", "cpu"]) == 0
    return model, params, ck, art


class _Daemon:
    def __init__(self, **kw):
        self.httpd = make_server(port=0, device="cpu", **kw)
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
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())


def _decoded(body):
    return np.frombuffer(base64.b64decode(body["data"]), np.float32).reshape(body["shape"])


def test_daemon_serves_an_artifact_like_a_checkpoint(tmp_path):
    """/healthz names the artifact; /decode and /decode_idx (latents from
    --checkpoint) equal the artifact's direct call bit for bit and the
    --decoder daemon's decode of the same checkpoint within the float32
    bar; a warm-up reads N from the artifact."""
    model, params, ck, art = _jax_checkpoint(tmp_path, 5, equivariance="SO2")
    f = tserve.load_exported(art, "cpu")
    width = 16
    D = sphere.get_directions(width, device="cpu")
    with _Daemon(decoder=None, checkpoint=ck, artifact=art) as a, \
            _Daemon(decoder=ck, checkpoint=ck) as d:
        health = a.get("/healthz")
        assert health["ok"] and health["artifact"] == art and health["decoder"] is None
        assert health["has_latents"] and health["dataset_size"] == 4
        Z = np.asarray(params["latents"]["mu"][:2])
        code, body = a.post("/decode", {"z": Z.tolist(), "width": width, "format": "base64"})
        assert code == 200 and body["shape"] == [2, 8, 16, 3]
        direct = f(Z, D.expand(2, -1, -1)).numpy().reshape(body["shape"])
        np.testing.assert_array_equal(_decoded(body), direct)
        code, body = a.post("/decode_idx", {"idx": [0, 1], "width": width, "format": "base64"})
        assert code == 200
        np.testing.assert_array_equal(_decoded(body), direct)
        by_decoder = _decoded(d.post("/decode_idx", {"idx": [0, 1], "width": width,
                                                    "format": "base64"})[1])
        np.testing.assert_allclose(_decoded(body), by_decoder, atol=F32_BAR)
        # equivariance from --checkpoint (SO2): a rotation is a column roll
        code, rot = a.post("/decode_idx", {"idx": [0, 1], "width": width, "rotation_y": 90.0})
        assert code == 200
        np.testing.assert_allclose(np.asarray(rot["data"]), np.roll(direct, width // 4, axis=2),
                                   atol=2e-5)
        a.httpd.reni_service.warmup([16])


def test_artifact_rotation_rule_and_guards(tmp_path):
    """As the JAX daemon: with --checkpoint of an EQUIVARIANCE None decoder a
    rotation is refused; without --checkpoint the equivariance is unknown and
    a rotation is served, /decode_idx is refused, and NaN is refused."""
    _, params, ck, art = _jax_checkpoint(tmp_path, 9, equivariance="None")
    with _Daemon(decoder=None, checkpoint=ck, artifact=art) as a:
        code, body = a.post("/decode_idx", '{"idx": [0], "width": 16, "rotation_y": 45.0}')
        assert code == 400 and "EQUIVARIANCE None" in body["error"]
        assert a.post("/decode_idx", {"idx": [0], "width": 16})[0] == 200
    with _Daemon(decoder=None, artifact=art) as a:
        assert a.get("/healthz")["has_latents"] is False
        z = np.asarray(params["latents"]["mu"][:1]).tolist()
        assert a.post("/decode", {"z": z, "width": 16, "rotation_y": 45.0})[0] == 200
        code, body = a.post("/decode", '{"z": [[0, 0, 0]], "width": 16, "rotation_y": NaN}')
        assert code == 400 and "finite" in body["error"]
        code, body = a.post("/decode_idx", {"idx": [0], "width": 16})
        assert code == 400 and "--checkpoint" in body["error"]


def test_exactly_one_of_decoder_and_artifact(tmp_path):
    from reni_tpu_torch.cli.serve import main as serve_main

    _, _, ck, art = _jax_checkpoint(tmp_path, 2)
    with pytest.raises(ValueError, match="exactly one"):
        DecoderService(ck, None, device="cpu", artifact_path=art)
    with pytest.raises(ValueError, match="exactly one"):
        DecoderService(None, ck, device="cpu")
    with pytest.raises(SystemExit):
        serve_main(["--decoder", ck, "--artifact", art, "--device", "cpu"])


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_artifact_matches_jax_export(tmp_path, conditioning):
    """The same params through JAX's ``export_decoder`` and the port's, each
    loaded and called on the same (B, P) inputs: within 5e-5."""
    kw = dict(latent_dim=4, hidden_layers=2, hidden_features=32, output_activation="tanh",
              fast_sine=True)
    if conditioning == "FiLM":
        kw.update(conditioning="FiLM", mapping_layers=2, mapping_features=32)
    jmodel = JModel(JConfig(**kw))
    jp = jax.device_get(jmodel.init(jax.random.PRNGKey(7), dataset_size=3))
    jpath = str(tmp_path / "dec.jaxexport")
    jserve.save_exported(jserve.export_decoder(jmodel, jp), jpath)
    tpath = str(tmp_path / "dec.pt2")
    tmodel = RENIModel(RENIConfig(**kw))
    tserve.save_exported(tserve.export_decoder(tmodel, tparams.from_numpy(jp, "cpu")), tpath)
    rng = np.random.default_rng(3)
    Z = rng.normal(size=(3, 4, 3)).astype(np.float32)
    D = np.broadcast_to(sphere.get_directions(32, device="cpu").numpy(), (3, 512, 3))
    ref = np.asarray(jserve.load_exported(jpath)(jnp.asarray(Z), jnp.asarray(D)))
    out = tserve.load_exported(tpath, "cpu")(Z, D).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_BAR, rtol=0)
