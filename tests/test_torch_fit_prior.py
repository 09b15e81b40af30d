"""The downstream recipe on the port (examples/fit_prior_torch.py, ROADMAP
A-14) and the zoo discovery it resolves ``--checkpoint zoo`` through
(reni_tpu_torch.utils.assets), on the CPU: the script in a child process
with ``--device cpu`` (the demo decoder, and a Zoo entry with an image and a
mask), its optimisation held for 10 float64 steps to the JAX package's
``make_fit_latent_step`` at the script's constants (examples/fit_prior.py),
and the assets API equal to reni_tpu/utils/assets.py's on data/Zoo."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.core import sphere as jsph
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import tasks as jtasks
from reni_tpu.train.optim import OptimConfig as JOptimConfig
from reni_tpu.train.optim import build_optimizer as jbuild_optimizer
from reni_tpu.utils import assets as jassets
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import sphere
from reni_tpu_torch.data import synthetic
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.utils import assets
from reni_tpu_torch.utils.config import get_cfg_defaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "fit_prior_torch.py")
sys.path.insert(0, os.path.join(ROOT, "examples"))
import fit_prior_torch as fp  # noqa: E402


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs its files in parallel workers
    return subprocess.run([sys.executable, SCRIPT, "--device", "cpu", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def _losses(stdout: str) -> list[float]:
    return [float(line.split("loss=")[1]) for line in stdout.splitlines()
            if line.startswith("step ")]


def test_script_runs_with_the_demo_decoder():
    res = _run("--width", "32", "--steps", "101")
    assert res.returncode == 0, res.stderr
    first, last = _losses(res.stdout)
    assert last < first, res.stdout
    assert "101 steps on cpu: the first" in res.stdout and "ms a step" in res.stdout
    assert "decoded rotated illumination: (1, 512, 3)" in res.stdout


def test_script_runs_on_a_zoo_entry_with_image_and_mask(tmp_path):
    """``--checkpoint zoo`` (the best eval card's entry) fitted through
    Mask-3 to a seed-1 sky; the loss falls."""
    folders = synthetic.write_dataset(str(tmp_path), 0, 1, 64, 1)
    image = os.path.join(folders["Test"], "sky_0000.exr")
    res = _run("--checkpoint", "zoo", "--image", image, "--mask",
               os.path.join(ROOT, "data", "Masks", "Mask-3.png"), "--width", "32",
               "--steps", "101")
    assert res.returncode == 0, res.stderr
    assert f"using bundled zoo model {jassets.zoo_default()}" in res.stdout
    first, last = _losses(res.stdout)
    assert last < first, res.stdout


def test_script_needs_the_card_by_default():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, SCRIPT, "--steps", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_fit_latent_matches_jax_float64():
    """10 steps of the script's optimisation (Adam, LR 1e-1 -> 1e-2 over the
    steps, alpha 1e-7, beta 1e-1) from one initial latent, through a masked
    sine weight, against JAX's ``make_fit_latent_step`` under x64: every
    loss and the fitted latent within 1e-10 relative."""
    width, steps = 16, 10
    kw = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=9,
              hidden_layers=2, hidden_features=32, output_activation="tanh", fixed_decoder=True)
    rng = np.random.default_rng(0)
    jp = jax.device_get(JModel(JConfig(**kw)).init(jax.random.PRNGKey(0), dataset_size=1))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
    jp["latents"]["mu"] = rng.normal(scale=0.5, size=(1, 9, 3))
    target = np.tanh(rng.normal(size=(1, width * width // 2, 3)))
    mask = sphere.get_mask(width, os.path.join(ROOT, "data", "Masks", "Mask-3.png"),
                           device="cpu")

    model = RENIModel(RENIConfig(**kw))
    params, losses, _, _ = fp.fit_latent(
        model, tparams.from_numpy(jp, "cpu"), torch.tensor(target),
        sphere.get_directions(width, device="cpu"),
        sphere.get_sineweight(width, device="cpu") * mask, steps,
        torch.Generator().manual_seed(3), log_every=0)

    with jax.enable_x64():
        jmodel = JModel(JConfig(**kw))
        opt = jbuild_optimizer(JOptimConfig(lr_start=fp.LR_START, lr_end=fp.LR_END,
                                            epochs=steps, steps_per_epoch=1))
        step = jax.jit(jtasks.make_fit_latent_step(
            jmodel, opt, jsph.get_directions(width),
            jsph.get_sineweight(width) * jnp.asarray(mask.numpy()),
            alpha=fp.ALPHA, beta=fp.BETA))
        state = jtasks.init_train_state(jmodel, jax.tree.map(jnp.asarray, jp), opt,
                                        jax.random.PRNGKey(3))
        batch = (jnp.asarray(target), jnp.asarray([0]), jnp.asarray([1.0]))
        jlosses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            jlosses.append(float(metrics["loss"]))
        jmu = np.asarray(state.trainable["latents"]["mu"])
    assert losses.dtype == np.float64 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-10, atol=0)
    np.testing.assert_allclose(params["latents"]["mu"].detach().numpy(), jmu, rtol=1e-10,
                               atol=1e-10 * np.abs(jmu).max())
    assert (fp.LR_START, fp.LR_END, fp.ALPHA, fp.BETA) == (1e-1, 1e-2, 1e-7, 1e-1)


# ---------------------------------------------------------------------------
# utils/assets.py against the JAX package's
# ---------------------------------------------------------------------------


def test_zoo_discovery_equals_jaxs():
    models = assets.zoo_models()
    assert models == jassets.zoo_models() and len(models) == 6
    assert assets.bundled_zoo_dir() == jassets.bundled_zoo_dir()
    assert assets.zoo_default() == jassets.zoo_default()
    for name in models:
        assert assets.zoo_checkpoint(name) == jassets.zoo_checkpoint(name)
    with pytest.raises(FileNotFoundError) as ours:
        assets.zoo_checkpoint("nope")
    with pytest.raises(FileNotFoundError) as theirs:
        jassets.zoo_checkpoint("nope")
    assert str(ours.value) == str(theirs.value)


def test_download_data_is_local_only(tmp_path):
    cfg = get_cfg_defaults()
    cfg.DATASET.NAME = "RENI_LDR"
    cfg.DATASET.RENI_LDR.PATH = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError) as ours:
        assets.download_data(cfg)
    with pytest.raises(FileNotFoundError) as theirs:
        jassets.download_data(cfg)
    assert str(ours.value) == str(theirs.value)
    cfg.DATASET.RENI_LDR.PATH = str(tmp_path)
    assets.download_data(cfg)


def test_download_pretrained_models_is_local_only(tmp_path, monkeypatch):
    (tmp_path / "have").mkdir()
    (tmp_path / "have" / "x").write_text("")
    assets.download_pretrained_models(str(tmp_path / "have"))  # present: nothing to do
    monkeypatch.setattr(assets, "zoo_models", lambda: {})
    with pytest.raises(FileNotFoundError, match="reni_tpu_torch.cli.run"):
        assets.download_pretrained_models(str(tmp_path / "none"))


def test_select_device_reports_the_resolved_device(monkeypatch, capsys):
    assert assets.select_device("cpu") == torch.device("cpu")
    assert capsys.readouterr().out.strip() == "Using cpu: host CPU"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assets.select_device()
