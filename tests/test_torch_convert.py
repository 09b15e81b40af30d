"""The port's reference-checkpoint conversion (reni_tpu_torch.utils.convert,
cli/convert.py) on the CPU: tests/test_convert.py's round trip, file load
and CLI cases on the port, and the port held to the JAX package's
(reni_tpu/utils/convert.py, reni_tpu/cli/convert.py) bit for bit: the same
params give the same reference state dict and back, and each package's
``--to_torch`` file imports in the other."""

import contextlib
import io

import numpy as np
import jax
import pytest
import torch

from reni_tpu.cli.convert import main as jconvert_main
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import checkpoint as jck
from reni_tpu.utils import convert as jconvert
from reni_tpu_torch import params as tparams
from reni_tpu_torch.cli.convert import main as convert_main
from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.utils import convert

YACS_LIKE = {"RENI": {
    "MODEL_TYPE": "VariationalAutoDecoder", "CONDITIONING": "Cond-by-Concat",
    "EQUIVARIANCE": "SO2", "LATENT_DIMENSION": 6, "HIDDEN_LAYERS": 2, "HIDDEN_FEATURES": 32,
    "OUT_FEATURES": 3, "LAST_LAYER_LINEAR": True, "OUTPUT_ACTIVATION": "tanh",
    "FIRST_OMEGA_0": 30.0, "HIDDEN_OMEGA_0": 30.0, "MAPPING_LAYERS": 2, "MAPPING_FEATURES": 32,
}}


def _kw(conditioning="Cond-by-Concat", variational=True, lll=True):
    return dict(model_type="VariationalAutoDecoder" if variational else "AutoDecoder",
                conditioning=conditioning, equivariance="SO2", latent_dim=6, hidden_layers=2,
                hidden_features=32, mapping_layers=2, mapping_features=32,
                last_layer_linear=lll, output_activation="tanh")


def _jax_params(seed, **kw):
    return jax.device_get(JModel(JConfig(**kw)).init(jax.random.PRNGKey(seed), dataset_size=3))


def _assert_trees_equal(a, b):
    """Same leaf paths (in any order: JAX's trees sort their keys), float32
    leaves, equal bits."""
    la, lb = dict(tparams.tree_items(a)), dict(tparams.tree_items(b))
    assert sorted(la) == sorted(lb)
    for k, x in la.items():
        y = lb[k]
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=k)


CASES = [("Cond-by-Concat", True, True), ("Cond-by-Concat", False, True),
         ("Cond-by-Concat", True, False), ("FiLM", True, True), ("FiLM", False, True)]


@pytest.mark.parametrize("conditioning,variational,lll", CASES)
def test_roundtrip_params_state_dict(conditioning, variational, lll):
    kw = _kw(conditioning, variational, lll)
    model = RENIModel(RENIConfig(**kw))
    params = model.init(torch.Generator().manual_seed(0), dataset_size=3, device="cpu")
    sd = convert.params_to_torch_state_dict(params, model.config)
    assert all(k.startswith("model.") and v.dtype == torch.float32 for k, v in sd.items())
    _assert_trees_equal(params, convert.torch_state_dict_to_params(sd, model.config))


@pytest.mark.parametrize("conditioning,variational,lll", CASES)
def test_conversion_is_jaxs_bit_for_bit(conditioning, variational, lll):
    """The same params: the port's state dict equals JAX's key for key, and
    each package's import of it gives the same params."""
    kw = _kw(conditioning, variational, lll)
    jp = _jax_params(1, **kw)
    jsd = jconvert.params_to_torch_state_dict(jp, JConfig(**kw))
    sd = convert.params_to_torch_state_dict(tparams.from_numpy(jp, "cpu"), RENIConfig(**kw))
    assert list(sd) == list(jsd)
    for k in sd:
        assert sd[k].shape == jsd[k].shape, k
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)
    ours = convert.torch_state_dict_to_params(sd, RENIConfig(**kw))
    _assert_trees_equal(ours, jconvert.torch_state_dict_to_params(jsd, JConfig(**kw)))
    _assert_trees_equal(ours, jp)


def test_converted_params_do_not_share_the_modules_memory():
    """Stepping the source state dict in place leaves the converted params
    as they were (JAX's ``_np`` copies for the same reason)."""
    kw = _kw()
    sd = convert.params_to_torch_state_dict(tparams.from_numpy(_jax_params(2, **kw), "cpu"),
                                            RENIConfig(**kw))
    params = convert.torch_state_dict_to_params(sd, RENIConfig(**kw))
    before = params["decoder"]["final"]["b"].clone()
    sd["model.net.3.bias"].add_(1.0)
    assert torch.equal(params["decoder"]["final"]["b"], before)


def test_load_reference_checkpoint_file(tmp_path):
    """A Lightning-style .ckpt (state_dict + hyper_parameters.config as a
    plain dict) loads into the params JAX's loader gives."""
    kw = _kw()
    jp = _jax_params(4, **kw)
    sd = {k: torch.from_numpy(v.copy())
          for k, v in jconvert.params_to_torch_state_dict(jp, JConfig(**kw)).items()}
    path = str(tmp_path / "reference.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": {"config": YACS_LIKE}}, path)

    loaded, cfg = convert.load_reference_checkpoint(path, task="FIT_LATENT")
    assert cfg.fixed_decoder is True and cfg.latent_dim == 6 and isinstance(cfg, RENIConfig)
    jloaded, jcfg = jconvert.load_reference_checkpoint(path, task="FIT_LATENT")
    _assert_trees_equal(loaded, jloaded)
    _assert_trees_equal(loaded, jp)
    fields = set(RENIConfig.__dataclass_fields__) & set(JConfig.__dataclass_fields__)
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}

    torch.save({"state_dict": sd}, str(tmp_path / "bare.ckpt"))
    with pytest.raises(ValueError, match="no embedded config"):
        convert.load_reference_checkpoint(str(tmp_path / "bare.ckpt"))
    loaded, cfg = convert.load_reference_checkpoint(str(tmp_path / "bare.ckpt"),
                                                    model_config=RENIConfig(**kw))
    _assert_trees_equal(loaded, jp)


@pytest.mark.parametrize("conditioning", ["Cond-by-Concat", "FiLM"])
def test_convert_cli_round_trip(tmp_path, conditioning):
    """ours -> Lightning .ckpt -> ours gives the same params and decode; the
    port's .ckpt is JAX's (same keys, tensors and embedded config), and each
    package's --from_torch of it writes the same checkpoint."""
    kw = _kw(conditioning)
    model = RENIModel(RENIConfig(**kw))
    params = model.init(torch.Generator().manual_seed(5), dataset_size=3, device="cpu")
    ours = str(tmp_path / "ours")
    tck.save_checkpoint(ours, params, model_config=model.config, metadata={})

    with contextlib.redirect_stdout(io.StringIO()):
        assert convert_main(["--to_torch", ours, "--out", str(tmp_path / "ref.ckpt")]) == 0
        assert jconvert_main(["--to_torch", ours, "--out", str(tmp_path / "jref.ckpt")]) == 0
    blob = torch.load(str(tmp_path / "ref.ckpt"), weights_only=False)
    jblob = torch.load(str(tmp_path / "jref.ckpt"), weights_only=False)
    assert blob["hyper_parameters"] == jblob["hyper_parameters"]
    assert list(blob["state_dict"]) == list(jblob["state_dict"])
    for k, v in blob["state_dict"].items():
        assert torch.equal(v, jblob["state_dict"][k]), k

    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert convert_main(["--from_torch", str(tmp_path / "ref.ckpt"),
                             "--out", str(tmp_path / "back")]) == 0
        assert jconvert_main(["--from_torch", str(tmp_path / "ref.ckpt"),
                              "--out", str(tmp_path / "jback")]) == 0
    assert f"-> {tmp_path / 'back'}.npz" in out.getvalue()
    back, meta = tck.load_checkpoint(str(tmp_path / "back"))
    jback, jmeta = jck.load_checkpoint(str(tmp_path / "jback"))
    _assert_trees_equal(back, jback)
    _assert_trees_equal(back, params)
    assert meta["source"] == str(tmp_path / "ref.ckpt")

    D = sphere.get_directions(16, device="cpu")
    Z = model.latents(params, [0, 1, 2]).detach()
    with torch.no_grad():
        np.testing.assert_array_equal(
            model.apply(params, Z, D).numpy(),
            RENIModel(tck.load_model_config(str(tmp_path / "back"))).apply(
                tparams.from_numpy(back, "cpu"), Z, D).numpy())
