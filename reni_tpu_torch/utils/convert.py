"""Convert reference (PyTorch Lightning) RENI checkpoints to and from the
port's params: the port's copy of ``reni_tpu/utils/convert.py``, the
"weights carried across" function for reference checkpoints (the npz <->
tensor one is ``params.from_numpy`` / ``to_numpy``).

The reference's Lightning checkpoint prefixes every ``state_dict`` key with
``model.`` (reference src/models/RENI.py:190-203 strips it); layer layout
(RENI.py:132-178):

Cond-by-Concat:
    model.net.{i}.linear.{weight,bias}   i in [0, hidden_layers]  (SineLayer)
    model.net.{L+1}.{weight,bias}        final nn.Linear (last_layer_linear)
    model.net.{L+1}.linear.{weight,bias} final SineLayer otherwise
    model.{mu,log_var} | model.Z         latent tables

FiLM (RENI.py:563-598):
    model.net.{i}.layer.{weight,bias}            FiLMLayer trunk
    model.final_layer.{weight,bias}
    model.mapping_network.network.{2k}.{weight,bias}  (Linear at even idx)

Torch Linear weights are (out, in); the port's, as the JAX package's, are
(in, out) (``params.py``): transposed here. Params come out as float32 CPU
tensors (contiguous copies: stepping the source module does not move them);
the state dict as float32 CPU tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from reni_tpu_torch.models.reni import RENIConfig

Params = dict[str, Any]


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor that shares no memory with ``x``."""
    return torch.tensor(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                        dtype=torch.float32)


def _linear(sd: dict, key: str) -> dict:
    return {"w": _t(sd[f"{key}.weight"]).T.contiguous(), "b": _t(sd[f"{key}.bias"])}


def _strip_prefix(state_dict: dict) -> dict:
    return {k[6:] if k.startswith("model.") else k: v for k, v in state_dict.items()}


def torch_state_dict_to_params(state_dict: dict, config: RENIConfig) -> Params:
    """Reference state dict -> the port's params tree (decoder + latents)."""
    sd = _strip_prefix(state_dict)
    if config.is_film:
        layers = []
        while f"net.{len(layers)}.layer.weight" in sd:
            layers.append(_linear(sd, f"net.{len(layers)}.layer"))
        idx = sorted(
            int(k.split(".")[2])
            for k in sd
            if k.startswith("mapping_network.network.") and k.endswith(".weight")
        )
        decoder = {
            "layers": layers,
            "final": _linear(sd, "final_layer"),
            "mapping": {
                "layers": [_linear(sd, f"mapping_network.network.{j}") for j in idx[:-1]],
                "last": _linear(sd, f"mapping_network.network.{idx[-1]}"),
            },
        }
    else:
        layers = []
        while f"net.{len(layers)}.linear.weight" in sd:
            layers.append(_linear(sd, f"net.{len(layers)}.linear"))
        n = len(layers)
        if f"net.{n}.weight" in sd:  # final plain Linear
            final = _linear(sd, f"net.{n}")
        else:  # last_layer_linear=False: the last SineLayer is the final layer
            final = layers.pop()
        decoder = {"layers": layers, "final": final}

    latents = {}
    if "mu" in sd:
        latents = {"mu": _t(sd["mu"]), "log_var": _t(sd["log_var"])}
    elif "Z" in sd:
        latents = {"Z": _t(sd["Z"])}
    return {"decoder": decoder, "latents": latents}


def params_to_torch_state_dict(params: Params, config: RENIConfig) -> dict:
    """The port's params (tensors or arrays) -> reference-layout state dict
    (float32 CPU tensors, ``model.`` prefix), so checkpoints can flow back
    to the reference implementation."""
    sd: dict[str, torch.Tensor] = {}

    def put(key: str, layer: dict) -> None:
        sd[f"{key}.weight"] = _t(layer["w"]).T.contiguous()
        sd[f"{key}.bias"] = _t(layer["b"])

    dec = params["decoder"]
    if config.is_film:
        for i, layer in enumerate(dec["layers"]):
            put(f"model.net.{i}.layer", layer)
        put("model.final_layer", dec["final"])
        j = 0
        for layer in dec["mapping"]["layers"]:
            put(f"model.mapping_network.network.{j}", layer)
            j += 2  # LeakyReLU between linears
        put(f"model.mapping_network.network.{j}", dec["mapping"]["last"])
    else:
        for i, layer in enumerate(dec["layers"]):
            put(f"model.net.{i}.linear", layer)
        n = len(dec["layers"])
        put(f"model.net.{n}" if config.last_layer_linear else f"model.net.{n}.linear",
            dec["final"])

    lat = params["latents"]
    for k in ("mu", "log_var", "Z"):
        if k in lat:
            sd[f"model.{k}"] = _t(lat[k])
    return sd


def config_from_yacs(yacs_cfg, task: str | None = None) -> RENIConfig:
    """Translate the reference's embedded yacs config (or a dict of its
    layout) to a RENIConfig."""
    r = yacs_cfg["RENI"] if isinstance(yacs_cfg, dict) else yacs_cfg.RENI
    get = (lambda k: r[k]) if isinstance(r, dict) else (lambda k: getattr(r, k))
    fixed = task in ("FIT_LATENT", "FIT_INVERSE") if task else False
    return RENIConfig(
        model_type=get("MODEL_TYPE"),
        conditioning=get("CONDITIONING"),
        equivariance=str(get("EQUIVARIANCE")),
        latent_dim=get("LATENT_DIMENSION"),
        hidden_layers=get("HIDDEN_LAYERS"),
        hidden_features=get("HIDDEN_FEATURES"),
        out_features=get("OUT_FEATURES"),
        last_layer_linear=get("LAST_LAYER_LINEAR"),
        output_activation=get("OUTPUT_ACTIVATION"),
        first_omega_0=get("FIRST_OMEGA_0"),
        hidden_omega_0=get("HIDDEN_OMEGA_0"),
        mapping_layers=get("MAPPING_LAYERS"),
        mapping_features=get("MAPPING_FEATURES"),
        fixed_decoder=fixed,
    )


def reference_config(cfg: RENIConfig) -> dict:
    """A RENIConfig in the reference's hyper_parameters layout (``{"RENI":
    {...}}``), which ``config_from_yacs`` reads back."""
    return {
        "RENI": {
            "MODEL_TYPE": cfg.model_type,
            "CONDITIONING": cfg.conditioning,
            "EQUIVARIANCE": cfg.equivariance,
            "LATENT_DIMENSION": cfg.latent_dim,
            "HIDDEN_LAYERS": cfg.hidden_layers,
            "HIDDEN_FEATURES": cfg.hidden_features,
            "OUT_FEATURES": cfg.out_features,
            "LAST_LAYER_LINEAR": cfg.last_layer_linear,
            "OUTPUT_ACTIVATION": cfg.output_activation,
            "FIRST_OMEGA_0": cfg.first_omega_0,
            "HIDDEN_OMEGA_0": cfg.hidden_omega_0,
            "MAPPING_LAYERS": cfg.mapping_layers,
            "MAPPING_FEATURES": cfg.mapping_features,
        }
    }


def load_reference_checkpoint(
    path: str, model_config: RENIConfig | None = None, task: str | None = None
) -> tuple[Params, RENIConfig]:
    """Load a reference Lightning ``.ckpt`` -> (params, RENIConfig); the
    config comes from the file's ``hyper_parameters`` unless
    ``model_config`` is given.

    The file is unpickled in full (``torch.load(weights_only=False)``): a
    real Lightning checkpoint pickles yacs config nodes, which the weights-only
    loader refuses. Unpickling runs code the file names, so load only a
    checkpoint you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    if model_config is None:
        hp = ckpt.get("hyper_parameters", {})
        if "config" not in hp:
            raise ValueError("checkpoint has no embedded config; pass model_config explicitly")
        model_config = config_from_yacs(hp["config"], task)
    return torch_state_dict_to_params(state_dict, model_config), model_config
