"""RENI model facade (counterpart of ``reni_tpu/models/reni.py``), decode side.

Parameters are the JAX package's nested dict, holding tensors:

    {
      "decoder": {"layers": [...], "final": {...} [, "mapping": {...}]},
      "latents": {"Z": (S, N, 3)} | {"mu": (S, N, 3), "log_var": (S, N, 3)}
    }

``RENIConfig`` has the JAX package's field names, so
``RENIConfig(**checkpoint_json["model_config"])`` loads any checkpoint.
``use_pallas`` keeps its meaning, "take the fused kernel": here the CUDA
kernels of ``kernels/siren_fwd.py``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch

from reni_tpu_torch.kernels.siren_fwd import (
    fused_apply,
    fused_film_apply,
    unsupported_reason,
)
from reni_tpu_torch.models import film, siren

Params = dict[str, Any]

_noted_paths: set[str] = set()


def _note_trunk_path(msg: str) -> None:
    """Print once per distinct message which trunk path the dispatch took
    and why (a declined fast path is otherwise a silent slowdown)."""
    if msg not in _noted_paths:
        _noted_paths.add(msg)
        print(f"[reni_tpu] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class RENIConfig:
    """Static hyperparameters of the decoder."""

    model_type: str = "VariationalAutoDecoder"  # AutoDecoder | VariationalAutoDecoder
    conditioning: str = "Cond-by-Concat"  # Cond-by-Concat | FiLM
    equivariance: str = "SO2"  # SO3 | SO2 | None
    latent_dim: int = 49  # N (D = N x 3)
    hidden_layers: int = 5
    hidden_features: int = 256
    out_features: int = 3
    last_layer_linear: bool = True
    output_activation: str | None = "tanh"  # tanh | exp | None
    first_omega_0: float = 30.0
    hidden_omega_0: float = 30.0
    mapping_layers: int = 3
    mapping_features: int = 256
    fixed_decoder: bool = False
    use_pallas: bool = False  # take the fused trunk kernel
    pallas_trunk: str = "bfloat16"  # bfloat16 | float32 matmul inputs
    first_layer_init_scale: float = 1.0
    fast_sine: bool = False  # polynomial sine (core/fastmath.py)

    @property
    def is_variational(self) -> bool:
        return self.model_type == "VariationalAutoDecoder"

    @property
    def is_film(self) -> bool:
        return self.conditioning == "FiLM"


class RENIModel:
    """Functional model object: holds only the static config."""

    def __init__(self, config: RENIConfig):
        self.config = config

    @staticmethod
    def _as_index(idx, device) -> torch.Tensor:
        """A python int selects one row (kept batched); a list, tuple or
        array selects rows."""
        if isinstance(idx, int):
            idx = [idx]
        return torch.as_tensor(idx, dtype=torch.long, device=device)

    def latents(self, params: Params, idx=None) -> torch.Tensor:
        """Deterministic latent rows: mu for a VAD, Z for an AD."""
        table = (
            params["latents"]["mu"]
            if self.config.is_variational
            else params["latents"]["Z"]
        )
        return table if idx is None else table[self._as_index(idx, table.device)]

    def apply(self, params: Params, Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """Decode radiance at directions D given latent codes Z.

        Z: (B, N, 3); D: (B, npix, 3) or (1, npix, 3) broadcast over the
        batch. Returns (B, npix, out_features).

        With ``use_pallas`` a shape the fused kernel cannot take raises on
        the card; on the CPU it takes the plain decoder, with a note."""
        cfg = self.config
        use_pallas = cfg.use_pallas
        if use_pallas:
            B, npix = Z.shape[0], D.shape[1]
            if D.shape[0] not in (1, B):
                reason = (
                    f"direction grid batch {D.shape[0]} matches neither 1 "
                    f"nor Z batch {B}"
                )
            elif not (cfg.is_film or cfg.last_layer_linear):
                reason = "last_layer_linear=False (the kernel's final layer is linear)"
            else:
                reason = unsupported_reason(
                    npix, cfg.hidden_features, batch=B, trunk=cfg.pallas_trunk
                )
            if reason is None:
                _note_trunk_path(
                    f"fused trunk on {Z.device.type} for B={B}, npix={npix}"
                )
            elif Z.is_cuda:
                raise ValueError(
                    f"the fused CUDA kernel cannot take this decode: {reason}; "
                    "set use_pallas=False for the plain decoder"
                )
            else:
                _note_trunk_path(
                    f"plain decoder (fused kernel declined: {reason}) for "
                    f"B={B}, npix={npix}"
                )
                use_pallas = False
        if use_pallas:
            if cfg.is_film:
                return fused_film_apply(
                    params["decoder"],
                    cfg.equivariance,
                    Z,
                    D,
                    hidden_layers=cfg.hidden_layers,
                    hidden_features=cfg.hidden_features,
                    out_features=cfg.out_features,
                    output_activation=cfg.output_activation,
                    trunk=cfg.pallas_trunk,
                    fast_sine=cfg.fast_sine,
                )
            return fused_apply(
                params["decoder"],
                cfg.equivariance,
                cfg.latent_dim,
                Z,
                D,
                hidden_layers=cfg.hidden_layers,
                hidden_features=cfg.hidden_features,
                out_features=cfg.out_features,
                first_omega_0=cfg.first_omega_0,
                hidden_omega_0=cfg.hidden_omega_0,
                output_activation=cfg.output_activation,
                trunk=cfg.pallas_trunk,
                fast_sine=cfg.fast_sine,
            )
        if cfg.is_film:
            return film.apply_film_decomposed(
                params["decoder"],
                cfg.equivariance,
                Z,
                D,
                hidden_features=cfg.hidden_features,
                output_activation=cfg.output_activation,
                fast_sine=cfg.fast_sine,
            )
        return siren.apply_siren_decomposed(
            params["decoder"],
            cfg.equivariance,
            cfg.latent_dim,
            Z,
            D,
            last_layer_linear=cfg.last_layer_linear,
            output_activation=cfg.output_activation,
            first_omega_0=cfg.first_omega_0,
            hidden_omega_0=cfg.hidden_omega_0,
            fast_sine=cfg.fast_sine,
        )

    def apply_idx(self, params: Params, idx, D) -> torch.Tensor:
        """Decode dataset rows ``idx`` with their deterministic latents (mu
        for a VAD, Z for an AD). Sampling a VAD's latents for training
        arrives with the training slices."""
        return self.apply(params, self.latents(params, idx), D)
