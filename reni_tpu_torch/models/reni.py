"""RENI model facade (counterpart of ``reni_tpu/models/reni.py``): init,
decoding, latent tables and sampling, the train-step dispatch and the
trainable-parameter filter.

Parameters are the JAX package's nested dict, holding tensors:

    {
      "decoder": {"layers": [...], "final": {...} [, "mapping": {...}]},
      "latents": {"Z": (S, N, 3)} | {"mu": (S, N, 3), "log_var": (S, N, 3)}
    }

``RENIConfig`` has the JAX package's field names, so
``RENIConfig(**checkpoint_json["model_config"])`` loads any checkpoint.
``use_pallas`` keeps its meaning, "take the fused kernel": here the CUDA
kernels of ``kernels/siren_fwd.py``, for gradients ``kernels/siren_bwd.py``,
and for the FIT_DECODER objective ``kernels/siren_step.py`` (both
conditionings).
Initialisation matches the JAX package in distribution (decoder bounds as
``siren.init_siren`` / ``film.init_film_siren``; Z / mu ~ N(0, 1), log_var ~
N(-5, 1); zeros for Z / mu under ``fixed_decoder``), drawn on the CPU from
an explicit ``torch.Generator``; the numbers are torch's, not JAX's.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch

from reni_tpu_torch.kernels.siren_bwd import bwd_unsupported_reason
from reni_tpu_torch.core import encodings
from reni_tpu_torch.kernels.siren_fwd import (
    fused_apply,
    fused_film_apply,
    model_axis_reason,
    unsupported_reason,
)
from reni_tpu_torch.kernels.siren_step import (
    fused_film_step_mse,
    fused_step_mse,
    step_unsupported_reason,
)
from reni_tpu_torch.models import film, siren
from reni_tpu_torch.parallel import tp
from reni_tpu_torch.parallel.mesh import active_kernel_mesh
from reni_tpu_torch.params import map_tree, tree_leaves
from reni_tpu_torch.utils.device import resolve_device
from reni_tpu_torch.utils.profiling import span

Params = dict[str, Any]

_noted_paths: set[str] = set()


def _note_trunk_path(msg: str) -> None:
    """Print once per distinct message which trunk path the dispatch took
    and why (a declined fast path is otherwise a silent slowdown)."""
    if msg not in _noted_paths:
        _noted_paths.add(msg)
        print(f"[reni_tpu] {msg}", file=sys.stderr, flush=True)


def _mesh_suffix() -> str:
    """The active mesh (``parallel.mesh.kernel_mesh``) for a path note."""
    mesh = active_kernel_mesh()
    if mesh is None or mesh.size == 1:
        return ""
    model = f", its slice of model={mesh.n_model}" if mesh.n_model > 1 else ""
    return f" (each rank its block of data={mesh.n_data} x pixel={mesh.n_pixel}{model})"


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

    @classmethod
    def from_reni_cfg(cls, reni_cfg, task: str | None = None, tpu_cfg=None) -> "RENIConfig":
        """Build from a config tree's RENI block (the reference's key names,
        configs/default.py:6-20); ``fixed_decoder`` follows the task rule of
        the reference factory (FIT_LATENT and FIT_INVERSE train latents
        only). ``tpu_cfg``, the config's TPU block, sets the execution knobs:
        USE_PALLAS -> ``use_pallas`` (the CUDA kernels), PRECISION ->
        ``pallas_trunk`` (float32, else bfloat16), FAST_SINE -> ``fast_sine``."""
        fixed = task in ("FIT_LATENT", "FIT_INVERSE") if task is not None else False
        tpu_kwargs = {}
        fls = reni_cfg.get("FIRST_LAYER_INIT_SCALE", 1.0)
        if fls is not None and float(fls) != 1.0:
            tpu_kwargs["first_layer_init_scale"] = float(fls)
        if tpu_cfg is not None:
            tpu_kwargs["use_pallas"] = bool(tpu_cfg.USE_PALLAS)
            tpu_kwargs["pallas_trunk"] = (
                "float32" if str(tpu_cfg.PRECISION).lower() == "float32" else "bfloat16"
            )
            tpu_kwargs["fast_sine"] = bool(tpu_cfg.get("FAST_SINE", False))
        return cls(
            **tpu_kwargs,
            model_type=reni_cfg.MODEL_TYPE,
            conditioning=reni_cfg.CONDITIONING,
            equivariance=str(reni_cfg.EQUIVARIANCE),
            latent_dim=reni_cfg.LATENT_DIMENSION,
            hidden_layers=reni_cfg.HIDDEN_LAYERS,
            hidden_features=reni_cfg.HIDDEN_FEATURES,
            out_features=reni_cfg.OUT_FEATURES,
            last_layer_linear=reni_cfg.LAST_LAYER_LINEAR,
            output_activation=reni_cfg.OUTPUT_ACTIVATION,
            first_omega_0=reni_cfg.FIRST_OMEGA_0,
            hidden_omega_0=reni_cfg.HIDDEN_OMEGA_0,
            mapping_layers=reni_cfg.MAPPING_LAYERS,
            mapping_features=reni_cfg.MAPPING_FEATURES,
            fixed_decoder=fixed,
        )


class RENIModel:
    """Functional model object: holds only the static config."""

    def __init__(self, config: RENIConfig):
        self.config = config

    def init_decoder(self, generator: torch.Generator, device=None) -> Params:
        """A fresh decoder of the config's conditioning, drawn on the CPU from
        ``generator`` and moved to ``device``."""
        cfg = self.config
        dev = resolve_device(device)
        if cfg.is_film:
            siren_in, mapping_in = encodings.film_in_features(cfg.equivariance, cfg.latent_dim)
            tree = film.init_film_siren(
                generator,
                siren_in,
                mapping_in,
                cfg.hidden_features,
                cfg.hidden_layers,
                cfg.mapping_layers,
                cfg.mapping_features,
                cfg.out_features,
                first_layer_init_scale=cfg.first_layer_init_scale,
            )
        else:
            tree = siren.init_siren(
                generator,
                encodings.concat_in_features(cfg.equivariance, cfg.latent_dim),
                cfg.hidden_features,
                cfg.hidden_layers,
                cfg.out_features,
                cfg.last_layer_linear,
                cfg.first_omega_0,
                cfg.hidden_omega_0,
                first_layer_init_scale=cfg.first_layer_init_scale,
            )
        return map_tree(lambda t: t.to(dev), tree)

    def init(self, generator: torch.Generator, dataset_size: int, device=None) -> Params:
        """Fresh decoder and latent table (the decoder is drawn first)."""
        return {
            "decoder": self.init_decoder(generator, device=device),
            "latents": self.init_latents(generator, dataset_size, device=device),
        }

    def init_latents(
        self, generator: torch.Generator, dataset_size: int, device=None,
        dtype=torch.float32,
    ) -> Params:
        """A fresh latent table of ``dataset_size`` rows, drawn on the CPU from
        ``generator`` (the same numbers on any device) and moved to ``device``."""
        cfg = self.config
        shape = (dataset_size, cfg.latent_dim, 3)

        def normal():
            return torch.randn(shape, generator=generator, dtype=dtype)

        def to(t):
            return t.to(resolve_device(device))

        if cfg.is_variational:
            mu = torch.zeros(shape, dtype=dtype) if cfg.fixed_decoder else normal()
            return {"mu": to(mu), "log_var": to(-5.0 + normal())}
        z = torch.zeros(shape, dtype=dtype) if cfg.fixed_decoder else normal()
        return {"Z": to(z)}

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

    def sample_latent(
        self, params: Params, idx, generator: torch.Generator | None = None, *, noise=None
    ):
        """Reparameterised sample (VAD): (Z = mu + eps * exp(log_var / 2), mu,
        log_var) for the rows ``idx``. ``eps`` ~ N(0, 1) comes from
        ``generator`` (``draw_noise``), or is ``noise`` when given (the tests
        feed the noise JAX drew). An AD returns (Z, Z, zeros)."""
        if not self.config.is_variational:
            table = params["latents"]["Z"]
            z = table[self._as_index(idx, table.device)]
            return z, z, torch.zeros_like(z)
        table = params["latents"]["mu"]
        idx = self._as_index(idx, table.device)
        mu, log_var = table[idx], params["latents"]["log_var"][idx]
        if noise is None:
            noise = draw_noise(mu.shape, mu.dtype, mu.device, generator)
        return reparameterise(mu, log_var, noise), mu, log_var

    def apply(self, params: Params, Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """Decode radiance at directions D given latent codes Z.

        Z: (B, N, 3); D: (B, npix, 3) or (1, npix, 3) broadcast over the
        batch. Returns (B, npix, out_features).

        With ``use_pallas`` a shape the fused kernel cannot take raises on
        the card; on the CPU it takes the plain decoder, with a note. Under
        a kernel mesh (``parallel.mesh.kernel_mesh``) Z and D are this rank's
        block, so the guard checks those local extents and the note names
        the mesh. A mesh with a model axis declines the kernel (JAX's
        reason), and the decoder is ``parallel.tp``'s on the rank's slices
        of the weights. A span ``model.step`` (``utils/profiling.py``)."""
        with span("model.step", Z):
            return self._decode(params, Z, D)

    def _decode(self, params: Params, Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        use_pallas = cfg.use_pallas
        mesh = active_kernel_mesh()
        tp_mesh = mesh if mesh is not None and mesh.n_model > 1 else None
        if use_pallas:
            B, npix = Z.shape[0], D.shape[1]
            reason = self.decode_reason(B, npix, D.shape[0], grad=_needs_grad(params, Z))
            if reason is None:
                _note_trunk_path(
                    f"fused trunk{_mesh_suffix()} on {Z.device.type} for B={B}, npix={npix}"
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
        if tp_mesh is not None:
            return tp.apply(params, cfg, Z, D, tp_mesh)
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

    def decode_reason(self, batch: int, npix: int, d_batch: int = 1,
                      grad: bool = False) -> str | None:
        """Why the fused kernels cannot serve ``apply`` of ``batch`` latents x
        ``npix`` directions with a direction grid of batch ``d_batch``: None
        means they can. With ``grad`` (a latent or a decoder weight needs a
        gradient) the backward kernels must take the trunk too
        (``siren_bwd.bwd_unsupported_reason``: any depth on the layer-major
        passes, bf16 widths that are a multiple of 64 and float32 widths
        that are a multiple of 16, at any width). A mesh with a model axis
        declines the kernels (JAX's reason)."""
        cfg = self.config
        mesh = active_kernel_mesh()
        if mesh is not None and mesh.n_model > 1:
            return model_axis_reason(mesh)
        if d_batch not in (1, batch):
            return f"direction grid batch {d_batch} matches neither 1 nor Z batch {batch}"
        if not (cfg.is_film or cfg.last_layer_linear):
            return "last_layer_linear=False (the kernel's final layer is linear)"
        reason = unsupported_reason(npix, cfg.hidden_features, batch=batch, trunk=cfg.pallas_trunk)
        if reason is None and grad:
            n_mm = cfg.hidden_layers - 1 if cfg.is_film else cfg.hidden_layers
            reason = bwd_unsupported_reason(
                cfg.hidden_features, n_mm, cfg.is_film, cfg.pallas_trunk
            )
        return reason

    def fused_step_reason(self, batch: int, npix: int, d_batch: int = 1) -> str | None:
        """Why the train-step kernel (``kernels.siren_step.fused_step_mse``,
        for FiLM ``fused_film_step_mse``) cannot serve a FIT_DECODER step of
        ``batch`` images x ``npix`` directions, with a direction grid of
        batch ``d_batch``: None means it can. Every guard of ``apply`` holds
        here too (``last_layer_linear`` matters only for Cond-by-Concat:
        FiLM's final layer is always linear), then the step kernel's own
        limits. Under a kernel mesh ``batch`` and ``npix`` are the whole
        batch's: they must divide the data and pixel axes, and the kernel's
        limits hold at each rank's block."""
        cfg = self.config
        if not cfg.use_pallas:
            return "use_pallas off"
        if not cfg.is_film and not cfg.last_layer_linear:
            return "last_layer_linear=False (the kernel's final layer is linear)"
        if d_batch not in (1, batch):
            return f"direction grid batch {d_batch} matches neither 1 nor Z batch {batch}"
        return unsupported_reason(
            npix, cfg.hidden_features, batch=batch, trunk=cfg.pallas_trunk,
            mesh=active_kernel_mesh(),
        ) or step_unsupported_reason(
            cfg.hidden_features, cfg.hidden_layers, cfg.pallas_trunk, film=cfg.is_film
        )

    def fused_train_mse(self, params: Params, Z, D, targets, sineweight, bmask, pixels=None):
        """``losses.weighted_mse(self.apply(params, Z, D), targets, sineweight
        * bmask)`` through the train-step kernel (value and every gradient
        in one call). Callers must have checked ``fused_step_reason`` is
        None. On a mesh the tensors are this rank's block and ``pixels`` is
        the whole batch's pixel count (the partial losses sum to the loss).
        A span ``model.step`` (``utils/profiling.py``)."""
        with span("model.step", Z):
            return self._step_mse(params, Z, D, targets, sineweight, bmask, pixels)

    def _step_mse(self, params: Params, Z, D, targets, sineweight, bmask, pixels):
        cfg = self.config
        if cfg.is_film:
            return fused_film_step_mse(
                params["decoder"],
                cfg.equivariance,
                Z,
                D,
                targets,
                sineweight,
                bmask,
                hidden_layers=cfg.hidden_layers,
                hidden_features=cfg.hidden_features,
                out_features=cfg.out_features,
                output_activation=cfg.output_activation,
                trunk=cfg.pallas_trunk,
                fast_sine=cfg.fast_sine,
                pixels=pixels,
            )
        return fused_step_mse(
            params["decoder"],
            cfg.equivariance,
            cfg.latent_dim,
            Z,
            D,
            targets,
            sineweight,
            bmask,
            hidden_layers=cfg.hidden_layers,
            hidden_features=cfg.hidden_features,
            out_features=cfg.out_features,
            first_omega_0=cfg.first_omega_0,
            hidden_omega_0=cfg.hidden_omega_0,
            output_activation=cfg.output_activation,
            trunk=cfg.pallas_trunk,
            fast_sine=cfg.fast_sine,
            pixels=pixels,
        )

    def apply_concat(self, params: Params, Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """Reference-parity forward that builds the concat encoding (the
        tests hold the decomposed path against it); O(npix * N^2) memory."""
        cfg = self.config
        if D.shape[0] == 1 and Z.shape[0] != 1:
            D = D.expand(Z.shape[0], *D.shape[1:])
        if cfg.is_film:
            siren_in, mapping_in = encodings.film_inputs(cfg.equivariance, Z, D)
            return film.apply_film_concat(
                params["decoder"],
                siren_in,
                mapping_in,
                hidden_features=cfg.hidden_features,
                output_activation=cfg.output_activation,
            )
        x = encodings.invariant_representation(cfg.equivariance, Z, D)
        return siren.apply_siren_concat(
            params["decoder"],
            x,
            last_layer_linear=cfg.last_layer_linear,
            output_activation=cfg.output_activation,
            first_omega_0=cfg.first_omega_0,
            hidden_omega_0=cfg.hidden_omega_0,
        )

    def apply_idx(self, params: Params, idx, D, generator=None) -> torch.Tensor:
        """Decode dataset rows ``idx``. For a VAD with a trainable decoder a
        ``generator`` samples the latents; otherwise mu / Z are used."""
        cfg = self.config
        if cfg.is_variational and not cfg.fixed_decoder and generator is not None:
            Z, _, _ = self.sample_latent(params, idx, generator)
        else:
            Z = self.latents(params, idx)
        return self.apply(params, Z, D)

    def trainable_mask(self, params: Params) -> Params:
        """Tree of bools: which leaves the current task trains. Under
        ``fixed_decoder`` (FIT_LATENT) only mu (VAD) or Z (AD); otherwise all."""
        cfg = self.config
        mask = map_tree(lambda _: not cfg.fixed_decoder, params)
        if cfg.fixed_decoder:
            mask["latents"]["mu" if cfg.is_variational else "Z"] = True
        return mask


def build_model(config: RENIConfig) -> RENIModel:
    return RENIModel(config)


def draw_noise(shape, dtype: torch.dtype, device: torch.device,
               generator: torch.Generator | None) -> torch.Tensor:
    """N(0, 1) noise of ``shape`` drawn on the CPU from ``generator`` (the
    same numbers on any device). For the card it lands in pinned host memory
    and reaches the device by a copy that does not block the host (the
    caching host allocator keeps the buffer until the copy's stream is past
    it)."""
    noise = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
    return noise.normal_(generator=generator)


def reparameterise(mu: torch.Tensor, log_var: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Z = mu + noise * exp(log_var / 2), ``noise`` moved to mu's device."""
    std = torch.exp(0.5 * log_var)
    return mu + noise.to(std.device, std.dtype, non_blocking=True) * std


def _needs_grad(params: Params, Z: torch.Tensor) -> bool:
    """Whether autograd will ask this decode for a gradient."""
    if not torch.is_grad_enabled():
        return False
    return Z.requires_grad or any(
        torch.is_tensor(t) and t.requires_grad for t in tree_leaves(params)
    )


def replace_latents(
    model: RENIModel, params: Params, generator: torch.Generator, dataset_size: int,
    device=None,
) -> Params:
    """Fresh latent table of a new size with the same decoder (the
    cross-task partial restore)."""
    return {
        "decoder": params["decoder"],
        "latents": model.init_latents(generator, dataset_size, device=device),
    }
