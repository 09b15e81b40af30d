"""Serving: a checkpoint's decoder as a callable ``f(Z, D)``, and the
decoder as a portable artifact.

Two ways to serve, as two entry points:

- ``load_decoder``: the model built from the checkpoint's config and decoder
  weights, decoding through the fused CUDA kernels (``use_pallas`` forced
  on; on the card a shape the kernels cannot take raises, on the CPU it
  takes the plain decoder with a one-time note on stderr). The fast path.
- ``export_decoder`` / ``save_exported`` / ``load_exported``: the port's
  counterpart of ``reni_tpu/serve.py``'s ``jax.export`` artifact. The plain
  decoder forward is traced once by ``torch.export`` with symbolic batch
  and pixel dimensions and saved as one ``.pt2`` file holding the graph and
  the decoder weights; a serving process loads it with torch alone (no
  model code) and decodes any (B, P). The CUDA kernels are opaque to
  ``torch.export`` (ctypes calls), as ``pallas_call`` is to ``jax.export``,
  so the artifact is the plain PyTorch path, not the kernels.

    f = load_decoder("data/Zoo/<entry>/checkpoint")   # on the card
    rgb = f(Z, directions)                             # (B, P, 3) tensor

    export_from_checkpoint("data/Zoo/<entry>/checkpoint", "decoder.pt2")
    f = load_exported("decoder.pt2")                   # torch only
    rgb = f(Z, directions)

An artifact traced on the CPU runs on the card after ``load_exported``
moves its weights there: the graph creates no tensor of its own, so it names
no device. Serialized artifacts are not promised to load across torch
versions: export with the torch that serves.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.params import from_numpy, map_tree, tree_leaves
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.utils.device import resolve_device

# the example shapes a trace sees: torch.export specialises a dimension
# whose example size is 0 or 1, so both are at least 2
_TRACE_BATCH, _TRACE_WIDTH = 2, 8


def _on_device(x, dev: torch.device) -> torch.Tensor:
    # a tensor already on the device (e.g. a stride-0 expanded grid) stays
    # the same view; host arrays (possibly read-only) are copied
    if not torch.is_tensor(x):
        x = torch.tensor(np.asarray(x, dtype=np.float32))
    return x.to(device=dev, dtype=torch.float32)


def load_decoder(checkpoint_path: str, device=None):
    """Checkpoint -> ``f(Z, D) -> (B, P, out)`` on ``device`` (default the
    card). Z (B, N, 3) and D (B or 1, P, 3) may be numpy arrays or tensors;
    the result is a float32 tensor on ``device``. ``f.config`` is the model
    config and ``f.latent_dim`` its N."""
    dev = resolve_device(device)
    params, _ = ckpt.load_checkpoint(checkpoint_path)
    cfg = ckpt.load_model_config(checkpoint_path, fixed_decoder=True)
    model = RENIModel(dataclasses.replace(cfg, use_pallas=True))
    decoder = {"decoder": from_numpy(params["decoder"], dev)}

    def call(Z, D) -> torch.Tensor:
        with torch.inference_mode():
            return model.apply(decoder, _on_device(Z, dev), _on_device(D, dev))

    call.config = cfg
    call.latent_dim = cfg.latent_dim
    call.device = dev
    return call


class PlainDecoder(torch.nn.Module):
    """``RENIModel.apply`` of the plain decoder (``use_pallas`` off: PyTorch
    operations, no kernel) as a module whose buffers are the decoder
    weights, so that ``.to(device)`` moves them: what ``torch.export``
    traces, here and in the trainer's graph dump (``cli/run.py``)."""

    def __init__(self, config: RENIConfig, decoder):
        super().__init__()
        self.model = RENIModel(dataclasses.replace(config, use_pallas=False))
        for i, leaf in enumerate(tree_leaves(decoder)):
            self.register_buffer(f"w{i}", leaf.detach().clone())
        count = itertools.count()
        self._layout = map_tree(lambda _: next(count), decoder)

    def forward(self, Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        decoder = map_tree(lambda i: getattr(self, f"w{i}"), self._layout)
        return self.model.apply({"decoder": decoder}, Z, D)


def export_decoder(model: RENIModel, params) -> torch.export.ExportedProgram:
    """Trace the plain decoder with symbolic B and P, on the device of the
    decoder weights in ``params``: Z is (B, N, 3) and D (B, P, 3), as JAX's
    ``export_decoder`` specs them. The artifact holds the decoder weights
    (latents are serving inputs); save it with ``save_exported``."""
    module = PlainDecoder(model.config, params["decoder"])
    dev = tree_leaves(params["decoder"])[0].device
    Z = torch.zeros(_TRACE_BATCH, model.config.latent_dim, 3, device=dev)
    D = sphere.get_directions(_TRACE_WIDTH, device=dev).expand(_TRACE_BATCH, -1, -1)
    b, p = torch.export.Dim("b", min=1), torch.export.Dim("p", min=1)
    with torch.no_grad():
        return torch.export.export(module, (Z, D.contiguous()),
                                   dynamic_shapes=({0: b}, {0: b, 1: p}))


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """``torch.export.save``: kept so that the port's serving API has the
    JAX package's four names (``reni_tpu.serve``: export_decoder,
    save_exported, load_exported, export_from_checkpoint)."""
    torch.export.save(exported, path)


def load_exported(path: str, device=None):
    """An artifact -> ``f(Z, D) -> (B, P, out)`` on ``device`` (default the
    card), its weights moved there. Needs only torch: the decoder's code is
    in the artifact. ``f.latent_dim`` is its N, ``f.exported`` the loaded
    ``ExportedProgram``."""
    dev = resolve_device(device)
    exported = torch.export.load(path)
    module = exported.module().to(dev)

    def call(Z, D) -> torch.Tensor:
        with torch.inference_mode():
            return module(_on_device(Z, dev), _on_device(D, dev))

    # N from the input signature ((b, N, 3), only b symbolic): what a
    # daemon's warm-up decodes with
    z_name = exported.graph_signature.user_inputs[0]
    z = next(n for n in exported.graph.nodes if n.op == "placeholder" and n.name == z_name)
    call.exported = exported
    call.latent_dim = int(z.meta["val"].shape[1])
    call.device = dev
    return call


def export_from_checkpoint(checkpoint_path: str, out_path: str, device=None) -> RENIConfig:
    """Checkpoint file -> serving artifact traced on ``device`` (default the
    card); returns the model config."""
    params, _ = ckpt.load_checkpoint(checkpoint_path)
    cfg = ckpt.load_model_config(checkpoint_path, fixed_decoder=True)
    decoder = from_numpy(params["decoder"], resolve_device(device))
    save_exported(export_decoder(RENIModel(cfg), {"decoder": decoder}), out_path)
    return cfg
