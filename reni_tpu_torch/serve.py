"""Serving: a checkpoint's decoder as a callable ``f(Z, D)``.

The port's counterpart of ``reni_tpu.serve.load_exported``: where the JAX
package serves an exported artifact, the port builds the model from the
checkpoint's config and decoder weights and decodes through the fused
CUDA kernels (``use_pallas`` forced on; on the card a shape the kernels
cannot take raises, on the CPU it takes the plain decoder with a one-time
note on stderr).

    f = load_decoder("data/Zoo/<entry>/checkpoint")   # on the card
    rgb = f(Z, directions)                             # (B, P, 3) tensor
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.params import from_numpy
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.utils.device import resolve_device


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

    def _on_device(x) -> torch.Tensor:
        # a tensor already on the device (e.g. a stride-0 expanded grid)
        # stays the same view; host arrays (possibly read-only) are copied
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        return x.to(device=dev, dtype=torch.float32)

    def call(Z, D) -> torch.Tensor:
        with torch.inference_mode():
            return model.apply(decoder, _on_device(Z), _on_device(D))

    call.config = cfg
    call.latent_dim = cfg.latent_dim
    call.device = dev
    return call
