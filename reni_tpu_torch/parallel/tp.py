"""The sharded plain decoder of the tensor-parallel ``model`` axis.

JAX gets these collectives from GSPMD and the parameter shardings of
``reni_tpu/parallel/mesh.py::_tp_spec``; here they are written out as
Megatron's two operators, both ``torch.autograd.Function``s over the
mesh's 'model' group (``parallel.mesh._AllReduce``):

- ``copy``: the identity in the forward, the cotangent summed over 'model'
  in the backward. It is applied to each tensor that is the same on every
  model rank and enters a column-parallel product: ``proj`` and
  ``bias_feats`` of ``encodings.z_parts``, the FiLM frequencies and phases
  that modulate column-parallel layers, and the activations of a
  row-parallel layer that enter the next column-parallel one;
- ``reduce``: the sum over 'model' in the forward, the identity in the
  backward, applied to each row-parallel layer's partial product (its bias
  is added after it).

Only these two cross the model axis. Every replicated leaf (a row-parallel
layer's bias, an unsharded final layer, the FiLM mapping network, the
latents) then has the same gradient on every model rank, computed
redundantly there, and a model-sharded leaf the gradient of its slice: the
step's one ``dp`` bucket (``ShardView.reduce``) completes both. Summing the
replicated gradients over 'model' as well would count the redundant terms
(the row-parallel sine, the final layer, the loss) ``n_model`` times; leaving
out ``copy`` would drop the cross-column terms of d loss / d Z and of the
mapping network.

Each sine is recomputed in the backward (``torch.utils.checkpoint`` around
it alone, no collective inside): autograd would otherwise keep the fast
sine's polynomial terms, about eight activations' worth a layer, which XLA's
fused elementwise code never stores. The recomputation repeats the same
operations on the same input, so the bits are those of the stored terms.

The parameters are this rank's slices (``parallel.mesh.shard_model_leaves``):
an even trunk layer holds its columns of ``w`` and ``b``, an odd one its rows
of ``w`` and the whole ``b``; ``final.w`` its rows when the last trunk layer
is even. Layer 0 is column-parallel: ``siren.split_first_layer`` splits rows,
so its column slice splits into the rank's columns of ``w_ip``, ``w_bias``
and ``w_direct``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from reni_tpu_torch.core import encodings
from reni_tpu_torch.core.fastmath import sine_fns
from reni_tpu_torch.models import film, siren
from reni_tpu_torch.parallel.mesh import Mesh, _AllReduce


def copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; the cotangent summed over 'model'."""
    return _AllReduce.apply(x, None, mesh.group("model"))


def reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over 'model' forward; the cotangent passed through."""
    return _AllReduce.apply(x, mesh.group("model"), None)


def _recomputed(sine):
    """``sine`` whose backward recomputes it from its input alone."""
    def fn(x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(sine, x, use_reentrant=False)
        return sine(x)

    return fn


def _d_feats(equivariance: str, D: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    d_feats = encodings.d_features(equivariance, D)
    return d_feats if d_feats.dtype == Z.dtype else d_feats.to(Z.dtype)


def _final(params, h: torch.Tensor, sharded: bool, mesh: Mesh) -> torch.Tensor:
    out = h @ params["final"]["w"]
    if sharded:  # row-parallel: its rows of final.w against the sharded activations
        out = reduce(out, mesh)
    return out + params["final"]["b"]


def apply_siren(params, cfg, Z: torch.Tensor, D: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``siren.apply_siren_decomposed`` on this rank's slices of the
    Cond-by-Concat decoder (``cfg`` a ``RENIConfig``); every model rank
    returns the whole (B, npix, out)."""
    sine = _recomputed(sine_fns(cfg.fast_sine)[0])
    d_feats = _d_feats(cfg.equivariance, D, Z)
    parts = {k: copy(v, mesh) for k, v in encodings.z_parts(cfg.equivariance, Z).items()}
    layers = params["layers"]
    pre = siren.first_layer_pre(layers[0], cfg.equivariance, cfg.latent_dim, d_feats, parts)
    h = sine(cfg.first_omega_0 * pre)
    sharded = True
    for i, layer in enumerate(layers[1:], start=1):
        if i % 2:  # row-parallel
            h = sine(cfg.hidden_omega_0 * (reduce(h @ layer["w"], mesh) + layer["b"]))
            sharded = False
        else:  # column-parallel
            h = sine(cfg.hidden_omega_0 * (copy(h, mesh) @ layer["w"] + layer["b"]))
            sharded = True
    out = _final(params, h, sharded, mesh)
    if not cfg.last_layer_linear:
        out = sine(cfg.hidden_omega_0 * out)
    return siren._output_activation(out, cfg.output_activation)


def apply_film(params, cfg, Z: torch.Tensor, D: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``film.apply_film_decomposed`` on this rank's slices of the FiLM
    decoder: the mapping network runs whole on every model rank; a
    column-parallel layer takes the frequencies and phases of its own
    columns (through ``copy``), a row-parallel one the whole (B, h) block."""
    sine = _recomputed(sine_fns(cfg.fast_sine)[0])
    H = cfg.hidden_features
    parts = encodings.z_parts(cfg.equivariance, Z)
    freqs, phases = film.apply_mapping_network(params["mapping"], parts["bias_feats"])
    freqs = freqs * 15.0 + 30.0
    freqs_c, phases_c = copy(torch.stack((freqs, phases)), mesh).unbind(0)
    d_feats = _d_feats(cfg.equivariance, D, Z)
    cols = mesh.cols(H)
    h, sharded = None, False
    for i, layer in enumerate(params["layers"]):
        lo = i * H
        if i % 2:  # row-parallel
            pre = reduce(h @ layer["w"], mesh) + layer["b"]
            f, p = freqs[:, None, lo:lo + H], phases[:, None, lo:lo + H]
        else:  # column-parallel
            if i == 0:
                pre = film._first_film_pre(layer, cfg.equivariance, d_feats,
                                           copy(parts["proj"], mesh))
            else:
                pre = copy(h, mesh) @ layer["w"] + layer["b"]
            c = slice(lo + cols.start, lo + cols.stop)
            f, p = freqs_c[:, None, c], phases_c[:, None, c]
        h = sine(f * pre + p)
        sharded = i % 2 == 0
    out = _final(params, h, sharded, mesh)
    return siren._output_activation(out, cfg.output_activation)


def apply(params, cfg, Z: torch.Tensor, D: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The decoder of ``cfg``'s conditioning on this rank's slices."""
    fn = apply_film if cfg.is_film else apply_siren
    return fn(params["decoder"], cfg, Z, D, mesh)
