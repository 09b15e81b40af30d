"""Rotation-invariant input encodings (counterpart of
``reni_tpu/core/encodings.py``).

Two forms:

1. **Concat form** (`so3_invariant` etc.): the exact ``(B, npix, in)``
   tensors the reference feeds its first layer (parity tests).
2. **Decomposed form** (`d_features`, `z_parts`): the first layer is linear
   in the concat, so it splits into a per-pixel part of width <= 4 and a
   per-image part folded into a bias; the ``(B, npix, 2N + N^2 + 2)``
   tensor is never built.

Canonical concat orderings (must match the weight-row splits in models/):

- SO3:   [innerprod (N), G_flat (N^2)]
- SO2:   [innerprod (N), G_flat (N^2), |D_xz| (1), Z_y (N), D_y (1)]
- None:  [innerprod (N), Z_flat (3N)]

FiLM siren-input orderings:

- SO3:   innerprod (N)                          mapping: G_flat (N^2)
- SO2:   [|D_xz| (1), D_y (1), innerprod (N)]   mapping: [G_flat, Z_y]
- None:  innerprod (N)                          mapping: Z_flat (3N)
"""

from __future__ import annotations

import torch

EQUIVARIANCES = ("SO3", "SO2", "None")


def concat_in_features(equivariance: str, ndims: int) -> int:
    """Width of the concatenated invariant encoding."""
    if equivariance == "SO3":
        return ndims + ndims * ndims
    if equivariance == "SO2":
        return 2 * ndims + ndims * ndims + 2
    if equivariance == "None":
        return ndims * 3 + ndims
    raise ValueError(f"unknown equivariance {equivariance!r}")


def film_in_features(equivariance: str, ndims: int) -> tuple[int, int]:
    """(siren_in, mapping_in) widths for FiLM conditioning; for "None" the
    consistent widths (N, 3N)."""
    if equivariance == "SO3":
        return ndims, ndims * ndims
    if equivariance == "SO2":
        return 2 + ndims, ndims * ndims + ndims
    if equivariance == "None":
        return ndims, ndims * 3
    raise ValueError(f"unknown equivariance {equivariance!r}")


def d_feature_width(equivariance: str) -> int:
    """Width of the decomposed per-pixel direction features."""
    return {"SO3": 3, "SO2": 4, "None": 3}[equivariance]


def _xz(x: torch.Tensor) -> torch.Tensor:
    return torch.stack((x[:, :, 0], x[:, :, 2]), -1)


def _gram(Z: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnc,bmc->bnm", Z, Z)


def _per_pixel(x: torch.Tensor, npix: int) -> torch.Tensor:
    """(B, m) per-image features repeated for every pixel: (B, npix, m)."""
    return x[:, None, :].expand(x.shape[0], npix, x.shape[1])


def so3_invariant(Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """SO(3)-invariant concat encoding, (B, npix, N + N^2)."""
    G = _gram(Z)
    innerprod = torch.einsum("bpc,bnc->bpn", D, Z)
    return torch.cat((innerprod, _per_pixel(G.reshape(G.shape[0], -1), D.shape[1])), 2)


def so2_invariant(Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """SO(2)-invariant concat encoding, (B, npix, 2N + N^2 + 2)."""
    Z_xz, D_xz = _xz(Z), _xz(D)
    G = _gram(Z_xz)
    npix = D.shape[1]
    innerprod = torch.einsum("bpc,bnc->bpn", D_xz, Z_xz)
    d_xz_norm = torch.sqrt(D[:, :, 0] ** 2 + D[:, :, 2] ** 2)[..., None]
    z_y = _per_pixel(Z[:, :, 1], npix)
    d_y = D[:, :, 1][..., None]
    return torch.cat(
        (innerprod, _per_pixel(G.reshape(G.shape[0], -1), npix), d_xz_norm, z_y, d_y),
        2,
    )


def no_invariance(Z: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Non-invariant concat encoding, (B, npix, N + 3N)."""
    innerprod = torch.einsum("bpc,bnc->bpn", D, Z)
    return torch.cat((innerprod, _per_pixel(Z.reshape(Z.shape[0], -1), D.shape[1])), 2)


def invariant_representation(equivariance: str, Z, D):
    """Concat encoding for ``equivariance``."""
    return {
        "SO3": so3_invariant,
        "SO2": so2_invariant,
        "None": no_invariance,
    }[equivariance](Z, D)


def film_inputs(
    equivariance: str, Z: torch.Tensor, D: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(siren_input (B, npix, s), mapping_input (B, m)); the mapping input
    is per image (the reference repeats it for every pixel)."""
    if equivariance == "SO3":
        siren_in = torch.einsum("bpc,bnc->bpn", D, Z)
        mapping_in = _gram(Z).reshape(Z.shape[0], -1)
    elif equivariance == "SO2":
        Z_xz, D_xz = _xz(Z), _xz(D)
        G = _gram(Z_xz)
        innerprod = torch.einsum("bpc,bnc->bpn", D_xz, Z_xz)
        d_xz_norm = torch.sqrt(D[:, :, 0] ** 2 + D[:, :, 2] ** 2)[..., None]
        d_y = D[:, :, 1][..., None]
        siren_in = torch.cat((d_xz_norm, d_y, innerprod), 2)
        mapping_in = torch.cat((G.reshape(G.shape[0], -1), Z[:, :, 1]), 1)
    elif equivariance == "None":
        siren_in = torch.einsum("bpc,bnc->bpn", D, Z)
        mapping_in = Z.reshape(Z.shape[0], -1)
    else:
        raise ValueError(f"unknown equivariance {equivariance!r}")
    return siren_in, mapping_in


def d_features(equivariance: str, D: torch.Tensor) -> torch.Tensor:
    """Per-pixel direction features for the decomposed first layer:
    SO3 / None: D itself (B, npix, 3); SO2: [D_x, D_z, |D_xz|, D_y]."""
    if equivariance in ("SO3", "None"):
        return D
    if equivariance == "SO2":
        d_xz_norm = torch.sqrt(D[:, :, 0] ** 2 + D[:, :, 2] ** 2)
        return torch.stack((D[:, :, 0], D[:, :, 2], d_xz_norm, D[:, :, 1]), -1)
    raise ValueError(f"unknown equivariance {equivariance!r}")


def z_parts(equivariance: str, Z: torch.Tensor) -> dict:
    """Per-image pieces of the invariant encoding:

    - 'proj': (B, c, N) with innerprod = D_proj @ proj, D_proj the first c
      columns of `d_features` (c=3 for SO3/None, c=2 for SO2);
    - 'bias_feats': (B, m) features entering only through a per-image bias
      (G_flat [+ Z_y] or Z_flat).
    """
    B = Z.shape[0]
    if equivariance == "SO3":
        return {"proj": Z.transpose(1, 2), "bias_feats": _gram(Z).reshape(B, -1)}
    if equivariance == "SO2":
        Z_xz = _xz(Z)
        bias_feats = torch.cat((_gram(Z_xz).reshape(B, -1), Z[:, :, 1]), 1)
        return {"proj": Z_xz.transpose(1, 2), "bias_feats": bias_feats}
    if equivariance == "None":
        return {"proj": Z.transpose(1, 2), "bias_feats": Z.reshape(B, -1)}
    raise ValueError(f"unknown equivariance {equivariance!r}")
