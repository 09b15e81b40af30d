"""The port's core modules (reni_tpu_torch.core) held against the JAX
package on the CPU: fast sine/cosine, sphere grids, invariant encodings.

Inputs come from numpy with a fixed seed and go through both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.core import encodings as jenc
from reni_tpu.core import fastmath as jfm
from reni_tpu.core import sphere as jsph
from reni_tpu_torch.core import encodings as tenc
from reni_tpu_torch.core import fastmath as tfm
from reni_tpu_torch.core import sphere as tsph


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- fastmath -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["fast_sin", "fast_cos", "fast_sincos"])
def test_fastmath_matches_jax(name):
    rng = np.random.default_rng(0)
    x = np.concatenate(
        [
            rng.uniform(-1e3, 1e3, 20000),
            rng.uniform(-200, 200, 20000),
            # multiples of pi/2: the reduction's rounding boundaries
            np.arange(-600, 601) * (np.pi / 2),
        ]
    ).astype(np.float32)
    ref = getattr(jfm, name)(jnp.asarray(x))
    out = getattr(tfm, name)(torch.from_numpy(x))
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(refs, outs):
        np.testing.assert_allclose(_np(o), _np(r), atol=1e-6)


@pytest.mark.parametrize("fast", [False, True])
def test_sine_fns_selectors(fast):
    x = torch.linspace(-50, 50, 1001)
    sin, cos = tfm.sine_fns(fast)
    s, c = tfm.sincos_fns(fast)(x)
    np.testing.assert_array_equal(_np(sin(x)), _np(s))
    np.testing.assert_array_equal(_np(cos(x)), _np(c))
    np.testing.assert_allclose(_np(s), np.sin(_np(x).astype(np.float64)), atol=4e-6)


# -- sphere -------------------------------------------------------------------


@pytest.mark.parametrize("width", [8, 32, 64])
@pytest.mark.parametrize("fn", ["get_directions", "get_sineweight", "get_solid_angles"])
def test_sphere_grids_match_jax(fn, width):
    ref = _np(getattr(jsph, fn)(width))
    out = getattr(tsph, fn)(width, device="cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), ref, atol=1e-7)


def test_rotation_y_matches_jax():
    for angle in (0.0, 0.3, -1.2, np.pi / 2, 3.0):
        np.testing.assert_allclose(tsph.rotation_y(angle), jsph.rotation_y(angle), atol=1e-7)


def test_flatten_unflatten_and_srgb_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.lognormal(size=(2, 3, 8, 16)).astype(np.float32)
    flat = tsph.flatten_image(torch.from_numpy(imgs))
    np.testing.assert_array_equal(_np(flat), _np(jsph.flatten_image(jnp.asarray(imgs))))
    np.testing.assert_array_equal(_np(tsph.unflatten_image(flat, 8, 16)), imgs)
    np.testing.assert_allclose(
        _np(tsph.srgb(torch.from_numpy(imgs))), _np(jsph.srgb(jnp.asarray(imgs))),
        atol=1e-6,
    )


def test_sphere_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsph.get_directions(8)


# -- encodings ----------------------------------------------------------------


def _zd(seed=2, B=2, N=5, P=24):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(B, N, 3)).astype(np.float32)
    D = rng.normal(size=(B, P, 3)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    return Z, D


EQUIVS = ["SO3", "SO2", "None"]


@pytest.mark.parametrize("equiv", EQUIVS)
def test_concat_encodings_match_jax(equiv):
    Z, D = _zd()
    ref = jenc.invariant_representation(equiv, jnp.asarray(Z), jnp.asarray(D))
    out = tenc.invariant_representation(equiv, torch.from_numpy(Z), torch.from_numpy(D))
    assert out.shape[-1] == tenc.concat_in_features(equiv, Z.shape[1])
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)


@pytest.mark.parametrize("equiv", EQUIVS)
def test_film_inputs_match_jax(equiv):
    Z, D = _zd(3)
    rs, rm = jenc.film_inputs(equiv, jnp.asarray(Z), jnp.asarray(D))
    ts, tm = tenc.film_inputs(equiv, torch.from_numpy(Z), torch.from_numpy(D))
    assert (ts.shape[-1], tm.shape[-1]) == tenc.film_in_features(equiv, Z.shape[1])
    np.testing.assert_allclose(_np(ts), _np(rs), atol=1e-6)
    np.testing.assert_allclose(_np(tm), _np(rm), atol=1e-6)


@pytest.mark.parametrize("equiv", EQUIVS)
def test_decomposed_encodings_match_jax(equiv):
    Z, D = _zd(4)
    rd = jenc.d_features(equiv, jnp.asarray(D))
    td = tenc.d_features(equiv, torch.from_numpy(D))
    assert td.shape[-1] == tenc.d_feature_width(equiv)
    np.testing.assert_allclose(_np(td), _np(rd), atol=1e-6)
    rp = jenc.z_parts(equiv, jnp.asarray(Z))
    tp = tenc.z_parts(equiv, torch.from_numpy(Z))
    for k in ("proj", "bias_feats"):
        np.testing.assert_allclose(_np(tp[k]), _np(rp[k]), atol=1e-6)


def test_unknown_equivariance_raises():
    Z, D = _zd()
    with pytest.raises(ValueError):
        tenc.z_parts("SO4", torch.from_numpy(Z))
    with pytest.raises(ValueError):
        tenc.concat_in_features("SO4", 3)
