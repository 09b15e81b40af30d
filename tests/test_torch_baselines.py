"""The port's analytic baselines (reni_tpu_torch.baselines) on the CPU: each
case of tests/test_baselines.py on the port's functions, and the port held
to the JAX package's (reni_tpu/baselines): the SH basis, projection and
reconstruction at float64 within 1e-12 (JAX's host path builds its basis
with scipy's lpmv, the port from the Legendre recurrences), and the SG fit's
first 20 Adam steps at float64 within 1e-10 relative of JAX's ``_fit``
(optax's Adam under lax.scan against torch's in a loop)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.baselines import spherical_gaussians as jsg
from reni_tpu.baselines import spherical_harmonics as jsh
from reni_tpu_torch.baselines import spherical_gaussians as sg
from reni_tpu_torch.baselines import spherical_harmonics as sh
from reni_tpu_torch.core import sphere

F64_BAR = 1e-12


def _dirs(width):
    return sphere.get_directions(width, device="cpu")[0].numpy()


# ---------------------------------------------------------------------------
# tests/test_baselines.py's cases on the port
# ---------------------------------------------------------------------------


def test_num_coeffs_and_order_budget():
    assert sh.num_coeffs(0) == 1
    assert sh.num_coeffs(2) == 9
    assert sh.sh_order_from_budget(9) == 2
    assert sh.sh_order_from_budget(8) == 1
    assert sh.sh_order_from_budget(49) == 6


def test_sh_orthonormality():
    """int Y_i Y_j dOmega = delta_ij under exact solid-angle quadrature."""
    width = 128
    omega = sphere.get_solid_angles(width, device="cpu").numpy()
    basis = sh.sh_basis(3, _dirs(width))
    gram = basis.T @ (basis * omega[:, None])
    np.testing.assert_allclose(gram, np.eye(16), atol=2e-3)


def test_sh_bandlimited_roundtrip_exact():
    rng = np.random.default_rng(0)
    lmax = 3
    coeffs = rng.normal(size=(sh.num_coeffs(lmax), 3))
    img = sh.reconstruct(coeffs, 128)
    np.testing.assert_allclose(sh.project_environment(img, lmax), coeffs, atol=5e-3)
    np.testing.assert_allclose(sh.sh_representation(img, lmax), img, atol=5e-3)


def test_sh_basis_torch_float32_matches_host():
    """The differentiable basis in float32 against the float64 host basis,
    across orders, Condon-Shortley signs included."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for lmax in (0, 1, 3, 6):
        dev = sh.sh_basis_torch(lmax, torch.tensor(d, dtype=torch.float32))
        assert dev.dtype == torch.float32
        np.testing.assert_allclose(dev.numpy(), sh.sh_basis(lmax, d), atol=2e-4)


def test_sh_torch_projection_differentiable():
    """Gradients flow through project / reconstruct: the SH-space MSE of a
    band-limited signal has (near) zero gradient at the signal."""
    width = 32
    rng = np.random.default_rng(1)
    coeffs_true = torch.tensor(rng.normal(size=(9, 3)), dtype=torch.float32)
    img_true = sh.reconstruct_torch(coeffs_true, width)

    def loss_and_grad(img):
        img = img.detach().requires_grad_(True)
        loss = ((sh.project_environment_torch(img, 2) - coeffs_true) ** 2).sum()
        loss.backward()
        return float(loss.detach()), img.grad

    l0, g = loss_and_grad(img_true)
    assert l0 < 1e-3
    assert float(g.abs().max()) < 1e-2
    assert float(loss_and_grad(img_true + 0.5)[1].abs().max()) > 1e-4
    host = sh.project_environment(img_true.numpy().astype(np.float64), 2)
    dev = sh.project_environment_torch(img_true, 2).numpy()
    np.testing.assert_allclose(dev, host, atol=1e-4)


def test_sh_projection_dc_term():
    img = np.ones((32, 64, 3), dtype=np.float64) * 2.5
    coeffs = sh.project_environment(img, 2)
    np.testing.assert_allclose(coeffs[0], 2.5 * np.sqrt(4 * np.pi), rtol=1e-4)
    np.testing.assert_allclose(coeffs[1:], 0.0, atol=1e-2)


def test_diffuse_convolution_preserves_constant():
    np.testing.assert_allclose(sh.irradiance_map(np.ones((32, 64, 3)) * 3.0), 3.0, rtol=1e-3)


def test_windowing_shrinks_high_bands_only():
    coeffs = np.random.default_rng(1).normal(size=(16, 3))
    w = sh.window_sloan(coeffs, window_l=3)
    np.testing.assert_array_equal(w[:1], coeffs[:1])
    assert np.abs(w[9:]).sum() < np.abs(coeffs[9:]).sum()


def test_sg_render_single_lobe_peak():
    params = sg.SGParams(
        raw_axis=torch.tensor(np.arctanh(np.array([[0.0, 0.99, 0.0]], dtype=np.float32))),
        log_sharpness=torch.tensor([np.log(50.0)], dtype=torch.float32),
        log_amplitude=torch.zeros((1, 3)),
    )
    out = sg.render_sg(params, torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])).numpy()
    np.testing.assert_allclose(out[0], 1.0, rtol=1e-5)
    assert out[1].max() < 1e-8


def _sg_target(width):
    gt = sg.init_lobes(4, device="cpu")
    gt = gt._replace(log_amplitude=gt.log_amplitude
                     + torch.log(torch.tensor([2.0, 1.0, 0.5])))
    dirs = sphere.get_directions(width, device="cpu")[0]
    return sg.render_sg(gt, dirs).numpy().reshape(width // 2, width, 3)


def test_sg_fit_recovers_smooth_envmap():
    """Fitting 12 lobes to an SG-generated map drives the log-MSE low."""
    target = _sg_target(32)
    params, losses = sg.fit_environment(target, n_lobes=12, steps=800, lr=5e-2, device="cpu")
    assert losses[-1] < losses[0] / 20.0, (losses[0], losses[-1])
    recon = sg.sg_representation(target, n_lobes=12, steps=800, device="cpu")
    rel = np.abs(recon - target).mean() / target.mean()
    assert rel < 0.2, rel


def test_sg_fit_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sg.fit_environment(np.ones((8, 16, 3), np.float32), steps=1)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lmax", [0, 2, 6, 10])
def test_sh_basis_matches_jax_scipy_basis(lmax):
    rng = np.random.default_rng(lmax)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.concatenate([d, _dirs(16)])  # and the grid's poles-near rows
    np.testing.assert_allclose(sh.sh_basis(lmax, d), jsh.sh_basis(lmax, d), rtol=0, atol=F64_BAR)


@pytest.mark.parametrize("lmax", [2, 6])
def test_sh_projection_and_reconstruction_match_jax(lmax):
    """float64 maps and float32 ones (the product with the float32 solid
    angles then rounds in float32 on both sides)."""
    rng = np.random.default_rng(10 + lmax)
    for dtype in (np.float64, np.float32):
        img = np.exp(rng.normal(size=(32, 64, 3))).astype(dtype)
        ours, ref = sh.project_environment(img, lmax), jsh.project_environment(img, lmax)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=F64_BAR * np.abs(ref).max())
        np.testing.assert_allclose(sh.reconstruct(ref, 48), jsh.reconstruct(ref, 48),
                                   rtol=0, atol=F64_BAR * np.abs(ref).sum())
    np.testing.assert_array_equal(sh.window_sloan(ref, 4), jsh.window_sloan(ref, 4))
    np.testing.assert_array_equal(sh.diffuse_convolution(ref), jsh.diffuse_convolution(ref))
    np.testing.assert_allclose(sh.irradiance_map(img.astype(np.float64)),
                               jsh.irradiance_map(img.astype(np.float64)), rtol=0,
                               atol=F64_BAR * img.max())


def test_sh_torch_float64_path_matches_jax_host():
    """The device path in float64 (what chip_smoke.py runs on the card)
    against the JAX package's float64 host path."""
    img = np.exp(np.random.default_rng(3).normal(size=(32, 64, 3)))
    coeffs = sh.project_environment_torch(torch.tensor(img), 6)
    assert coeffs.dtype == torch.float64
    ref = jsh.project_environment(img, 6)
    np.testing.assert_allclose(coeffs.numpy(), ref, rtol=0, atol=F64_BAR * np.abs(ref).max())
    np.testing.assert_allclose(sh.reconstruct_torch(coeffs, 64).numpy(), jsh.reconstruct(ref, 64),
                               rtol=0, atol=F64_BAR * np.abs(ref).sum())


def test_sg_fit_first_steps_match_jax_float64():
    """20 Adam steps from the same lobes towards the same float64 map: every
    loss and the fitted parameters within 1e-10 relative of JAX's ``_fit``."""
    width, steps, lr = 32, 20, 5e-2
    target = _sg_target(width).astype(np.float64) * np.exp(
        0.3 * np.random.default_rng(4).normal(size=(width // 2, width, 3)))
    dirs = _dirs(width).astype(np.float64)
    sw = sphere.get_sineweight(width, device="cpu")[0].numpy().astype(np.float64)
    target_log = np.log(np.maximum(target.reshape(-1, 3), 1e-8))
    init = [np.asarray(t, np.float64) for t in sg.init_lobes(12, device="cpu")]
    init[2] = init[2] + np.random.default_rng(5).normal(scale=0.1, size=init[2].shape)

    params, losses = sg._fit(sg.SGParams(*(torch.tensor(a) for a in init)),
                             torch.tensor(target_log), torch.tensor(dirs), torch.tensor(sw),
                             steps, lr)
    with jax.enable_x64():
        jparams, jlosses = jsg._fit(jsg.SGParams(*(jnp.asarray(a) for a in init)),
                                    jnp.asarray(target_log), jnp.asarray(dirs), jnp.asarray(sw),
                                    steps, lr)
        jparams, jlosses = jax.device_get((jparams, jlosses))
    assert losses.dtype == torch.float64 and np.asarray(jlosses).dtype == np.float64
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-10, atol=0)
    assert losses[-1] < losses[0]
    for ours, ref in zip(params, jparams):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    assert not math.isnan(float(losses[-1]))
