"""The render's light-transport product (``render/shading.py``:
``transport_matrix`` and ``make_render_fn``'s kept T) held against the
chunked ``blinn_phong_env_shading`` on the CPU: forward (float32 to 1e-6,
float64 to 1e-12 of sum |chunked| in sum |diff|) and the gradient into the
env maps, a slice of rows, two stacked views, a T never stale across light
sets, the fallback over the memory budget, and the spans that tell the two
paths apart."""

import os

import numpy as np
import pytest
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.render import inverse
from reni_tpu_torch.render import mesh as mesh_lib
from reni_tpu_torch.render import shading
from reni_tpu_torch.render.rasterizer import rasterize_world
from reni_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
RES = 32
KD = 0.5
BARS = {torch.float32: 1e-6, torch.float64: 1e-12}


def _teapot():
    return mesh_lib.load_obj(os.path.join(ROOT, "data", "3D_Models", "teapot.obj"))


def _scene(res=RES):
    """(render closure, the chunked shading of the same scene)."""
    m = _teapot()
    frags, eye = rasterize_world(m, res)
    fn = mesh_lib.vertex_normals(m)[m.faces]
    render = shading.make_render_fn(frags, m.face_verts, fn, eye, kd=KD, device="cpu")
    pos, nrm = shading.pixel_geometry(frags, m.face_verts, fn, "cpu")
    cam = torch.tensor(np.asarray(eye, np.float32))

    def chunked(envmaps, sineweight, dirs, rows=slice(None), chunk=None):
        return shading.blinn_phong_env_shading(
            nrm[rows], pos[rows], cam, dirs, envmaps * sineweight, kd=KD, ks=1.0 - KD,
            chunk=chunk)

    return render, chunked


def _maps(width, dtype, b=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    env = torch.rand((b, width * width // 2, 3), generator=gen, dtype=dtype) * 2.0
    sw = sphere.get_sineweight(width, device="cpu").to(dtype).expand(env.shape)
    return env, sw, sphere.get_directions(width, device="cpu")[0]


def _rel(got, ref) -> float:
    return float((got - ref).abs().sum() / ref.abs().sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_product_matches_the_chunked_shading(dtype):
    """The render and the gradient into the maps of sum(render * w), product
    against chunked (in chunks of 100 lights, under checkpoint)."""
    render, chunked = _scene()
    env, sw, dirs = _maps(32, dtype)
    w = torch.randn((3, RES, RES, 3), generator=torch.Generator().manual_seed(1), dtype=dtype)
    outs, grads = [], []
    for fn, kw in ((render, {}), (chunked, {"chunk": 100})):
        e = env.clone().requires_grad_(True)
        out = fn(e, sw, dirs, **kw)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append(e.grad)
    assert outs[0].dtype == dtype and outs[0].shape == (3, RES, RES, 3)
    assert outs[0].is_contiguous()
    assert _rel(outs[0], outs[1]) <= BARS[dtype]
    assert _rel(grads[0], grads[1]) <= BARS[dtype]


def test_transport_matrix_is_the_shading_of_unit_lights():
    """T's column j is the float64 render of light j alone at unit color;
    background rows are exact zeros."""
    m = _teapot()
    frags, eye = rasterize_world(m, 16)
    fn = mesh_lib.vertex_normals(m)[m.faces]
    pos, nrm = shading.pixel_geometry(frags, m.face_verts, fn, "cpu")
    cam = torch.tensor(np.asarray(eye, np.float32))
    dirs = sphere.get_directions(16, device="cpu")[0]
    t = shading.transport_matrix(nrm, pos, cam, dirs, kd=KD, ks=1.0 - KD,
                                 dtype=torch.float64, chunk=24)
    assert t.shape == (16 * 16, dirs.shape[0]) and t.dtype == torch.float64
    unit = torch.eye(dirs.shape[0], dtype=torch.float64)[:, :, None].expand(-1, -1, 3)
    cols = shading.blinn_phong_env_shading(nrm, pos, cam, dirs, unit, kd=KD, ks=1.0 - KD)
    torch.testing.assert_close(t, cols[..., 0].reshape(dirs.shape[0], -1).T,
                               rtol=1e-12, atol=1e-12 * float(t.abs().max()))
    background = torch.as_tensor(frags.pix_to_face < 0).reshape(-1)
    assert background.any() and torch.equal(t[background], torch.zeros_like(t[background]))


def test_rows_slice_is_those_rows_of_the_render():
    """A mesh rank's rows: those rows of the whole render (T's rows a view;
    the product's other row count may sum in another order), and within
    the bar of the chunked shading of those rows."""
    render, chunked = _scene()
    env, sw, dirs = _maps(32, torch.float64)
    whole = render(env, sw, dirs)
    for rows in (slice(0, 11), slice(11, 32), slice(5, 6)):
        part = render(env, sw, dirs, rows)
        torch.testing.assert_close(part, whole[:, rows], rtol=1e-14, atol=0)
        assert _rel(part, chunked(env, sw, dirs, rows)) <= 1e-12


def test_two_views_through_the_product():
    """Two stacked views of an InverseRenderSetup: each view's rows equal a
    one-view setup at that camera, and a rows slice across the seam is
    those rows; each within the float64 bar of the chunked shading."""
    views = dict(azimuths=(0.0, 120.0), elevations=(0.0, 30.0))
    two = inverse.InverseRenderSetup(_teapot(), render_resolution=16, kd=KD, device="cpu",
                                     **views)
    second = inverse.InverseRenderSetup(_teapot(), render_resolution=16, kd=KD, device="cpu",
                                        azimuths=(120.0,), elevations=(30.0,))
    env, sw, _ = _maps(16, torch.float64, b=2)
    r = two.render_fn(16)
    full = r(env, sw)
    assert full.shape == (2, 32, 16, 3)
    assert torch.equal(full[:, 16:], second.render_fn(16)(env, sw))
    torch.testing.assert_close(r(env, sw, rows=slice(10, 22)), full[:, 10:22], rtol=1e-14,
                               atol=0)
    m = _teapot()
    fn = mesh_lib.vertex_normals(m)[m.faces]
    dirs = sphere.get_directions(16, device="cpu")[0]
    for v, (azim, elev) in enumerate(zip(views["azimuths"], views["elevations"])):
        frags, eye = rasterize_world(m, 16, elev=elev, azim=azim)
        pos, nrm = shading.pixel_geometry(frags, m.face_verts, fn, "cpu")
        ref = shading.blinn_phong_env_shading(nrm, pos, torch.tensor(eye), dirs, env * sw,
                                              kd=KD, ks=1.0 - KD)
        assert _rel(full[:, 16 * v:16 * (v + 1)], ref) <= 1e-12


def test_alternating_light_sets_never_use_a_stale_matrix():
    """Two widths, two dtypes and rotated directions of one size, taken in
    turn through one closure: each render equals a fresh closure's."""
    render, _ = _scene(16)
    env, sw, dirs = _maps(16, torch.float32, b=2)
    cases = [(env, sw, dirs), (env, sw, dirs[:, [1, 0, 2]] * torch.tensor([-1.0, 1.0, 1.0])),
             _maps(16, torch.float64, b=2), _maps(8, torch.float32, b=2)]
    for env, sw, dirs in (cases[i] for i in (0, 1, 0, 2, 0, 3, 2, 1, 3, 0)):
        fresh, _ = _scene(16)
        assert torch.equal(render(env, sw, dirs), fresh(env, sw, dirs))


def test_a_new_tensor_of_the_same_directions_keeps_the_matrix(monkeypatch):
    """The same light set in a new tensor (each ``render_fn(width)`` makes
    one) builds T once."""
    render, _ = _scene(16)
    builds = []
    build = shading.transport_matrix
    monkeypatch.setattr(shading, "transport_matrix", lambda *a, **k: builds.append(1) or
                        build(*a, **k))
    env, sw, dirs = _maps(16, torch.float32, b=2)
    first = render(env, sw, dirs)
    for _ in range(2):
        assert torch.equal(render(env, sw, sphere.get_directions(16, device="cpu")[0]), first)
    assert len(builds) == 1
    render(*_maps(8, torch.float32, b=2))
    assert len(builds) == 2


def test_over_the_budget_the_render_takes_the_chunked_path(monkeypatch):
    """With the budget below T's bytes the closure builds no T and renders
    bitwise as the chunked shading does, forward and
    gradient; back under the budget, it takes the product again."""
    render, chunked = _scene(16)
    env, sw, dirs = _maps(16, torch.float32, b=2)
    builds = []
    build = shading.transport_matrix
    monkeypatch.setattr(shading, "transport_matrix", lambda *a, **k: builds.append(1) or
                        build(*a, **k))
    monkeypatch.setattr(shading, "LIGHT_BUDGET_BYTES", 16 * 16 * 128 * 4 - 1)
    grads = []
    for fn in (render, chunked):
        e = env.clone().requires_grad_(True)
        out = fn(e, sw, dirs)
        out.square().sum().backward()
        grads.append((out.detach(), e.grad))
    assert not builds
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    monkeypatch.setattr(shading, "LIGHT_BUDGET_BYTES", 16 * 16 * 128 * 4)
    assert _rel(render(env, sw, dirs), grads[1][0]) <= 1e-6 and len(builds) == 1


def test_spans_count_each_path(monkeypatch):
    """Inside a profiler session each render opens one span under
    ``render.forward``: ``render.transport`` on the product, and
    ``render.chunked`` over the budget."""
    setup = inverse.InverseRenderSetup(_teapot(), render_resolution=16, kd=KD, device="cpu")
    render = setup.render_fn(16)
    env, sw, _ = _maps(16, torch.float32, b=2)
    profiling.snapshot()  # ends any session an earlier test left
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            render(env, sw)
        monkeypatch.setattr(shading, "LIGHT_BUDGET_BYTES", 1 << 10)
        render(env, sw)
    spans = profiling.snapshot()["spans"]
    names = [s["name"] for s in spans]
    assert names.count("render.forward") == 4
    assert names.count("render.transport") == 3 and names.count("render.chunked") == 1
    for s in spans:
        if s["name"] in ("render.transport", "render.chunked"):
            assert spans[s["parent"]]["name"] == "render.forward"
