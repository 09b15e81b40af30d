"""The port's renderer (reni_tpu_torch.render: mesh, the C++ rasterizer and
its numpy oracle, Blinn-Phong shading, InverseRenderSetup) held against the
JAX package on the CPU.

Bars: the mesh math and the native fragments are bitwise JAX's (the same
numpy operations; the same C++ source built with the same g++ flags).
Shading at float64 (geometry promoted, both packages) to 1e-12 x max |JAX|,
output and gradient w.r.t. the light colors (1e-11 where a near-antipodal
light makes N.H ill-conditioned: test_shading_f64_matches_jax). At float32 the specular power
(shininess 500) multiplies every rounding difference of N.H by about 500
(XLA's rsqrt is not correctly rounded, and its power chain rounds apart from
torch's), and a light almost opposite the view direction makes N.H
ill-conditioned in its inputs: so diffuse renders (kd = 1, the published
KD_VALUE) are held to 1e-5 x max |JAX| and renders with a specular term
(kd = 0.5) to 1e-4 in the mean relative difference, sum |port - JAX| / sum
|JAX|."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reni_tpu.core import sphere as jsph
from reni_tpu.render import inverse as jinv
from reni_tpu.render import mesh as jmesh
from reni_tpu.render import rasterizer as jrast
from reni_tpu.render import shading as jshading
from reni_tpu_torch.core import sphere as tsph
from reni_tpu_torch.render import inverse as tinv
from reni_tpu_torch.render import mesh as tmesh
from reni_tpu_torch.render import rasterizer as trast
from reni_tpu_torch.render import shading as tshading

ROOT = os.path.join(os.path.dirname(__file__), "..")
OBJS = ("sphere", "teapot", "torus")


def _obj(name):
    return os.path.join(ROOT, "data", "3D_Models", f"{name}.obj")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _max_rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _mean_rel(got, ref):
    return np.abs(got - ref).sum() / np.abs(ref).sum()


# ---------------------------------------------------------------------------
# mesh math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OBJS)
def test_mesh_functions_bitwise_jax(name):
    j, t = jmesh.load_obj(_obj(name)), tmesh.load_obj(_obj(name))
    for a, b in ((t.verts, j.verts), (t.faces, j.faces), (t.face_verts, j.face_verts),
                 (tmesh.vertex_normals(t), jmesh.vertex_normals(j)),
                 (tmesh.rotate_y(t.verts, 37.5), jmesh.rotate_y(j.verts, 37.5))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for dist, elev, azim in ((2.0, 0.0, 0.0), (2.5, 30.0, 120.0), (1.7, -30.0, 240.0)):
        for a, b in zip(tmesh.look_at(dist, elev, azim), jmesh.look_at(dist, elev, azim)):
            np.testing.assert_array_equal(a, b)
        r, tr, _ = tmesh.look_at(dist, elev, azim)
        view = t.verts @ r + tr
        np.testing.assert_array_equal(tmesh.fov_project(view), jmesh.fov_project(view))


def test_procedural_meshes_bitwise_jax():
    for a, b in ((tmesh.make_uv_sphere(8, 16), jmesh.make_uv_sphere(8, 16)),
                 (tmesh.make_uv_sphere(), jmesh.make_uv_sphere()),
                 (tmesh.make_torus(), jmesh.make_torus())):
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.faces, b.faces)


def test_load_obj_syntax(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                   "f 1//1 2//2 3//3\nf 2/1/1 4/2/2 3/3/3\nf -4 -3 -2\nf 1 2 4 3\n")
    m = tmesh.load_obj(str(obj))
    assert m.faces.shape == (5, 3)
    np.testing.assert_array_equal(m.faces[2], [0, 1, 2])  # negative indices
    np.testing.assert_array_equal(m.faces, jmesh.load_obj(str(obj)).faces)


# ---------------------------------------------------------------------------
# rasterizer
# ---------------------------------------------------------------------------


def _frags_equal(a, b):
    for k in ("pix_to_face", "bary_coords", "zbuf"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("case", ["teapot64", "sphere8x16"])
def test_native_fragments_bitwise_jax(case):
    """The port's native fragments are JAX's native fragments bit for bit
    (the teapot at 64, the 8 x 16 UV sphere at 16, from three cameras), and
    the port's numpy oracle is JAX's numpy oracle bit for bit (first camera:
    the oracle is slow)."""
    if case == "teapot64":
        j, t, res = jmesh.load_obj(_obj("teapot")), tmesh.load_obj(_obj("teapot")), 64
    else:
        j, t, res = jmesh.make_uv_sphere(8, 16), tmesh.make_uv_sphere(8, 16), 16
    for elev, azim in ((0.0, 0.0), (30.0, 120.0), (-30.0, 240.0)):
        jf, jeye = jrast.rasterize_world(j, res, elev=elev, azim=azim, backend="native")
        tf, teye = trast.rasterize_world(t, res, elev=elev, azim=azim)
        _frags_equal(tf, jf)
        np.testing.assert_array_equal(teye, jeye)
    jn, _ = jrast.rasterize_world(j, res, backend="numpy")
    tn, _ = trast.rasterize_world(t, res, backend="numpy")
    _frags_equal(tn, jn)


def test_native_matches_numpy_oracle():
    """Native against the numpy oracle at the bars of the JAX package's
    test_rasterizer_native_matches_numpy_oracle (silhouette pixels may flip
    on z-fighting ties; barycentrics to 1e-4)."""
    m = tmesh.make_torus()
    r, t, _ = tmesh.look_at(2.0)
    ndc = tmesh.fov_project(m.verts @ r + t)
    f_np = trast.rasterize_ndc(ndc, m.faces, 64, 64, backend="numpy")
    f_cc = trast.rasterize_ndc(ndc, m.faces, 64, 64)
    same = f_cc.pix_to_face == f_np.pix_to_face
    assert same.mean() > 0.995, same.mean()
    cover = same & (f_cc.pix_to_face >= 0)
    np.testing.assert_allclose(f_cc.bary_coords[cover], f_np.bary_coords[cover], atol=1e-4)
    s = f_cc.bary_coords.sum(-1)[f_cc.pix_to_face >= 0]
    np.testing.assert_allclose(s, 1.0, atol=1e-3)


def test_rasterizer_degenerate_behind_camera_and_bad_faces():
    verts = np.array(
        [[0.5, 0.5, 2.0], [-0.5, 0.5, 2.0], [0.0, -0.5, 2.0],  # in front
         [0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.2, 0.0, 2.0],  # collinear
         [0.5, 0.5, -1.0], [-0.5, 0.5, -1.0], [0.0, -0.5, -1.0]],  # behind
        dtype=np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], dtype=np.int32)
    for backend in ("native", "numpy"):
        frags = trast.rasterize_ndc(verts, faces, 16, 16, znear=1e-3, backend=backend)
        cover = frags.pix_to_face >= 0
        assert cover.any() and set(np.unique(frags.pix_to_face[cover])) == {0}
    with pytest.raises(ValueError, match="face indices"):
        trast.rasterize_ndc(verts, np.array([[0, 1, 9]], np.int32), 8, 8)
    with pytest.raises(ValueError, match="backend"):
        trast.rasterize_ndc(verts, faces, 8, 8, backend="auto")


def test_failed_build_raises(monkeypatch, tmp_path):
    """A rasterizer that does not build raises: no quiet numpy fallback."""
    bad = tmp_path / "rasterizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(trast, "SOURCE", bad)
    monkeypatch.setattr(trast, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(trast, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        trast.rasterize_ndc(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32), 4, 4)


def test_library_is_keyed_by_source_and_flags(monkeypatch):
    path = trast.library_path()
    assert path.parent == trast.BUILD_DIR and path.name.startswith("rasterizer-")
    monkeypatch.setattr(trast, "GXX_FLAGS", ("-O2", "-shared", "-fPIC"))
    assert trast.library_path() != path


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------


def _scene(name, res):
    j = jmesh.load_obj(_obj(name)) if name in OBJS else jmesh.make_uv_sphere(8, 16)
    frags, eye = jrast.rasterize_world(j, res, backend="native")
    vn = jmesh.vertex_normals(j)
    return j, frags, eye, vn[j.faces]


@pytest.mark.parametrize("name,res,width", [("uv8x16", 16, 16), ("teapot", 32, 32)])
def test_pixel_geometry_bitwise_jax(name, res, width):
    j, frags, eye, fn = _scene(name, res)
    jpos, jn = jshading.pixel_geometry(frags, j.face_verts, fn)
    tpos, tn = tshading.pixel_geometry(frags, j.face_verts, fn, "cpu")
    np.testing.assert_array_equal(_np(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))


def _shade_both(name, res, width, kd, dtype, seed=0, chunk=None):
    """(port render, JAX render, port grad, JAX grad) of sum(render * w)
    w.r.t. the light colors."""
    j, frags, eye, fn = _scene(name, res)
    pos, nrm = tshading.pixel_geometry(frags, j.face_verts, fn, "cpu")
    dirs = np.asarray(jsph.get_directions(width))[0]
    rng = np.random.default_rng(seed)
    colors = rng.gamma(2.0, 1.0, size=(2, dirs.shape[0], 3)).astype(dtype)
    w = rng.normal(size=(2, res, res, 3)).astype(dtype)
    geo = [_np(nrm), _np(pos), eye, dirs]
    kw = dict(kd=kd, ks=1.0 - kd)

    tc = torch.tensor(colors, requires_grad=True)
    out = tshading.blinn_phong_env_shading(
        *(torch.tensor(a) for a in geo), tc, chunk=chunk, **kw)
    (out * torch.tensor(w)).sum().backward()
    with jax.enable_x64(dtype == np.float64):
        jgeo = [jnp.asarray(a.astype(dtype)) for a in geo]
        jout = jshading.blinn_phong_env_shading(*jgeo, jnp.asarray(colors), **kw)
        jgrad = jax.grad(lambda c: jnp.sum(
            jshading.blinn_phong_env_shading(*jgeo, c, **kw) * w))(jnp.asarray(colors))
        jout, jgrad = np.asarray(jout), np.asarray(jgrad)
    assert out.dtype == torch.from_numpy(colors).dtype
    return _np(out), jout, _np(tc.grad), jgrad


@pytest.mark.parametrize("name,res,width", [("uv8x16", 16, 16), ("teapot", 32, 32),
                                            ("torus", 32, 32)])
@pytest.mark.parametrize("kd", [0.5, 1.0])
def test_shading_f64_matches_jax(name, res, width, kd):
    """1e-12, but 1e-11 for the specular renders of the teapot and the torus:
    a light within a few thousandths of a degree of -V (2 + 2 V.L ~ 1e-7)
    turns one float64 rounding of V.L or N.L into ~1e-10 of N.H and ~1e-7 of
    that pair's N.H^500, in both packages alike."""
    bar = 1e-11 if kd < 1.0 and name != "uv8x16" else 1e-12
    out, jout, g, jg = _shade_both(name, res, width, kd, np.float64)
    assert _max_rel(out, jout) <= bar
    assert _max_rel(g, jg) <= bar


@pytest.mark.parametrize("name,res,width", [("uv8x16", 16, 16), ("teapot", 32, 32),
                                            ("torus", 32, 32)])
def test_shading_f32_matches_jax(name, res, width):
    out, jout, g, jg = _shade_both(name, res, width, 1.0, np.float32)
    assert _max_rel(out, jout) <= 1e-5 and _max_rel(g, jg) <= 1e-5
    out, jout, g, jg = _shade_both(name, res, width, 0.5, np.float32)
    assert _mean_rel(out, jout) <= 1e-4 and _mean_rel(g, jg) <= 1e-4


def test_shading_chunking_invariance():
    """The chunk size (here 7 and 128 lights of 128) does not change the
    render beyond the order of the light sums."""
    a = _shade_both("torus", 24, 16, 0.5, np.float64, chunk=7)
    b = _shade_both("torus", 24, 16, 0.5, np.float64, chunk=128)
    assert _max_rel(a[0], b[0]) <= 1e-13 and _max_rel(a[2], b[2]) <= 1e-13


def test_shading_antipodal_light_no_nan():
    """A light exactly opposite the view direction (V.L = -1, where fp
    rounding can push 2 + 2 V.L below 0) renders no NaN, nor its gradient."""
    h = w = 4
    normals = torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3)
    positions = torch.zeros(h, w, 3)
    cam = torch.tensor([0.0, 0.0, 2.0])
    dirs = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.7071068, 0.0, -0.7071068]])
    colors = torch.ones(1, 3, 3, requires_grad=True)
    out = tshading.blinn_phong_env_shading(normals, positions, cam, dirs, colors,
                                           kd=0.5, ks=0.5, shininess=500.0)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(colors.grad).all()


def test_empty_mesh_renders_black():
    frags = trast.Fragments(np.full((8, 8), -1, np.int32), np.zeros((8, 8, 3), np.float32),
                            np.full((8, 8), np.inf, np.float32))
    fv = np.zeros((1, 3, 3), np.float32)
    positions, normals = tshading.pixel_geometry(frags, fv, fv, "cpu")
    out = tshading.blinn_phong_env_shading(
        normals, positions, torch.tensor([0.0, 0.0, 2.0]), torch.tensor([[0.0, 0.0, 1.0]]),
        torch.ones(1, 1, 3), kd=0.5, ks=0.5)
    assert torch.equal(out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# the inverse scene
# ---------------------------------------------------------------------------


def test_multi_view_render_fn_matches_jax():
    """Three views stacked along the height axis: view 0 bitwise the single
    view, each view against JAX's (float32, kd 0.5: the mean-relative bar
    above), mismatched view lists raise as in JAX."""
    views = dict(azimuths=(0.0, 120.0, 240.0), elevations=(0.0, 30.0, -30.0))
    scene = dict(render_resolution=16, kd=0.5, light_chunk=64)
    single = tinv.InverseRenderSetup(tmesh.make_uv_sphere(8, 16), device="cpu", **scene)
    multi = tinv.InverseRenderSetup(tmesh.make_uv_sphere(8, 16), device="cpu", **scene, **views)
    jmulti = jinv.InverseRenderSetup(jmesh.make_uv_sphere(8, 16), **scene, **views)
    with pytest.raises(ValueError, match="pair up"):
        tinv.InverseRenderSetup(tmesh.make_uv_sphere(8, 16), azimuths=(0.0, 90.0),
                                elevations=(0.0, 1.0, 2.0), device="cpu")
    width = 16
    rng = np.random.default_rng(3)
    env = rng.uniform(0.1, 1.0, size=(2, width * width // 2, 3)).astype(np.float32)
    sw = tsph.get_sineweight(width, device="cpu").expand(env.shape)
    r1 = single.render_fn(width)(torch.tensor(env), sw)
    rm = multi.render_fn(width)(torch.tensor(env), sw)
    assert tuple(r1.shape) == (2, 16, 16, 3) and tuple(rm.shape) == (2, 48, 16, 3)
    assert torch.equal(rm[:, :16], r1)
    jm = np.asarray(jmulti.render_fn(width)(jnp.asarray(env), jnp.asarray(_np(sw))))
    for v in range(3):
        assert _mean_rel(_np(rm[:, 16 * v:16 * (v + 1)]), jm[:, 16 * v:16 * (v + 1)]) <= 1e-4


@pytest.mark.parametrize("name", OBJS)
def test_bundled_meshes_drive_the_scene(name):
    """Every committed OBJ rasterizes to a silhouette covering 5-95% of a
    32 x 32 render, as the JAX package's test_bundled_assets_render asks."""
    setup = tinv.InverseRenderSetup(_obj(name), render_resolution=32, kd=0.5, device="cpu")
    jsetup = jinv.InverseRenderSetup(_obj(name), render_resolution=32, kd=0.5, backend="native")
    _frags_equal(setup.fragments, jsetup.fragments)
    covered = (setup.fragments.pix_to_face >= 0).mean()
    assert 0.05 < covered < 0.95, covered


def test_scene_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinv.InverseRenderSetup(tmesh.make_uv_sphere(8, 16), render_resolution=8)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded toward zero to TF32's 10 mantissa bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_tf32_guard_sees_a_tf32_dot():
    """The TF32 guard of chip_smoke.py (a GT render with a specular term,
    float32 against float64, sum |diff| / sum |f64| <= 1e-4) passes the
    float32 render of a seed-1 sky and fails the same render with the K = 3
    dots' inputs rounded to TF32's mantissa, by more than two orders of
    magnitude."""
    from reni_tpu_torch.data import synthetic

    m = tmesh.load_obj(_obj("teapot"))
    frags, eye = trast.rasterize_world(m, 32)
    vn = tmesh.vertex_normals(m)
    pos, nrm = tshading.pixel_geometry(frags, m.face_verts, vn[m.faces], "cpu")
    sky = synthetic.make_sky(np.random.default_rng(1), 64).reshape(1, -1, 3)
    colors = torch.tensor(sky) * tsph.get_sineweight(64, device="cpu")
    dirs = tsph.get_directions(64, device="cpu")[0]
    cam = torch.tensor(eye)

    def guard(n, d):
        r32 = tshading.blinn_phong_env_shading(n, pos, cam, d, colors, kd=0.5, ks=0.5)
        r64 = tshading.blinn_phong_env_shading(nrm, pos, cam, dirs, colors.double(),
                                               kd=0.5, ks=0.5)
        return ((r32.double() - r64).abs().sum() / r64.abs().sum()).item()

    assert guard(nrm, dirs) <= 1e-4
    assert guard(_tf32(nrm), _tf32(dirs)) > 1e-2
