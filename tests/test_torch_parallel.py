"""The port's data x pixel mesh (reni_tpu_torch/parallel/mesh.py, the mesh
half of train/tasks.py, render/inverse.py's fit_inverse(mesh=)) held against
the JAX package on the CPU.

Single-process cases: the mesh's shape rules, pad_batch_to, the streaming
chunk layout, latent-row padding and state_sharding, and the mesh-aware
unsupported_reason, against JAX's. Then one run of four gloo ranks on a
2 x 2 data x pixel mesh (tests/torch_mesh_worker.py, started once for the
module) mirrors tests/test_parallel.py, tests/test_pallas_sharded.py and
tests/test_streaming.py: FIT_DECODER of both conditionings against JAX's
single-device and 2 x 2 fits (loss rtol 2e-4, params atol 2e-5, JAX's latent
noise fed in); one float64 epoch on the mesh against the unsharded port to
1e-12 relative; shard_latents on a table whose rows do not divide the data
axis against the replicated table; decode_sharded; fit_inverse under the
mesh; the streaming runner from host memory and from disk, unchunked and in
chunks of 5, bit for bit the resident mesh run, each data rank decoding
only its own rows; two runs giving the same bits, and replicated parameters
equal bit for bit on every rank.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from reni_tpu.core import sphere as jsph
from reni_tpu.kernels import siren_pallas as jk
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.parallel import mesh as jmesh
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu_torch.data import synthetic
from reni_tpu_torch.kernels import siren_fwd as tk
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.parallel import mesh as pmesh
from reni_tpu_torch.params import from_numpy
from reni_tpu_torch.render import mesh as render_mesh
from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import tasks as ttasks
from torch_ranks import ROOT, Ranks

RANKS_S = 240  # the four ranks' time limit


def _synthetic(n, width, seed):
    d = np.asarray(jsph.get_directions(width))[0]
    rng = np.random.default_rng(seed)
    return np.stack([np.tanh(d @ rng.normal(size=(3, 3))) for _ in range(n)]).astype(np.float32)


def _jax_params(kw, seed, rows):
    return jax.device_get(JModel(JConfig(**kw)).init(jax.random.PRNGKey(seed), dataset_size=rows))


def _jax_noise(key, steps, shape):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _jtask(kw):
    return jtasks.TaskConfig(**dict(kw, optim=joptim.OptimConfig(**kw["optim"])))


def _flat(tree):
    return tck._flatten(tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks on the module's inputs; the value is a function
    that waits for them and returns [out_0.npz, ..., out_3.npz] and the
    inputs."""
    work = tmp_path_factory.mktemp("mesh")
    images = _synthetic(6, 16, seed=1)
    inp = {"images": images, "images64": images.astype(np.float64),
           "noise64": np.random.default_rng(2).normal(size=(2, 8, 4, 3)),
           "inverse_images": _synthetic(4, 16, seed=9) * 0.5}
    d = np.random.default_rng(8).normal(size=(1, 64, 3)).astype(np.float32)
    inp["directions"] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    trees = {"cbc": _jax_params(W.MODEL, 0, 6), "film": _jax_params(W.FILM, 0, 6),
             "five_decoder": _jax_params(W.MODEL, 11, 5),
             "inverse": _jax_params(W.INVERSE, 0, 4), "stream": _jax_params(W.MODEL, 4, 10)}
    trees["latent"] = trees["cbc"]
    trees["five_latent"] = trees["five_decoder"]
    for name, tree in trees.items():
        inp.update({f"{name}/{k}": v for k, v in _flat(tree).items()})
    for name in ("cbc", "film"):
        inp[f"noise_{name}"] = _jax_noise(jax.random.PRNGKey(1), W.DECODER["epochs"], (8, 4, 3))
    inp["exr_dir"] = np.asarray(synthetic.write_dataset(
        str(work / "exr"), train=10, test=0, width=16, seed=2)["Train"])
    np.savez(work / "inputs.npz", **inp)
    procs = Ranks([str(ROOT / "tests" / "torch_mesh_worker.py"), str(work),
                   str(work / "rendezvous")], 4)
    got = {}

    def results():
        if not got:
            procs.check(RANKS_S)
            got["out"] = [dict(np.load(work / f"out_{r}.npz")) for r in range(4)]
        return got["out"], inp, trees

    yield results
    for p in procs.procs:
        if p.poll() is None:
            p.kill()


def _part(out: dict, prefix: str) -> tuple[dict, dict]:
    params = {k[len(prefix) + 8:]: v for k, v in out.items() if k.startswith(prefix + "/params/")}
    metrics = {k[len(prefix) + 9:]: v for k, v in out.items()
               if k.startswith(prefix + "/metrics/")}
    return params, metrics


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_make_mesh_against_world_size(ranks):
    """One process is a world of one: a 1 x 1 mesh, and a mesh of more ranks
    raises naming both numbers, a model axis too; a rank of a mesh with a
    model axis sits at JAX's row-major coordinates, the model axis minor."""
    m = pmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "pixel": 1, "model": 1} and m.size == 1
    assert (m.data_index, m.pixel_index) == (0, 0)
    with pytest.raises(ValueError, match=r"data=2 x pixel=1 = 2 ranks, but WORLD_SIZE is 1"):
        pmesh.make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE 1 does not divide over pixel=2"):
        pmesh.make_mesh(n_pixel=2, device="cpu")
    with pytest.raises(ValueError, match=r"x model=2 = 2 ranks, but WORLD_SIZE is 1"):
        pmesh.make_mesh(n_data=1, n_model=2, device="cpu")
    layout = pmesh.Mesh(2, 2, rank=3)
    assert (layout.data_index, layout.pixel_index) == (1, 1)
    jm = jmesh.make_mesh(n_data=2, n_pixel=2, n_model=2, devices=jax.devices())
    for r, device in enumerate(jm.devices.reshape(-1)):
        tp = pmesh.Mesh(2, 2, 2, rank=r)
        coords = tuple(int(c[0]) for c in np.nonzero(jm.devices == device))
        assert (tp.data_index, tp.pixel_index, tp.model_index) == coords
        assert tp.cols(32) == slice(16 * coords[2], 16 * coords[2] + 16)
    assert layout.rows(8) == slice(4, 8) and layout.pixels(128) == slice(64, 128)
    assert layout.pixels(127) == slice(None) and layout.group("all") is None


def test_pad_batch_to():
    assert pmesh.pad_batch_to(3, 4) == jmesh.pad_batch_to(3, 4) == 4
    assert pmesh.pad_batch_to(8, 4) == 8
    assert pmesh.pad_batch_to(9, 8) == 16
    assert pmesh.pad_batch_to(21, 2) == 22


@pytest.mark.parametrize("n_data, K, B", [(2, 5, 4), (4, 3, 8), (1, 2, 3)])
def test_stream_chunk_layout_equals_jax(n_data, K, B):
    idx = np.random.default_rng(K).permutation(50)[: K * B].reshape(K, B)
    jm = jmesh.make_mesh(n_data=n_data, n_pixel=1, devices=jax.devices()[:n_data])
    jperm, jrows = jmesh.stream_chunk_layout(jm, idx)
    perm, rows = pmesh.stream_chunk_layout(pmesh.Mesh(n_data, 1), idx)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(rows, jrows)
    # each data rank's block of the staged chunk holds exactly its rows
    for d in range(n_data):
        m = pmesh.Mesh(n_data, 1, rank=d)
        pos = pmesh.batch_local_positions(m, K * B)
        block = perm if pos is None else perm[pos]
        for k in range(K):
            local = rows[k, m.rows(B)]
            np.testing.assert_array_equal(block[local], idx[k, m.rows(B)])


def test_placement_is_each_ranks_block():
    """batch_sharding / stream_chunk_shardings name JAX's axes; put_sharded,
    put_rows and chunk_gather give rank (1, 1) of a 2 x 2 layout its rows
    and pixels; put_rows fetches only those rows from the source, and a
    pixel axis that does not divide stays whole."""
    m = pmesh.Mesh(2, 2, rank=3)
    jm = jmesh.make_mesh(n_data=2, n_pixel=2, devices=jax.devices()[:4])
    for specs, jspecs in ((pmesh.batch_sharding(m, 128), jmesh.batch_sharding(jm, 128)),
                          (pmesh.batch_sharding(m, 127), jmesh.batch_sharding(jm, 127)),
                          (pmesh.stream_chunk_shardings(m, 128),
                           jmesh.stream_chunk_shardings(jm, 128))):
        assert [tuple(x.spec) for x in jspecs] == [tuple(x) for x in specs]
    src = np.arange(10 * 128 * 3, dtype=np.float32).reshape(10, 128, 3)
    np.testing.assert_array_equal(pmesh.put_sharded(src, m, ("data", "pixel")).numpy(),
                                  src[5:10, 64:])

    class Rows:
        shape, asked = src.shape, []

        def __getitem__(self, rows):
            self.asked.append(np.asarray(rows).tolist())
            return src[rows]

    rows = np.array([7, 1, 4, 2])
    spec = pmesh.batch_sharding(m, 128)[0]
    got = pmesh.put_rows(Rows(), rows, m, spec)
    np.testing.assert_array_equal(got.numpy(), src[[4, 2], 64:])
    assert Rows.asked == [[4, 2]]
    whole = pmesh.put_rows(src[:, :127], rows, m, pmesh.batch_sharding(m, 127)[0])
    assert whole.shape == (2, 127, 3)
    block = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(pmesh.chunk_gather(block, slice(2, 4)), block[2:4])


def test_pad_unpad_latent_rows_like_jax():
    tree = _jax_params(W.MODEL, 3, 5)
    jpad, jsizes = jmesh.pad_latent_rows(tree, 4)
    tpad, tsizes = pmesh.pad_latent_rows(from_numpy(tree, "cpu"), 4)
    assert set(tsizes) == {"latents/mu", "latents/log_var"} and set(tsizes.values()) == {5}
    assert len(jsizes) == 2
    for k, v in _flat(jax.device_get(jpad)).items():
        np.testing.assert_array_equal(_flat(tck.fetch_tree(tpad))[k], v)
    back = pmesh.unpad_latent_rows(tpad, tsizes)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(tck.fetch_tree(back))[k], v)


def test_state_sharding_refuses_an_unpadded_table():
    params = from_numpy(_jax_params(W.MODEL, 13, 6), "cpu")
    m = pmesh.Mesh(4, 2)
    with pytest.raises(ValueError, match="pad_latent_rows"):
        pmesh.state_sharding(m, {"latents": params["latents"]}, shard_latents=True)
    specs = pmesh.state_sharding(m, pmesh.pad_latent_rows(params, 4)[0], shard_latents=True)
    assert specs["latents/mu"] == ("data", None, None) and specs["decoder/final/w"] == ()
    assert set(pmesh.state_sharding(m, params).values()) == {()}
    # a mesh without a model axis shards no decoder leaf, asked or not
    assert set(pmesh.state_sharding(m, params, shard_model=True).values()) == {()}
    tp = pmesh.state_sharding(pmesh.Mesh(2, 1, 2), params)
    assert tp["decoder/layers/0/w"] == (None, "model") and tp["decoder/layers/1/w"] == (
        "model", None)
    assert tp["decoder/final/w"] == () and tp["latents/mu"] == ()


@pytest.mark.parametrize("npix, batch", [(512, 4), (512, 3), (511, 4), (528, 4), (64, None)])
def test_unsupported_reason_is_mesh_aware_like_jax(npix, batch):
    """The mesh's own reasons are JAX's word for word; where the mesh lets
    the shape through, the port checks the kernel's limits at the local
    extents (the CUDA kernels take any pixel count, JAX's a multiple of 8)."""
    jm = jmesh.make_mesh(n_data=4, n_pixel=2, devices=jax.devices())
    got = tk.unsupported_reason(npix, 128, batch=batch, mesh=pmesh.Mesh(4, 2))
    want = jk.unsupported_reason(npix, 128, batch=batch, mesh=jm)
    if want is not None and "axis" in want:
        assert got == want
    else:
        assert got is None
    assert tk.unsupported_reason(npix // 2, 128, batch=4) is None


def test_fused_step_reason_reads_the_active_mesh():
    model = RENIModel(RENIConfig(**dict(W.MODEL, use_pallas=True, hidden_features=64)))
    assert model.fused_step_reason(3, 128) is None
    with pmesh.kernel_mesh(pmesh.Mesh(2, 2), 128):
        assert "data axis" in model.fused_step_reason(3, 128)
        assert "pixel axis" in model.fused_step_reason(4, 127)
        assert model.fused_step_reason(4, 128) is None


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cbc", "film"])
def test_fit_decoder_on_mesh_matches_jax(ranks, name):
    """FIT_DECODER on the 2 x 2 mesh (6 maps in a batch padded to 8) against
    JAX's single-device fit and JAX's 2 x 2 fit, at tests/test_parallel.py's
    bars; the replicated leaves (all of them) equal on the four ranks."""
    kw = W.MODEL if name == "cbc" else W.FILM
    outs, inp, trees = ranks()
    jm = JModel(JConfig(**kw))
    imgs = jnp.asarray(inp["images"])
    jmesh4 = jmesh.make_mesh(n_data=2, n_pixel=2, devices=jax.devices()[:4])
    for mesh in (None, jmesh4):
        jp, jmet = jtasks.fit_task(jm, trees[name], _jtask(W.DECODER), lambda res: imgs,
                                   jax.random.PRNGKey(1), mesh=mesh)
        params, metrics = _part(outs[0], f"fit_{name}")
        np.testing.assert_allclose(metrics["fit_decoder_loss"], jmet["fit_decoder_loss"],
                                   rtol=2e-4)
        want = _flat(jax.device_get(jp))
        assert params.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(params[k], want[k], atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", ["cbc", "film"])
def test_two_runs_on_the_mesh_give_the_same_bits(ranks, name):
    outs, _, _ = ranks()
    for out in outs:
        a, b = _part(out, f"fit_{name}"), _part(out, f"fit_{name}_again")
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("name", ["cbc", "film", "latent"])
def test_sharded_epoch_f64_matches_unsharded(ranks, name):
    """One float64 epoch (one step: 6 maps, a batch padded to 8) on the mesh
    against the port's unsharded step: the metrics to 1e-12 relative, the
    updated leaves to 1e-9 (Adam's first step is about lr * sign(g))."""
    outs, inp, trees = ranks()
    kw = {"cbc": W.MODEL, "film": W.FILM, "latent": dict(W.MODEL, fixed_decoder=True)}[name]
    task = W.task_config(W.LATENT if name == "latent" else W.DECODER, epochs=1)
    feed = iter(inp["noise64"])
    tree = from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), trees[name]), "cpu")
    f64 = torch.from_numpy(inp["images64"])
    p, m = ttasks.fit_task(RENIModel(RENIConfig(**kw)), tree, task, lambda res: f64,
                           torch.Generator().manual_seed(0),
                           latent_noise=lambda shape: torch.from_numpy(next(feed)))
    params, metrics = _part(outs[0], f"f64_{name}")
    assert metrics.keys() == m.keys()
    for k in m:
        np.testing.assert_allclose(metrics[k], m[k], rtol=1e-12, atol=0, err_msg=k)
    want = _flat(tck.fetch_tree(p))
    for k in want:
        np.testing.assert_allclose(params[k], want[k], rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["cbc", "film", "latent"])
def test_sharded_kernel_plan_matches_unsharded(ranks, name):
    """With use_pallas (on CPU tensors the kernels' plain versions: the
    train-step kernel of either conditioning for FIT_DECODER, the forward and
    backward for FIT_LATENT) each rank runs its block and the gradients sum
    over the mesh: one float32 epoch equals the unsharded step's (metrics
    rtol 1e-5, leaves atol 1e-6)."""
    outs, inp, trees = ranks()
    _, kw, task = {n: (n, k, t) for n, k, t in W.FUSED}[name]
    feed = iter(inp["noise64"].astype(np.float32))
    imgs = torch.from_numpy(inp["images"])
    p, m = ttasks.fit_task(RENIModel(RENIConfig(**kw)), from_numpy(trees[name], "cpu"),
                           W.task_config(task, epochs=1), lambda res: imgs,
                           torch.Generator().manual_seed(0),
                           latent_noise=lambda shape: torch.from_numpy(next(feed)))
    params, metrics = _part(outs[0], f"fused_{name}")
    assert metrics.keys() == m.keys()
    for k in m:
        np.testing.assert_allclose(metrics[k], m[k], rtol=1e-5, err_msg=k)
    want = _flat(tck.fetch_tree(p))
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["decoder", "latent"])
def test_shard_latents_matches_the_replicated_table(ranks, name):
    """5 latent rows on a data axis of 2: padded to 6, row-sharded for each
    stage and unpadded after it, against the replicated table (JAX's bars:
    loss rtol 1e-5, params atol 1e-6); the table comes back with 5 rows."""
    outs, _, _ = ranks()
    for out in outs:
        rep, shard = _part(out, f"shard_{name}_0"), _part(out, f"shard_{name}_1")
        assert shard[0]["latents/mu"].shape == (5, 4, 3)
        for k in rep[1]:
            np.testing.assert_allclose(shard[1][k], rep[1][k], rtol=1e-5, err_msg=k)
        for k in rep[0]:
            np.testing.assert_allclose(shard[0][k], rep[0][k], atol=1e-6, err_msg=k)


def test_decode_sharded_matches_the_unsharded_decode(ranks):
    """Each rank decodes 16 of the 64 directions; every rank gets the whole
    (2, 64, 3), equal to a one-rank decode (atol 1e-5, JAX's bar; here the
    bits, since each direction is decoded alone)."""
    outs, _, _ = ranks()
    for out in outs:
        assert out["decode/sharded"].shape == (2, 64, 3)
        np.testing.assert_allclose(out["decode/sharded"], out["decode/plain"], atol=1e-5)
        np.testing.assert_array_equal(out["decode/sharded"], outs[0]["decode/sharded"])


def test_fit_inverse_under_the_mesh(ranks):
    """FIT_INVERSE on the 2 x 2 mesh: the 16-row renders split over the pixel
    axis, the whole light set decoded on each rank. Finite, falling, and at
    the single-device port run's losses (rtol 2e-4)."""
    outs, inp, trees = ranks()
    params, metrics = _part(outs[0], "inverse")
    loss = metrics["fit_inverse_loss"]
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    setup = InverseRenderSetup(render_mesh.make_uv_sphere(8, 16), device="cpu", **W.SCENE)
    imgs = torch.from_numpy(inp["inverse_images"])
    p, m = fit_inverse(RENIModel(RENIConfig(**W.INVERSE)), from_numpy(trees["inverse"], "cpu"),
                       W.task_config(W.INVERSE_TASK), lambda res: imgs, lambda x: x,
                       torch.Generator().manual_seed(1), setup=setup)
    np.testing.assert_allclose(loss, m["fit_inverse_loss"], rtol=2e-4)
    np.testing.assert_allclose(params["latents/mu"], _flat(tck.fetch_tree(p))["latents/mu"],
                               atol=2e-5)


@pytest.mark.parametrize("label", ["host", "host_chunk", "disk", "disk_chunk"])
def test_streaming_on_the_mesh_is_the_resident_run(ranks, label):
    """The streaming runner's mesh half (from host memory or from disk,
    unchunked or in chunks of 5) ends bit for bit at the resident mesh run."""
    outs, _, _ = ranks()
    for out in outs:
        base, got = _part(out, "stream_resident"), _part(out, f"stream_{label}")
        for x, y in zip(base, got):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("label", ["disk", "disk_chunk"])
def test_each_rank_decodes_only_its_rows(ranks, label):
    """From disk, the two data ranks of a pixel coordinate decode disjoint
    rows that cover the 10 maps (batches of 2: data rank d holds 2b + d)."""
    outs, _, _ = ranks()
    by_pixel: dict = {}
    for out in outs:
        d, p = out["coords"]
        rows = out[f"stream_{label}/decoded"]
        assert len(set(rows.tolist())) == len(rows), "a row decoded twice"
        assert set(rows.tolist()) == set(range(d, 10, 2))
        by_pixel.setdefault(int(p), []).append(set(rows.tolist()))
    for p, sets in by_pixel.items():
        assert sets[0].isdisjoint(sets[1]) and sets[0] | sets[1] == set(range(10))


def test_replicated_params_are_bitwise_equal_on_every_rank(ranks):
    outs, _, _ = ranks()
    keys = [k for k in outs[0] if "/params/" in k or "/metrics/" in k or k.startswith("decode")]
    assert len(keys) > 100
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)
