"""One rank of tests/test_torch_parallel.py's four-rank run: a 2 x 2 data x
pixel mesh of gloo ranks on the CPU (rendezvous through a file).

    WORLD_SIZE=4 RANK=r LOCAL_RANK=r python tests/torch_mesh_worker.py DIR INIT_FILE

reads DIR/inputs.npz (written by the test: parameters and latent noise drawn
by the JAX package, the maps, the EXR dataset's path) and writes
DIR/out_<rank>.npz, every scenario's results under its own prefix. Imports
no JAX: the test holds the results against the JAX package in its own
process. The constants below are shared with the test.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

MODEL = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
             hidden_layers=1, hidden_features=32, output_activation=None)
FILM = dict(MODEL, conditioning="FiLM", mapping_layers=2, mapping_features=16)
INVERSE = dict(MODEL, fixed_decoder=True)
RES = (8, 16)
# FIT_DECODER as tests/test_parallel.py::test_dp_training_matches_single_device
DECODER = dict(task="FIT_DECODER", optim=dict(lr_start=1e-4, lr_end=1e-5), batch_size=8,
               epochs=5, multi_res_training=False, final_resolution=RES, kld_weighting=1e-4)
LATENT = dict(task="FIT_LATENT", optim=dict(lr_start=1e-2, lr_end=1e-4, beta2=0.9),
              batch_size=8, epochs=1, multi_res_training=False, final_resolution=RES,
              cosine_similarity_weight=1e-1, prior_loss_weight=1e-3)
# as tests/test_parallel.py::test_fit_inverse_under_mesh
INVERSE_TASK = dict(task="FIT_INVERSE", optim=dict(lr_start=5e-2, lr_end=1e-2), batch_size=4,
                    epochs=6, multi_res_training=False, final_resolution=RES,
                    prior_loss_weight=1e-7, cosine_similarity_weight=1e-3)
SCENE = dict(render_resolution=16, kd=0.5, light_chunk=64)
STREAM = dict(DECODER, batch_size=2, epochs=2)
KERNEL = dict(use_pallas=True, pallas_trunk="float32")
FUSED = (("cbc", dict(MODEL, **KERNEL), DECODER), ("film", dict(FILM, **KERNEL), DECODER),
         ("latent", dict(MODEL, fixed_decoder=True, **KERNEL), LATENT))
STREAM_CHUNK = 5  # 10 maps in batches of 2: 5 batches an epoch, one chunk
PUBLISHED = [["minmaxnormalise", [-18.0536, 11.4633]]]


def task_config(kw: dict, **over):
    from reni_tpu_torch.train.optim import OptimConfig
    from reni_tpu_torch.train.tasks import TaskConfig

    kw = dict(kw, **over)
    return TaskConfig(**dict(kw, optim=OptimConfig(**kw["optim"])))


def tree(inp, prefix: str, dtype=None):
    from reni_tpu_torch.params import from_numpy
    from reni_tpu_torch.train.checkpoint import _unflatten

    flat = {k[len(prefix) + 1:]: inp[k] for k in inp.files if k.startswith(prefix + "/")}
    t = from_numpy(_unflatten(flat), "cpu")
    return t if dtype is None else {k: _cast(v, dtype) for k, v in t.items()}


def _cast(t, dtype):
    if isinstance(t, dict):
        return {k: _cast(v, dtype) for k, v in t.items()}
    if isinstance(t, list):
        return [_cast(v, dtype) for v in t]
    return t.to(dtype)


def put(out: dict, prefix: str, params, metrics: dict) -> None:
    from reni_tpu_torch.train.checkpoint import _flatten, fetch_tree

    for k, v in _flatten(fetch_tree(params)).items():
        out[f"{prefix}/params/{k}"] = v
    for k, v in metrics.items():
        out[f"{prefix}/metrics/{k}"] = np.asarray(v)


def main() -> None:
    torch.set_num_threads(1)
    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.parallel import mesh as pmesh
    from reni_tpu_torch.parallel import multihost
    from reni_tpu_torch.render import mesh as render_mesh
    from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse
    from reni_tpu_torch.train import tasks

    work, init = sys.argv[1], sys.argv[2]
    assert multihost.initialize(device="cpu", init_method=f"file://{init}")
    mesh = pmesh.make_mesh(n_data=2, n_pixel=2, device="cpu")
    inp = np.load(os.path.join(work, "inputs.npz"))
    images = torch.from_numpy(inp["images"])
    out: dict = {"coords": np.array([mesh.data_index, mesh.pixel_index])}

    # FIT_DECODER, both conditionings, against JAX (the noise JAX drew)
    for name, kw in (("cbc", MODEL), ("film", FILM)):
        for run in ("", "_again"):
            feed = iter(inp[f"noise_{name}"])
            model = RENIModel(RENIConfig(**kw))
            params, metrics = tasks.fit_task(
                model, tree(inp, name), task_config(DECODER), lambda res: images,
                torch.Generator().manual_seed(0), mesh=mesh,
                latent_noise=lambda shape: torch.from_numpy(next(feed)))
            put(out, f"fit_{name}{run}", params, metrics)

    # one epoch at float64 on the mesh (the test runs it unsharded)
    f64 = torch.from_numpy(inp["images64"])
    for name, kw, task in (("cbc", MODEL, DECODER), ("film", FILM, DECODER),
                           ("latent", dict(MODEL, fixed_decoder=True), LATENT)):
        feed = iter(inp["noise64"])
        model = RENIModel(RENIConfig(**kw))
        params, metrics = tasks.fit_task(
            model, tree(inp, "latent" if name == "latent" else name, torch.float64),
            task_config(task, epochs=1), lambda res: f64, torch.Generator().manual_seed(0),
            mesh=mesh, latent_noise=lambda shape: torch.from_numpy(next(feed)))
        put(out, f"f64_{name}", params, metrics)

    # the kernels' plain versions (use_pallas on CPU tensors): the train-step
    # kernel's sharded plan, and FIT_LATENT through the forward and backward
    for name, kw, task in FUSED:
        feed = iter(inp["noise64"].astype(np.float32))
        model = RENIModel(RENIConfig(**kw))
        params, metrics = tasks.fit_task(
            model, tree(inp, "latent" if name == "latent" else name), task_config(task, epochs=1),
            lambda res: images, torch.Generator().manual_seed(0), mesh=mesh,
            latent_noise=lambda shape: torch.from_numpy(next(feed)))
        put(out, f"fused_{name}", params, metrics)

    # shard_latents against the replicated table; 5 rows on a data axis of 2
    five = images[:5]
    for name, kw, task in (("decoder", MODEL, dict(DECODER, epochs=3)),
                           ("latent", dict(MODEL, fixed_decoder=True), dict(LATENT, epochs=3))):
        for shard in (False, True):
            model = RENIModel(RENIConfig(**kw))
            params, metrics = tasks.fit_task(
                model, tree(inp, f"five_{name}"), task_config(task), lambda res: five,
                torch.Generator().manual_seed(3), mesh=mesh, shard_latents=shard)
            put(out, f"shard_{name}_{int(shard)}", params, metrics)

    # decode_sharded against the rank's own unsharded decode
    model = RENIModel(RENIConfig(**MODEL))
    params = tree(inp, "cbc")
    Z = model.latents(params, [0, 1])
    D = torch.from_numpy(inp["directions"])
    out["decode/sharded"] = pmesh.decode_sharded(model, params, Z, D, mesh).numpy()
    with torch.no_grad():
        out["decode/plain"] = model.apply(params, Z, D).numpy()

    # FIT_INVERSE under the mesh
    inv_model = RENIModel(RENIConfig(**INVERSE))
    setup = InverseRenderSetup(render_mesh.make_uv_sphere(8, 16), device="cpu", **SCENE)
    inv_images = torch.from_numpy(inp["inverse_images"])
    params, metrics = fit_inverse(
        inv_model, tree(inp, "inverse"), task_config(INVERSE_TASK), lambda res: inv_images,
        lambda x: x, torch.Generator().manual_seed(1), setup=setup, mesh=mesh)
    put(out, "inverse", params, metrics)

    # the streaming runner on the mesh: resident, from host memory, chunked,
    # from disk (each rank's decodes recorded)
    lazy = datasets.get_dataset("RENI_HDR", str(inp["exr_dir"]), PUBLISHED, True, lazy=True)
    eager = datasets.get_dataset("RENI_HDR", str(inp["exr_dir"]), PUBLISHED, True)
    decoded: list = []
    lock = threading.Lock()
    stage_row = lazy._stage_row

    def recorded(i, res):
        with lock:
            decoded.append(i)
        return stage_row(i, res)

    lazy._stage_row = recorded
    model = RENIModel(RENIConfig(**MODEL))
    for label, images_at, kw in (
            ("resident", lambda res: eager.images_at(res, device="cpu"), {}),
            ("host", eager.images_host_at, dict(stream=True)),
            ("host_chunk", eager.images_host_at, dict(stream=True, stream_chunk=STREAM_CHUNK)),
            ("disk", lazy.row_source_at, dict(stream=True)),
            ("disk_chunk", lazy.row_source_at, dict(stream=True, stream_chunk=STREAM_CHUNK))):
        decoded.clear()
        params, metrics = tasks.fit_task(
            model, tree(inp, "stream"), task_config(STREAM), images_at,
            torch.Generator().manual_seed(5), mesh=mesh, **kw)
        put(out, f"stream_{label}", params, metrics)
        out[f"stream_{label}/decoded"] = np.asarray(sorted(decoded), np.int64)
    lazy.close()
    eager.close()

    np.savez(os.path.join(work, f"out_{mesh.rank}.npz"), **out)
    multihost.barrier("done")


if __name__ == "__main__":
    main()
