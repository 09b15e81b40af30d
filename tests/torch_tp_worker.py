"""One rank of tests/test_torch_tp.py's runs of the tensor-parallel model
axis: gloo ranks on the CPU, the rendezvous through a file.

    WORLD_SIZE=4 RANK=r LOCAL_RANK=r python tests/torch_tp_worker.py four DIR INIT
    WORLD_SIZE=2 RANK=r LOCAL_RANK=r python tests/torch_tp_worker.py two DIR INIT

``four`` runs on a 2 x 1 x 2 and a 1 x 1 x 4 mesh of the same four ranks,
``two`` on a 1 x 1 x 2 mesh. Each reads DIR/inputs.npz (written by the test:
parameters and latent noise drawn by the JAX package, the maps, the EXR
dataset's path) and writes DIR/<mode>_<rank>.npz, every scenario under its
own prefix. Imports no JAX: the test holds the results against the JAX
package in its own process. The constants below are shared with the test.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

from torch_mesh_worker import PUBLISHED, put, task_config, tree

MODEL = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
             hidden_layers=1, hidden_features=32, output_activation=None)
# an even last trunk layer: final.w row-parallel
DEEP = dict(MODEL, hidden_layers=2)
FILM = dict(MODEL, conditioning="FiLM", hidden_layers=3, mapping_layers=2, mapping_features=16)
INVERSE = dict(MODEL, fixed_decoder=True)
# tests/test_parallel.py::test_tp_training_matches_single_device
TP = dict(task="FIT_DECODER", optim=dict(lr_start=1e-4, lr_end=1e-5), batch_size=8, epochs=5,
          multi_res_training=False, final_resolution=(8, 16), kld_weighting=1e-4)
# tests/test_parallel.py::test_tp_only_mesh_matches_single_device
TP_ONLY = dict(TP, optim=dict(lr_start=1e-4, lr_end=1e-4), batch_size=4, epochs=3)
LATENT = dict(task="FIT_LATENT", optim=dict(lr_start=1e-2, lr_end=1e-4, beta2=0.9),
              batch_size=8, epochs=1, multi_res_training=False, final_resolution=(8, 16),
              cosine_similarity_weight=1e-1, prior_loss_weight=1e-3)
INVERSE_TASK = dict(task="FIT_INVERSE", optim=dict(lr_start=5e-2, lr_end=1e-2), batch_size=4,
                    epochs=4, multi_res_training=False, final_resolution=(8, 16),
                    prior_loss_weight=1e-7, cosine_similarity_weight=1e-3)
SCENE = dict(render_resolution=16, kd=0.5, light_chunk=64)
# tests/test_streaming.py::test_streaming_on_tp_mesh: 8 maps, batch 4, chunk 2
STREAM = dict(TP, optim=dict(lr_start=1e-3, lr_end=1e-4), batch_size=4, epochs=2,
              final_resolution=(16, 32))


def fit(model_kw, params, task, images, mesh, noise=None, **kw):
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.train import tasks

    feed = None if noise is None else iter(noise)
    return tasks.fit_task(
        RENIModel(RENIConfig(**model_kw)), params, task, lambda res: images,
        torch.Generator().manual_seed(0), mesh=mesh,
        latent_noise=None if feed is None else (lambda shape: torch.from_numpy(next(feed))),
        **kw)


def four(inp, out: dict) -> None:
    from reni_tpu_torch.data import datasets
    from reni_tpu_torch.models.reni import RENIConfig, RENIModel
    from reni_tpu_torch.params import from_numpy
    from reni_tpu_torch.parallel import mesh as pmesh
    from reni_tpu_torch.render import mesh as render_mesh
    from reni_tpu_torch.render.inverse import InverseRenderSetup, fit_inverse
    from reni_tpu_torch.train import tasks
    from reni_tpu_torch.train.checkpoint import _flatten, _unflatten

    mesh = pmesh.make_mesh(2, 1, 2, device="cpu")
    only = pmesh.make_mesh(1, 1, 4, device="cpu")
    out["coords"] = np.array([mesh.data_index, mesh.pixel_index, mesh.model_index,
                              only.model_index])

    # FIT_DECODER against JAX, twice for the bits
    for run in ("", "_again"):
        p, m = fit(MODEL, tree(inp, "tp"), task_config(TP), torch.from_numpy(inp["images_tp"]),
                   mesh, inp["noise_tp"])
        put(out, f"tp{run}", p, m)
    p, m = fit(MODEL, tree(inp, "tp_only"), task_config(TP_ONLY),
               torch.from_numpy(inp["images_tp_only"]), only, inp["noise_tp_only"])
    put(out, "tp_only", p, m)

    # one float64 epoch: FIT_DECODER, and FIT_LATENT on the sharded frozen decoder
    f64 = torch.from_numpy(inp["images_tp"].astype(np.float64))
    for name, kw, task, key in (("cbc", MODEL, TP, "tp"), ("deep", DEEP, TP, "deep"),
                                ("latent", dict(MODEL, fixed_decoder=True), LATENT, "tp")):
        p, m = fit(kw, tree(inp, key, torch.float64), task_config(task, epochs=1), f64, mesh,
                   inp["noise64"])
        put(out, f"f64_{name}", p, m)

    # the dispatch: use_pallas on CPU tensors under the model axis declines
    # the kernel with JAX's reason and decodes through the sharded decoder
    model = RENIModel(RENIConfig(**dict(MODEL, use_pallas=True)))
    whole = tree(inp, "tp")
    specs = pmesh.state_sharding(mesh, whole)
    sliced = from_numpy(_unflatten({k: pmesh.put_sharded(v, mesh, specs[k]).numpy()
                                    for k, v in _flatten(whole).items()}), "cpu")
    D = torch.from_numpy(inp["directions"])
    Z = model.latents(whole, [0, 1, 2])
    with torch.no_grad(), pmesh.kernel_mesh(mesh, D.shape[1]):
        out["dispatch/decode"] = model.apply(sliced, Z, D).numpy()
        out["dispatch/reason"] = np.array(model.fused_step_reason(8, D.shape[1]))

    # FIT_INVERSE with the sharded frozen decoder
    setup = InverseRenderSetup(render_mesh.make_uv_sphere(8, 16), device="cpu", **SCENE)
    p, m = fit_inverse(RENIModel(RENIConfig(**INVERSE)), tree(inp, "inverse"),
                       task_config(INVERSE_TASK), lambda res: torch.from_numpy(inp["inverse"]),
                       lambda x: x, torch.Generator().manual_seed(1), setup=setup, mesh=mesh)
    put(out, "inverse", p, m)

    # the streaming runner on the model axis: resident, host memory and disk in chunks of 2
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
            ("host", eager.images_host_at, dict(stream=True, stream_chunk=2)),
            ("disk", lazy.row_source_at, dict(stream=True, stream_chunk=2))):
        decoded.clear()
        p, m = tasks.fit_task(model, tree(inp, "stream"), task_config(STREAM), images_at,
                              torch.Generator().manual_seed(5), mesh=mesh, **kw)
        put(out, f"stream_{label}", p, m)
        out[f"stream_{label}/decoded"] = np.asarray(sorted(decoded), np.int64)
    lazy.close()
    eager.close()


def two(inp, out: dict) -> None:
    from reni_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(1, 1, 2, device="cpu")
    p, m = fit(FILM, tree(inp, "film"), task_config(TP), torch.from_numpy(inp["images_tp"]),
               mesh, inp["noise_tp"])
    put(out, "film", p, m)
    f64 = torch.from_numpy(inp["images_tp"].astype(np.float64))
    p, m = fit(FILM, tree(inp, "film", torch.float64), task_config(TP, epochs=1), f64, mesh,
               inp["noise64"])
    put(out, "f64_film", p, m)


def main() -> None:
    torch.set_num_threads(1)
    from reni_tpu_torch.parallel import multihost

    mode, work, init = sys.argv[1:4]
    assert multihost.initialize(device="cpu", init_method=f"file://{init}")
    inp = np.load(os.path.join(work, "inputs.npz"))
    out: dict = {}
    {"four": four, "two": two}[mode](inp, out)
    np.savez(os.path.join(work, f"{mode}_{multihost.process_index()}.npz"), **out)
    multihost.barrier("done")


if __name__ == "__main__":
    main()
