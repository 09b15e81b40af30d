"""FIT_INVERSE: the port's trainer loop (``train/tasks.py::run_stage`` with
``make_fit_inverse_step`` and ``render/inverse.py::InverseRenderSetup.
render_fn``) fitting latents through the frozen decoder of a committed
checkpoint and the differentiable renderer to ground-truth renders.

Traffic keys: ``maps`` (the environment maps whose renders are the
targets, one batch), ``resolution`` [H, W] of the maps (W lights = H x W
map pixels), ``epochs_per_call``, ``map_range`` (normalised values of the
maps), ``compared_steps``. The scene, the render size and the loss weights
are the configuration's ``tasks.FIT_INVERSE``."""

from __future__ import annotations

import sys

import torch

from portbench import counts, harness, training, weights
from portbench.reference import compare, reni, scene as scene_lib
from portbench.reference import fit_inverse as ref_inv


def _task(cell: dict) -> dict:
    t = cell["config"]["tasks"]["FIT_INVERSE"]
    return {"lr_start": t["LR_START"], "lr_end": t["LR_END"], "beta1": t["OPTIMIZER_BETA_1"],
            "beta2": t["OPTIMIZER_BETA_2"], "epochs": t["EPOCHS"], "batch": t["BATCH_SIZE"],
            "prior": t["PRIOR_LOSS_WEIGHT"], "cosine": t["COSINE_SIMILARITY_WEIGHT"],
            "kd": t["KD_VALUE"], "render": t["RENDER_RESOLUTION"],
            "object": str(harness.ROOT / t["OBJECT_PATH"])}


def inputs(cell: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """(latents, maps) from the seed, in that order on one generator."""
    model, traffic = cell["config"]["model"], cell["traffic"]
    gen = weights.generator(seed, device)
    lat = weights.latents(model, gen, traffic["maps"], device)
    h, w = traffic["resolution"]
    return lat, weights.maps(gen, traffic["maps"], h * w, *traffic["map_range"], device)


class Program(training.Program):
    """The port's FIT_INVERSE state: the Zoo decoder (frozen), the seed's
    latents, the scene and its ground-truth renders."""

    def __init__(self, cell: dict, seed: int, device, mesh=None):
        from reni_tpu_torch.core import sphere
        from reni_tpu_torch.data.transforms import UnMinMaxNormalise
        from reni_tpu_torch.models.reni import RENIConfig, RENIModel
        from reni_tpu_torch.params import from_numpy
        from reni_tpu_torch.render.inverse import InverseRenderSetup
        from reni_tpu_torch.train import checkpoint, tasks
        from reni_tpu_torch.train.optim import OptimConfig

        if mesh is not None:
            raise ValueError("the FIT_INVERSE driver runs on one card")
        traffic, task, conf = cell["traffic"], _task(cell), cell["config"]
        self.cell = cell
        self.batch = task["batch"]
        self.epochs = traffic["epochs_per_call"]
        self.steps_per_epoch = -(-traffic["maps"] // self.batch)
        self.beta1 = task["beta1"]
        lat, maps = inputs(cell, seed, device)
        saved, _ = checkpoint.load_checkpoint(str(harness.ROOT / conf["zoo_checkpoint"]))
        params = {"decoder": from_numpy(saved["decoder"], device), "latents": lat}
        self.initial = reni.flatten(params)
        model = RENIModel(RENIConfig(**conf["model"], fixed_decoder=True))
        optim = OptimConfig(lr_start=task["lr_start"], lr_end=task["lr_end"], optimizer="adam",
                            beta1=task["beta1"], beta2=task["beta2"],
                            scheduler_type="exponential", epochs=task["epochs"],
                            steps_per_epoch=self.steps_per_epoch)
        self.state = tasks.init_train_state(model, params, optim,
                                            torch.Generator().manual_seed(int(seed) % (1 << 63)))
        width = traffic["resolution"][1]
        setup = InverseRenderSetup(task["object"], render_resolution=task["render"],
                                   kd=task["kd"], device=device)
        unnormalise = UnMinMaxNormalise(conf["hdr_minmax"])
        self.data = setup.generate_gt_renders(maps, unnormalise, width)
        directions = sphere.get_directions(width, device=device)
        sw = sphere.get_sineweight(width, device=device).to(maps.dtype)
        self.step = tasks.make_fit_inverse_step(
            model, directions, sw, setup.render_fn(width), unnormalise,
            alpha=task["prior"], beta=task["cosine"])
        self.runner = tasks.run_stage


def reference(cell: dict, seed: int, device, *, quant=None, half: bool = False) -> dict:
    """The reference's first steps from the seed's inputs, as norms."""
    traffic, task, conf = cell["traffic"], _task(cell), cell["config"]
    lat, maps = inputs(cell, seed, device)
    decoder = ref_inv.load_decoder(str(harness.ROOT / conf["zoo_checkpoint"]), device)
    scene = scene_lib.Scene(task["object"], task["render"], device)
    out = ref_inv.follow(conf["model"], task, decoder, lat["mu"], maps, scene,
                         steps=traffic["compared_steps"], width=traffic["resolution"][1],
                         minmax=conf["hdr_minmax"], quant=quant, half=half)
    return {"losses": out["losses"], "grad": compare.leaf_norms(out["grad"]),
            "change": compare.leaf_norms(out["change"])}


def report(prog: Program, steps: int, elapsed: float) -> dict:
    """inverse_step_ms: the window's whole time over its optimizer steps."""
    return {"inverse_step_ms": {"value": 1e3 * elapsed / steps, "unit": "ms"}}


def trace_info(prog: Program) -> dict:
    """A step's least time, the shading counted over the pixels the
    benchmark's own rasterizer finds covered."""
    traffic, task = prog.cell["traffic"], _task(prog.cell)
    h, w = traffic["resolution"]
    scene = scene_lib.Scene(task["object"], task["render"], "cpu")
    least = counts.fit_inverse_step(prog.cell["config"]["model"], task["batch"], h * w,
                                    scene.covered)["least_s"]
    return {"task": "fit_inverse", "least_s": least}


def run(ctx) -> dict | None:
    return training.run(ctx, sys.modules[__name__])
