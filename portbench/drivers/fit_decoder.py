"""FIT_DECODER: the port's trainer loop (``train/tasks.py::run_stage`` with
``make_fit_decoder_step``, or on several cards ``parallel/mesh.py::
sharded_stage_runner``) over maps resident on the card.

Traffic keys: ``maps`` (resident maps), ``resolution`` [H, W],
``batch_per_rank``, ``ranks``, ``epochs_per_call`` (one runner call, as the
trainer makes between callbacks; each ends in a host synchronise),
``map_range`` (the normalised values the maps are drawn from),
``compared_steps`` (the first steps the reference follows).

Set-up builds one training state from the seed and drives its first epoch
through the window's own runner call and feed; the reference follows its
first ``compared_steps`` steps from the same inputs once the window has
closed. The window calls the runner until ``--seconds`` have passed."""

from __future__ import annotations

import sys

import torch

from portbench import counts, training, weights
from portbench.reference import compare, reni
from portbench.reference import fit_decoder as ref_fit


def _task(cell: dict) -> dict:
    t = cell["config"]["tasks"]["FIT_DECODER"]
    return {"lr_start": t["LR_START"], "lr_end": t["LR_END"], "beta1": t["OPTIMIZER_BETA_1"],
            "beta2": t["OPTIMIZER_BETA_2"], "epochs": t["EPOCHS"],
            "kld_weighting": t["KLD_WEIGHTING"]}


def inputs(cell: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """(params, maps) from the seed: decoder, latent table, then the maps,
    in that order on one generator of ``device``."""
    model, traffic = cell["config"]["model"], cell["traffic"]
    gen = weights.generator(seed, device)
    params = {"decoder": weights.decoder(model, gen, device),
              "latents": weights.latents(model, gen, traffic["maps"], device)}
    h, w = traffic["resolution"]
    maps = weights.maps(gen, traffic["maps"], h * w, *traffic["map_range"], device)
    return params, maps


def noise_generator(seed: int) -> torch.Generator:
    """The task's host generator of the VAD noise."""
    return torch.Generator().manual_seed(int(seed) % (1 << 63))


class Program(training.Program):
    """The port's FIT_DECODER state on this rank: its runner, step and maps."""

    def __init__(self, cell: dict, seed: int, device, mesh=None):
        from reni_tpu_torch.core import sphere
        from reni_tpu_torch.models.reni import RENIConfig, RENIModel
        from reni_tpu_torch.train import tasks
        from reni_tpu_torch.train.optim import OptimConfig

        traffic, task = cell["traffic"], _task(cell)
        self.cell = cell
        self.batch = traffic["batch_per_rank"] * traffic["ranks"]
        self.epochs = traffic["epochs_per_call"]
        params, self.data = inputs(cell, seed, device)
        self.initial = reni.flatten(params)
        self.steps_per_epoch = -(-traffic["maps"] // self.batch)
        self.beta1 = task["beta1"]
        model = RENIModel(RENIConfig(**cell["config"]["model"]))
        optim = OptimConfig(lr_start=task["lr_start"], lr_end=task["lr_end"], optimizer="adam",
                            beta1=task["beta1"], beta2=task["beta2"],
                            scheduler_type="exponential", epochs=task["epochs"],
                            steps_per_epoch=self.steps_per_epoch)
        self.state = tasks.init_train_state(model, params, optim, noise_generator(seed))
        width = traffic["resolution"][1]
        directions = sphere.get_directions(width, device=device)
        sw = sphere.get_sineweight(width, device=device).to(self.data.dtype)
        self.step = tasks.make_fit_decoder_step(model, directions, sw,
                                                kld_weighting=task["kld_weighting"])
        if mesh is None:
            self.runner = tasks.run_stage
        else:
            from reni_tpu_torch.parallel.mesh import sharded_stage_runner

            self.runner = sharded_stage_runner(mesh)


def reference(cell: dict, seed: int, device, *, quant=None, half: bool = False) -> dict:
    """The reference's first steps from the seed's inputs, as norms."""
    traffic = cell["traffic"]
    params, maps = inputs(cell, seed, device)
    batch = traffic["batch_per_rank"] * traffic["ranks"]
    out = ref_fit.follow(cell["config"]["model"], _task(cell), params, maps, noise_generator(seed),
                         steps=traffic["compared_steps"], batch=batch,
                         steps_per_epoch=-(-traffic["maps"] // batch),
                         width=traffic["resolution"][1], quant=quant, half=half)
    return {"losses": out["losses"], "grad": compare.leaf_norms(out["grad"]),
            "change": compare.leaf_norms(out["change"])}


def report(prog: Program, steps: int, elapsed: float) -> dict:
    """train_dirs_per_s: every unmasked direction of every step in the
    window (on all cards: each epoch's maps, whatever the batches' padding)
    over the window's whole time."""
    traffic = prog.cell["traffic"]
    h, w = traffic["resolution"]
    epochs = steps / prog.steps_per_epoch
    return {"train_dirs_per_s": {"value": epochs * traffic["maps"] * h * w / elapsed,
                                 "unit": "directions/s"}}


def trace_info(prog: Program) -> dict:
    """A card's least time a step (its share of the batch)."""
    traffic, model = prog.cell["traffic"], prog.cell["config"]["model"]
    h, w = traffic["resolution"]
    least = counts.fit_decoder_step(model, traffic["batch_per_rank"], h * w)["least_s"]
    return {"task": "fit_decoder", "least_s": least}


def run(ctx) -> dict | None:
    """One run of the cell on this rank; rank 0 returns the result."""
    mesh = None
    if ctx.world > 1:
        from reni_tpu_torch.parallel import mesh as meshlib

        mesh = meshlib.make_mesh(device=ctx.device)
    return training.run(ctx, sys.modules[__name__], mesh)
