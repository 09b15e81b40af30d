"""FIT_DECODER's first optimizer steps in plain PyTorch: sequential batches
of the maps, the VAD latents sampled with the task's host noise, the
weighted MSE of the decode plus the weighted KLD, the gradient of every
leaf, Adam with the exponential schedule. Float32, TF32 off, rows in blocks
(each map's terms are a sum, so the blocks' gradients add up exactly)."""

from __future__ import annotations

import torch

from portbench.reference import reni


def follow(model: dict, task: dict, params0: dict, maps: torch.Tensor, noise_gen: torch.Generator,
           *, steps: int, batch: int, steps_per_epoch: int, width: int, block: int = 25,
           quant=None, half: bool = False) -> dict:
    """The reference's ``steps`` updates from ``params0`` (copied) on
    batches ``maps[s * batch:(s + 1) * batch]``. Returns {"losses": per step,
    "grad": the first step's gradient, "change": each leaf's change after
    the steps}, both {leaf path: tensor}. ``quant`` computes the trunk's
    products from narrower inputs (the control); ``half`` keeps the first
    half of each batch and scales its terms to the whole (a fault)."""
    if steps > steps_per_epoch:
        raise ValueError(f"{steps} compared steps need as many batches of distinct rows, "
                         f"an epoch has {steps_per_epoch}")
    reni.no_tf32()
    dev = maps.device
    N = model["latent_dim"]
    D = reni.directions(width, dev).to(maps.dtype)
    sw = reni.sineweight(width, dev).to(maps.dtype)
    leaves0 = reni.flatten(params0)
    leaves = {k: v.detach().clone() for k, v in leaves0.items()}
    adam = reni.Adam(leaves, task["beta1"], task["beta2"])
    lr = reni.exp_schedule(task["lr_start"], task["lr_end"], task["epochs"], steps_per_epoch)
    kept = batch // 2 if half else batch
    out = {"losses": []}
    for s in range(steps):
        noise = reni.noise_draws(noise_gen, (batch, N, 3), maps.dtype).to(dev)
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total = 0.0
        for r0 in range(0, kept, block):
            r1 = min(r0 + block, kept)
            rows = slice(s * batch + r0, s * batch + r1)
            live = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
            tree = reni.unflatten_like(params0, live)
            mu, lv = tree["latents"]["mu"][rows], tree["latents"]["log_var"][rows]
            Z = mu + noise[r0:r1] * torch.exp(0.5 * lv)
            pred = reni.decode(model, tree["decoder"], Z, D, quant)
            loss = (reni.weighted_mse(pred, maps[rows], sw)
                    + task["kld_weighting"] * reni.kld(mu, lv, 3 * N)) * (batch / kept)
            got = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
            for k, g in zip(live, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach().double())
        out["losses"].append(total)
        if s == 0:
            out["grad"] = {k: g.clone() for k, g in grads.items()}
        adam.step(grads, lr(s))
    out["change"] = {k: leaves[k] - leaves0[k] for k in leaves}
    return out
