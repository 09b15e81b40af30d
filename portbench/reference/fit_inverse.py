"""FIT_INVERSE's first optimizer steps in plain PyTorch: the frozen decoder
decodes the latents, the maps are unnormalised and render the scene
(``scene.shade``), the loss is the render MSE, the prior on the latents and
the cosine over the render's rows, and Adam moves the latents. Float32,
TF32 off. The ground-truth renders are made here again from the maps."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import reni, scene as scene_lib


def load_decoder(path: str, device) -> dict:
    """The decoder tree of a checkpoint's ``.npz`` (keys ``decoder/...``)."""
    flat = {}
    with np.load(path + ".npz") as z:
        for k in z.files:
            if k.startswith("decoder/"):
                flat[k[len("decoder/"):]] = torch.as_tensor(z[k], device=device)
    tree: dict = {"layers": []}
    n = 1 + max(int(k.split("/")[1]) for k in flat if k.startswith("layers/"))
    tree["layers"] = [{"w": flat[f"layers/{i}/w"], "b": flat[f"layers/{i}/b"]} for i in range(n)]
    tree["final"] = {"w": flat["final/w"], "b": flat["final/b"]}
    return tree


def cosine_rows(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Cosine similarity along axis 1 (the render's rows), (B, W, 3)."""
    dot, aa, bb = (a * b).sum(1), (a * a).sum(1), (b * b).sum(1)
    return dot / (torch.clamp(aa.sqrt(), min=eps) * torch.clamp(bb.sqrt(), min=eps))


def follow(model: dict, task: dict, decoder: dict, mu0: torch.Tensor, maps: torch.Tensor,
           scene: scene_lib.Scene, *, steps: int, width: int, minmax, quant=None,
           half: bool = False) -> dict:
    """``steps`` updates of the latents ``mu0`` (B, N, 3) towards the
    renders of ``maps`` (B, P, 3), normalised. Returns {"losses", "grad",
    "change"} ({"latents/mu": tensor}). ``quant``: the control's narrower
    products; ``half``: the first half of the batch kept, its terms scaled
    to the whole (a fault)."""
    reni.no_tf32()
    dev = maps.device
    D = reni.directions(width, dev).to(maps.dtype)
    sw = reni.sineweight(width, dev).to(maps.dtype)
    kd = task["kd"]
    with torch.no_grad():
        gt = scene_lib.shade(scene, D[0], reni.unnormalise(maps, minmax) * sw, kd=kd)
    B = maps.shape[0]
    kept = max(1, B // 2) if half else B
    mu = mu0.detach().clone()
    adam = reni.Adam({"latents/mu": mu}, task["beta1"], task["beta2"])
    lr = reni.exp_schedule(task["lr_start"], task["lr_end"], task["epochs"], 1)
    out = {"losses": []}
    for s in range(steps):
        Z = mu[:kept].detach().requires_grad_(True)
        env = reni.unnormalise(reni.decode(model, decoder, Z, D, quant), minmax)
        render = scene_lib.shade(scene, D[0], env * sw, kd=kd)
        g = gt[:kept]
        mse = ((render - g) ** 2).mean()
        prior = task["prior"] * (Z**2).sum() * (B / kept)
        cos = task["cosine"] * (1.0 - cosine_rows(render, g).reshape(kept, -1).mean(1)).sum() / kept
        loss = mse + prior + cos
        (grad,) = torch.autograd.grad(loss, [Z])
        full = torch.zeros_like(mu)
        full[:kept] = grad
        out["losses"].append(float(loss.detach().double()))
        if s == 0:
            out["grad"] = {"latents/mu": full.clone()}
        adam.step({"latents/mu": full}, lr(s))
    out["change"] = {"latents/mu": mu - mu0}
    return out
