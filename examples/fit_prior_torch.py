"""RENI as an illumination prior — the downstream-usage recipe, on the
PyTorch + CUDA port (``reni_tpu_torch``; ``examples/fit_prior.py`` is the
JAX package's copy).

The reference's examples.ipynb cell 4 ("RENI as a prior for masked
in-painting"): load a trained decoder with a fresh latent table, freeze it,
and optimise a latent for a new (possibly masked) observation with the test
loss; then decode the fitted latent, and a rotated copy of it.

    python examples/fit_prior_torch.py --checkpoint zoo \
        --image path/to/env.exr [--mask data/Masks/Mask-3.png] [--device cpu]

``--checkpoint zoo`` takes the bundled zoo's best prior (``zoo:<name>`` a
named entry). Without --checkpoint the script first trains a small decoder
on synthetic maps, so it runs end to end anywhere (``--device cpu``
included). It runs on the card unless ``--device cpu`` is given; on the card
every step decodes and back-propagates through the CUDA kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIConfig, RENIModel, replace_latents
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.train import tasks
from reni_tpu_torch.train.optim import OptimConfig
from reni_tpu_torch.utils.device import resolve_device

# the recipe's optimisation: Adam, LR 1e-1 -> 1e-2 over the steps, the test
# loss's prior and cosine weights
LR_START, LR_END, ALPHA, BETA = 1e-1, 1e-2, 1e-7, 1e-1


def demo_decoder(width: int, device):
    """Train a tiny decoder on synthetic band-limited env maps."""
    model = RENIModel(
        RENIConfig(
            model_type="VariationalAutoDecoder",
            equivariance="SO2",
            latent_dim=9,
            hidden_layers=2,
            hidden_features=64,
            output_activation=None,
        )
    )
    d = sphere.get_directions(width, device="cpu")[0].numpy()
    rng = np.random.default_rng(0)
    images = torch.tensor(
        np.stack([np.tanh(d @ rng.normal(size=(3, 3))) for _ in range(8)]).astype(np.float32),
        device=device,
    )
    params = model.init(torch.Generator().manual_seed(0), dataset_size=8, device=device)
    cfg = tasks.TaskConfig(
        task="FIT_DECODER",
        optim=OptimConfig(lr_start=1e-3, lr_end=1e-4, beta1=0.9, beta2=0.999),
        batch_size=8,
        epochs=400,
        multi_res_training=False,
        final_resolution=(width // 2, width),
    )
    params, _ = tasks.fit_task(model, params, cfg, lambda r: images,
                               torch.Generator().manual_seed(1))
    return model, params, images


def fit_latent(model: RENIModel, params, target: torch.Tensor, directions: torch.Tensor,
               sineweight: torch.Tensor, steps: int, generator: torch.Generator,
               log_every: int = 100):
    """Optimise latent 0 of ``params`` through the frozen decoder towards
    ``target`` (1, P, 3): ``steps`` FIT_LATENT updates
    (``tasks.make_fit_latent_step``) at the recipe's constants. Returns
    (params, per-step losses as a numpy array, seconds of the first step,
    seconds of the others); the first step pays the kernels' first loads."""
    optim = OptimConfig(lr_start=LR_START, lr_end=LR_END, epochs=steps, steps_per_epoch=1)
    state = tasks.init_train_state(model, params, optim, generator)
    step = tasks.make_fit_latent_step(model, directions, sineweight, alpha=ALPHA, beta=BETA)
    dev = target.device
    batch = (target, torch.zeros(1, dtype=torch.long, device=dev),
             torch.ones(1, dtype=target.dtype, device=dev))
    losses, clock = [], [time.perf_counter()]
    for i in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        if log_every and i % log_every == 0:
            print(f"step {i}: loss={float(metrics['loss']):.5f}")
        if i == 0:
            losses[0] = losses[0].cpu()  # waits for the first step
            clock.append(time.perf_counter())
    losses = torch.stack([t.cpu() for t in losses]).numpy()  # waits for the last
    clock.append(time.perf_counter())
    return state.params, losses, clock[1] - clock[0], clock[-1] - clock[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--checkpoint", default=None,
        help="trained decoder checkpoint; 'zoo' or 'zoo:<name>' resolves "
        "the bundled pretrained zoo (data/Zoo)",
    )
    ap.add_argument("--image", default=None, help="target env map (.exr/.hdr/.png)")
    ap.add_argument("--mask", default=None, help="binary mask PNG (1=observed)")
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, dev):
    """The fit that ``args`` asks for, on ``dev``: (model with a frozen
    decoder and one fresh latent, params, target (1, P, 3), directions,
    sine weight times the mask). The same ``args`` give the same tensors."""
    width = args.width
    checkpoint = args.checkpoint
    if checkpoint and checkpoint.split(":", 1)[0] == "zoo":
        from reni_tpu_torch.utils import assets

        _, _, name = checkpoint.partition(":")
        if not name:
            # bare "zoo" resolves to the best measured prior (highest
            # test-PSNR eval card), not the alphabetical first
            name = assets.zoo_default()
            if name is None:
                raise FileNotFoundError("no bundled zoo in this checkout")
        checkpoint = assets.zoo_checkpoint(name)
        print(f"using bundled zoo model {name}: {checkpoint}")
    # --- 1. a trained, frozen decoder ------------------------------------
    if checkpoint:
        cfg = ckpt.load_model_config(checkpoint, fixed_decoder=True)
        model = RENIModel(cfg)
        params = ckpt.load_decoder_only(checkpoint, model, 1,
                                        torch.Generator().manual_seed(0), dev)
        target = None
    else:
        base_model, base_params, images = demo_decoder(width, dev)
        model = RENIModel(RENIConfig(**{**base_model.config.__dict__, "fixed_decoder": True}))
        params = replace_latents(model, base_params, torch.Generator().manual_seed(2), 1, dev)
        target = images[:1]  # pretend the first training image is "new"

    # --- 2. the observation ------------------------------------------------
    if args.image:
        from reni_tpu_torch.data.datasets import read_hdr, read_ldr
        from reni_tpu_torch.data.transforms import resize_bilinear

        reader = read_hdr if args.image.lower().endswith((".exr", ".hdr")) else read_ldr
        img = resize_bilinear(reader(args.image), width // 2, width)
        target = torch.tensor(img.reshape(1, -1, 3), device=dev)
    assert target is not None, "--image required with --checkpoint"

    sineweight = sphere.get_sineweight(width, device=dev)
    if args.mask:
        sineweight = sineweight * sphere.get_mask(width, args.mask, device=dev)
    return model, params, target, sphere.get_directions(width, device=dev), sineweight


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, params, target, directions, sineweight = setup(args, dev)

    # --- 3. optimise only the latent code through the frozen decoder ------
    params, losses, first_s, rest_s = fit_latent(model, params, target, directions, sineweight,
                                                 args.steps, torch.Generator().manual_seed(3))
    rest = f", then {rest_s * 1e3 / (args.steps - 1):.3f} ms a step" if args.steps > 1 else ""
    print(f"{args.steps} steps on {dev.type}: the first {first_s:.3f} s{rest}; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}")

    # --- 4. decode the fitted latent anywhere on the sphere ----------------
    with torch.no_grad():
        Z = model.latents(params, [0])
        recon = model.apply(params, Z, directions)
        print(f"final mean abs error: {float((recon - target).abs().mean()):.4f}")

        # rotation equivariance: rotating the latent rotates the illumination
        r = torch.tensor(sphere.rotation_y(np.pi / 4).astype(np.float32), device=dev)
        rotated = model.apply(params, Z @ r, directions)
    print(f"decoded rotated illumination: {tuple(rotated.shape)}")


if __name__ == "__main__":
    main()
