"""Evaluation CLI: the BASELINE.md protocol on a trained checkpoint.

    python -m reni_tpu_torch.cli.evaluate --checkpoint data/Zoo/<entry>/latents_test \
        --cfg_path configs/experiment.yaml [--mask data/Masks/Mask-3.png] \
        [--device cuda]

The counterpart of ``reni_tpu/cli/evaluate.py``: prints the same JSON report
under the same keys. Test-set reconstruction PSNR and SSIM, the rotation
equivariance eval (latent rotation against the rolled ground truth), with a
mask the in-painting observed / hallucinated PSNR, and for a FIT_INVERSE
checkpoint the recovery through the renderer of the config's FIT_INVERSE
scene. It runs on the card unless ``--device cpu`` is given. On the card it
holds the chip lock (``utils/chiplock.py``), as the JAX CLI does: its
decodes must not timeshare the card with a timed run.

``--cfg_path`` is a YAML file (read with PyYAML) or a JSON one (read with
the standard library); its DATASET block names the maps.
"""

from __future__ import annotations

import argparse
import json
import os

from reni_tpu_torch import eval as ev
from reni_tpu_torch.core import sphere
from reni_tpu_torch.data.datasets import get_dataset
from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.params import from_numpy
from reni_tpu_torch.train import checkpoint as ckpt
from reni_tpu_torch.utils import chiplock
from reni_tpu_torch.utils.config import get_cfg_defaults
from reni_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--cfg_path", default=None)
    ap.add_argument("--split", default="Test")
    ap.add_argument("--resolution", type=int, nargs=2, default=[64, 128])
    ap.add_argument("--mask", default=None)
    ap.add_argument("--rotation_columns", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with chiplock.hold_chip_lock(chiplock.trainer_lock_path(dev), what="cli.evaluate"):
        return _main(args, dev)


def _main(args, dev) -> dict:
    cfg = get_cfg_defaults()
    if args.cfg_path:
        cfg.merge_from_file(args.cfg_path)

    model = RENIModel(ckpt.load_model_config(args.checkpoint))
    saved, meta = ckpt.load_checkpoint(args.checkpoint)

    dname = cfg.DATASET.NAME
    dcfg = cfg.DATASET[dname]
    split_path = os.path.join(dcfg.PATH, args.split)
    if not os.path.isdir(split_path):
        split_path = dcfg.PATH
    dataset = get_dataset(dname, split_path, dcfg.TRANSFORMS, dcfg.IS_HDR)
    res = tuple(args.resolution)
    images = dataset.images_at(res, device=dev)

    rows = next(iter(saved["latents"].values())).shape[0]
    if rows != len(dataset):
        raise SystemExit(
            f"checkpoint latent table holds {rows} rows but the {args.split} split has "
            f"{len(dataset)} images — evaluate the checkpoint produced by FIT_LATENT on "
            "this split"
        )
    params = from_numpy(saved, dev)

    report = {
        "checkpoint": args.checkpoint,
        "task": meta.get("task"),
        "split": args.split,
        "resolution": list(res),
        "n_images": len(dataset),
    }
    kw = dict(unnormalise=dataset.unnormalise, is_hdr=dcfg.IS_HDR)
    report.update(ev.reconstruction_psnr(model, params, images, res, **kw))
    report["psnr_per_image"] = [float(x) for x in report["psnr_per_image"]]
    if "ssim_per_image" in report:
        report["ssim_per_image"] = [float(x) for x in report["ssim_per_image"]]
    report.update(
        ev.equivariance_eval(model, params, images, res, columns=args.rotation_columns, **kw)
    )
    if args.mask:
        mask = sphere.get_mask(res[1], args.mask, device=dev)
        report.update(ev.inpainting_eval(model, params, images, res, mask, **kw))
    if meta.get("task") == "FIT_INVERSE":
        # recovery through the renderer (the task's own observable), in the
        # scene of the config's FIT_INVERSE block
        from reni_tpu_torch.render.inverse import InverseRenderSetup
        from reni_tpu_torch.train.tasks import TaskConfig

        tc = TaskConfig.from_config(cfg, "FIT_INVERSE")
        setup = InverseRenderSetup(
            tc.object_path,
            render_resolution=tc.render_resolution,
            kd=tc.kd_value,
            azimuths=tc.azimuths,
            elevations=tc.elevations,
            device=dev,
        )
        inv = ev.inverse_recovery_eval(
            model, params, images, res, setup, unnormalise=dataset.unnormalise
        )
        inv["render_correlation_per_image"] = [
            float(x) for x in inv["render_correlation_per_image"]
        ]
        report.update(inv)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
