"""Convert checkpoints between the reference's Lightning format and the
port's (the npz + JSON files both packages read).

    # reference .ckpt (torch.save Lightning layout) -> checkpoint
    python -m reni_tpu_torch.cli.convert --from_torch model.ckpt --out ck

    # checkpoint -> Lightning-layout .ckpt (loadable by the reference's
    # RENI.load_from_checkpoint / notebook torch.load recipe)
    python -m reni_tpu_torch.cli.convert --to_torch ck --out model.ckpt

The counterpart of ``reni_tpu/cli/convert.py``, writing the files it
writes: the migration path for users of the reference's pretrained models
(reference run.py:76 ``RENI.load_from_checkpoint``, examples.ipynb cell 4
``torch.load``). The weight layout lives in ``utils/convert.py``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    g = parser.add_mutually_exclusive_group(required=True)
    g.add_argument("--from_torch", help="reference Lightning .ckpt to import")
    g.add_argument("--to_torch", help="checkpoint to export")
    parser.add_argument("--out", required=True)
    parser.add_argument(
        "--task", default=None, help="task context for the embedded config (sets fixed_decoder)"
    )
    args = parser.parse_args(argv)

    import torch

    from reni_tpu_torch.train import checkpoint as ckpt
    from reni_tpu_torch.utils import convert

    if args.from_torch:
        params, cfg = convert.load_reference_checkpoint(args.from_torch, task=args.task)
        ckpt.save_checkpoint(args.out, params, model_config=cfg,
                             metadata={"source": args.from_torch})
        print(f"imported {cfg.model_type}/{cfg.conditioning}/{cfg.equivariance} "
              f"N={cfg.latent_dim} -> {args.out}.npz")
    else:
        params, _ = ckpt.load_checkpoint(args.to_torch)
        cfg = ckpt.load_model_config(args.to_torch)
        # keys carry the Lightning "model." prefix; the config goes in the
        # reference's hyper_parameters layout so RENI.load_from_checkpoint
        # or --from_torch can rebuild the model
        torch.save({"state_dict": convert.params_to_torch_state_dict(params, cfg),
                    "hyper_parameters": {"config": convert.reference_config(cfg)}}, args.out)
        print(f"exported Lightning-layout state_dict -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
