"""Export a trained decoder checkpoint as a serving artifact.

    python -m reni_tpu_torch.cli.export --checkpoint runs/.../fit_decoder_final \
        --out decoder.pt2 [--device cuda]

The counterpart of ``reni_tpu/cli/export.py``. The artifact is a
``torch.export`` program of the plain decoder with symbolic batch and pixel
dimensions: a serving process loads it with
``reni_tpu_torch.serve.load_exported`` (or ``torch.export.load``) and
decodes any resolution without the model code; ``cli/serve.py --artifact``
serves it. ``--device`` is the device it is traced on (default the card),
where JAX's takes ``--platforms``; the artifact runs on either device once
its weights are moved (reni_tpu_torch/serve.py).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True, help="checkpoint path (.npz base)")
    parser.add_argument("--out", required=True, help="output artifact path (.pt2)")
    parser.add_argument("--device", default="cuda", help="device to trace on: cuda (default) or cpu")
    args = parser.parse_args(argv)

    from reni_tpu_torch.serve import export_from_checkpoint

    cfg = export_from_checkpoint(args.checkpoint, args.out, device=args.device)
    print(
        f"exported {cfg.model_type}/{cfg.conditioning}/{cfg.equivariance} "
        f"N={cfg.latent_dim} {cfg.hidden_layers}x{cfg.hidden_features} -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
