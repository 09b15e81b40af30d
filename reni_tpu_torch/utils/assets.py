"""Dataset / pretrained-model asset management: the port's copy of
``reni_tpu/utils/assets.py``.

The reference fetches its datasets and model zoo from Google Drive via gdown
(reference src/data/datasets.py:31-41,117-127; src/utils/utils.py:93-103;
setup.py:5-11). This build runs without network access, so the same entry
points resolve strictly locally: they verify presence and explain how to
provision, instead of downloading. ``zoo_models`` / ``zoo_default`` /
``zoo_checkpoint`` discover the committed zoo (``data/Zoo``) as the JAX
package does.

Also carries the reference's device-selection helper (utils.py:9-28):
``select_device`` reports the torch device the port's entry points resolve
(``utils/device.py``).
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from reni_tpu_torch.utils.device import resolve_device

DATASET_HINTS = {
    "RENI_HDR": "the RENI HDR dataset (Train/ and Test/ folders of .exr equirectangular maps)",
    "RENI_LDR": "the RENI LDR dataset (Train/ and Test/ folders of .png equirectangular maps)",
}


def download_data(config) -> None:
    """API-parity hook for the reference's prepare_data (datasets.py:161-166).

    Verifies the configured dataset exists locally; raises with provisioning
    instructions otherwise (no network access is assumed)."""
    name = config.DATASET.NAME
    path = config.DATASET[name].PATH
    if name == "CUSTOM" or os.path.isdir(path):
        return
    hint = DATASET_HINTS.get(name, "the dataset")
    raise FileNotFoundError(
        f"dataset path {path!r} not found. Place {hint} there (the reference "
        "implementation's setup.py documents the published Google Drive "
        "archives), or point DATASET.{name}.PATH at an existing copy."
    )


def bundled_zoo_dir() -> str | None:
    """Path of the committed model zoo (``data/Zoo``), or None: resolved
    relative to the repository checkout; absent in a bare wheel install."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    zoo = os.path.join(root, "data", "Zoo")
    return zoo if os.path.isdir(zoo) else None


def zoo_models() -> dict:
    """name -> directory of every bundled pretrained model. Each directory
    holds ``checkpoint.npz`` (decoder + fitted latents,
    ``train.checkpoint.load_checkpoint``), ``latents_test.npz``, a
    ``decoder.jaxexport`` (the JAX package's serving artifact; the port
    exports its own with ``cli/export.py``) and ``config.yaml`` (the exact
    training recipe)."""
    zoo = bundled_zoo_dir()
    if zoo is None:
        return {}
    return {
        name: os.path.join(zoo, name)
        for name in sorted(os.listdir(zoo))
        if os.path.isfile(os.path.join(zoo, name, "checkpoint.npz"))
    }


def zoo_default() -> str | None:
    """Name of the best bundled prior: the entry whose ``eval.json`` has the
    highest test PSNR. Entries without an eval card rank last; ties and the
    no-eval fallback resolve alphabetically. None when the zoo is absent."""
    models = zoo_models()
    if not models:
        return None

    def psnr(item):
        name, d = item
        try:
            with open(os.path.join(d, "eval.json")) as f:
                return float(json.load(f).get("psnr_mean", float("-inf")))
        except (OSError, ValueError, TypeError):
            # TypeError: a card with "psnr_mean": null ranks last, not crash
            return float("-inf")

    return max(sorted(models.items()), key=psnr)[0]


def zoo_checkpoint(name: str) -> str:
    """Checkpoint path of a bundled model; raises with the available names."""
    models = zoo_models()
    if name not in models:
        raise FileNotFoundError(
            f"no bundled model {name!r}; available: {sorted(models)} "
            "(data/Zoo in the repo checkout)"
        )
    return os.path.join(models[name], "checkpoint.npz")


def download_pretrained_models(output_path: str) -> None:
    """API-parity hook for utils.py:93-103; local-only: copies the bundled
    zoo into ``output_path``, or raises with instructions when neither
    exists."""
    if os.path.isdir(output_path) and os.listdir(output_path):
        return
    models = zoo_models()
    if models:
        os.makedirs(output_path, exist_ok=True)
        for name, src in models.items():
            shutil.copytree(src, os.path.join(output_path, name), dirs_exist_ok=True)
        return
    raise FileNotFoundError(
        f"no pretrained models at {output_path!r} and no bundled zoo found. "
        "Convert reference checkpoints with "
        "reni_tpu_torch.utils.convert.load_reference_checkpoint, or train with "
        "reni_tpu_torch.cli.run."
    )


def select_device(device=None):
    """The reference shells out to nvidia-smi to pick the freest GPU
    (utils.py:9-28); here the device is the one the port's entry points
    resolve (``utils/device.py``: the card unless ``device`` says "cpu").
    Prints and returns it."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    print(f"Using {dev.type}: {name}")
    return dev
