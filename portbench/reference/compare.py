"""The numbers a training cell's ``correct`` compares: the program's first
steps against the reference's steps from the same state.

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: likewise for each leaf's change after the steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both (Adam would move them by round-off alone). The inputs
are per-leaf norms, so a rank's state compares without its tensors."""

from __future__ import annotations

import statistics

GRAD_FLOOR = 1e-3


def leaf_norms(tree: dict) -> dict:
    """{name: float64 norm} of a {name: tensor} dict."""
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def _worst(prog: dict, ref: dict, names: list) -> tuple[float, str]:
    med = statistics.median(ref[k] for k in names)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}}. Returns the three gaps, the leaves that set them and the leaves
    left out."""
    med = statistics.median(ref["grad"].values())
    kept = [k for k, v in ref["grad"].items() if v >= GRAD_FLOOR * med]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = _worst(prog["grad"], ref["grad"], kept)
    change_gap, change_leaf = _worst(prog["change"], ref["change"], kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - set(kept))}
