"""Optimisers and LR schedules (counterpart of ``reni_tpu/train/optim.py``),
with optax's semantics.

- Adam with the configured betas and eps 1e-8 (``torch.optim.Adam``), sgd
  with optional momentum (``torch.optim.SGD``: optax's ``trace`` is the same
  update), and adagrad as optax writes it (``Adagrad`` below: a starting
  accumulator of 0.1 and eps inside the square root, where torch's adagrad
  starts at 0 and adds eps outside).
- The LR of update t is the schedule at t, the count of earlier updates
  (optax's ``scale_by_schedule``): ``ScheduledOptimizer`` sets it before
  each step. The exponential schedule decays per epoch, staircase:
  ``gamma = exp(log(lr_end / lr_start) / epochs)``; its values are float32,
  as optax's are.
- The trainable/frozen partition is ``requires_grad`` on the leaves that
  ``RENIModel.trainable_mask`` selects; only those reach the optimizer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Per-task optimisation hyperparameters (configs/default.py:24-52)."""

    lr_start: float = 1e-5
    lr_end: float = 1e-7
    optimizer: str = "adam"
    beta1: float = 0.0
    beta2: float = 0.999
    scheduler_type: str = "exponential"
    scheduler_step_size: int = 1
    scheduler_gamma: float = 1.0
    epochs: int = 2400
    steps_per_epoch: int = 1


def _exponential_decay(init_value: float, transition_steps: int, decay_rate: float):
    """optax.exponential_decay(..., staircase=True) at a Python step count.
    Like optax, the value is float32: init * rate ** floor(count / steps)
    with torch's float32 pow, which gives optax's values bit for bit."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    init = torch.tensor(init_value, dtype=torch.float32)
    rate = torch.tensor(decay_rate, dtype=torch.float32)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(init)
        p = torch.tensor(float(count // transition_steps), dtype=torch.float32)
        return float(init * rate**p)

    return schedule


def build_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """LR as a function of the global step (scheduler stepped per epoch)."""
    if cfg.scheduler_type == "exponential":
        gamma = math.exp(math.log(cfg.lr_end / cfg.lr_start) / cfg.epochs)
        return _exponential_decay(cfg.lr_start, cfg.steps_per_epoch, gamma)
    if cfg.scheduler_type == "step":
        return _exponential_decay(
            cfg.lr_start, cfg.steps_per_epoch * cfg.scheduler_step_size,
            cfg.scheduler_gamma,
        )
    return lambda _: cfg.lr_start  # "none" / plateau: constant


class Adagrad(torch.optim.Optimizer):
    """optax.adagrad: s += g^2; p -= lr * g / sqrt(s + eps) where s > 0,
    with s starting at ``initial_accumulator_value``."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                s = state["sum"]
                s.add_(p.grad * p.grad)
                inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.sub_(group["lr"] * (inv * p.grad))


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose LR follows ``schedule(count)``, count
    being the number of earlier updates (optax's step count). ``names`` are
    the checkpoint paths of its parameters, in their order
    (``train/checkpoint.py`` stores the state under them)."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 names: list[str] | None = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0
        self.names = names

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def build_optimizer(cfg: OptimConfig, params, names: list[str] | None = None
                    ) -> ScheduledOptimizer:
    """The optimizer of ``cfg`` over ``params`` (an iterable of tensors, whose
    checkpoint paths are ``names``)."""
    schedule = build_schedule(cfg)
    params = list(params)
    lr = schedule(0)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.beta1)
    elif cfg.optimizer == "adagrad":
        opt = Adagrad(params, lr=lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return ScheduledOptimizer(opt, schedule, names)


# ---------------------------------------------------------------------------
# trainable / frozen partition
# ---------------------------------------------------------------------------


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def partition_params(params, mask):
    """(trainable, frozen) trees of ``params``'s structure: a leaf sits in one
    of them and is None in the other."""
    trainable = _map2(lambda p, m: p if m else None, params, mask)
    frozen = _map2(lambda p, m: None if m else p, params, mask)
    return trainable, frozen


def merge_params(trainable, frozen):
    return _map2(lambda t, f: t if t is not None else f, trainable, frozen)

