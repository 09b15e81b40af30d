"""A run at a tiny size on the CPU (the look for a card skipped) with the
timed path broken underneath must come out not correct against the cell's
committed limits, once for each fault a training cell can have; and the
control, the reference in fp8 put in the program's place, must fail them.
The readings at the cells' own sizes come from the card
(``python3 -m portbench.readings``, PERF.md)."""

import copy
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness
from portbench.reference import compare, reni

CELLS = ["reni_cbc_5x256.fit_decoder", "reni_film_5x256.fit_decoder",
         "reni_cbc_5x256.fit_inverse"]


def tiny(workload: str, traffic: str | None = None) -> dict:
    """The cell at a size the CPU holds; ``traffic`` replaces its mix."""
    cell = copy.deepcopy(harness.cell(harness.spec(), workload))
    if traffic:
        cell["traffic"] = harness.load_json(harness.HERE / "traffic" / f"{traffic}.json")
    if cell["traffic"]["task"] == "fit_inverse":
        cell["traffic"].update(resolution=[8, 16], epochs_per_call=2)
        cell["config"]["tasks"]["FIT_INVERSE"]["RENDER_RESOLUTION"] = 16
    else:
        ranks = cell["traffic"]["ranks"]
        cell["config"]["model"].update(hidden_features=64, latent_dim=6, hidden_layers=2,
                                       mapping_features=32, mapping_layers=2)
        cell["traffic"].update(maps=12 * ranks, resolution=[8, 16], batch_per_rank=4)
    return cell


def run_tiny(cell: dict) -> dict:
    import importlib

    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']['task']}")
    torch.manual_seed(0)
    ctx = types.SimpleNamespace(cell=cell, seed=2**33 + 11, seconds=0.3, trace=0,
                                device=torch.device("cpu"), t_start=time.time(), rank=0, world=1)
    return driver.run(ctx)


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the backward runs, the
    optimizer never steps."""
    from reni_tpu_torch.train import tasks

    def update(state, loss, metrics, view):
        state.optimizer.zero_grad()
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    monkeypatch.setattr(tasks, "_update", update)


def _half(monkeypatch):
    """Half of each batch left out (masked) and the mean taken over the
    rest (the loss scaled by the batch over the rows kept)."""
    from reni_tpu_torch.train import tasks

    make, update = tasks.make_batches, tasks._update

    def batches(n, b):
        idx, mask = make(n, b)
        mask = mask.copy()
        mask[:, max(1, b // 2):] = 0.0
        return idx, mask

    def scaled(state, loss, metrics, view):
        return update(state, loss * 2.0, metrics, view)

    monkeypatch.setattr(tasks, "make_batches", batches)
    monkeypatch.setattr(tasks, "_update", scaled)


@pytest.mark.parametrize("fault", [_unchanged, _half], ids=["unchanged", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    cell = tiny(workload)
    fault(monkeypatch)
    result = run_tiny(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_fails_the_limits(workload):
    import importlib

    cell = tiny(workload)
    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']['task']}")
    dev = torch.device("cpu")
    ref = driver.reference(cell, 5, dev)
    ctl = driver.reference(cell, 5, dev, quant=reni.fp8_matmul)
    ok, checks = harness.judge(compare.training_numbers(ctl, ref), cell["limits"])
    assert not ok, checks


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, 0.1])
    q = reni._fp8(x, torch.float8_e4m3fn)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] == 1.0  # 1 + 1/16 rounds to 1
    assert abs(float(q[3]) - 0.1) / 0.1 < 2**-4


def test_fp8_matmul_gradients_have_the_operands_shapes():
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((2, 5, 4), generator=gen, requires_grad=True)
    w = torch.randn((4, 3), generator=gen, requires_grad=True)
    y = reni.fp8_matmul(h, w)
    torch.testing.assert_close(y, h @ w, rtol=0.2, atol=0.2)
    y.sum().backward()
    assert h.grad.shape == h.shape and w.grad.shape == w.shape
    torch.testing.assert_close(w.grad, h.detach().sum((0, 1))[:, None].expand(4, 3),
                               rtol=0.2, atol=0.3)


@pytest.mark.parametrize("fault, correct", [("none", True), ("exchange", False)])
def test_four_ranks_without_the_exchange_are_not_correct(fault, correct, tmp_path):
    """The four-card traffic (``traffic/fit_decoder_dp4.json``, not a cell
    yet: PERF.md section 7) on four gloo ranks of the CPU, its rendezvous
    through a file, judged by the one-card cell's limits: as it is its tiny
    run holds them, and with the exchange between the ranks left out it
    does not."""
    procs = [subprocess.Popen([sys.executable, "-m", "portbench.tests.ranks_worker", str(r),
                               str(tmp_path / "rdv"), fault],
                              cwd=harness.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="4",
                                                 RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0, 0], outs[0][1][-3000:]
    result = json.loads(outs[0][0].strip().splitlines()[-1])
    assert result["compared"]["ranks"] == 4
    assert result["correct"] is correct, result["checks"]
