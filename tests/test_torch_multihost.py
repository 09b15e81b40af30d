"""Multi-process runs of the port (reni_tpu_torch/parallel/multihost.py and
the trainer's WORLD_SIZE > 1 path in cli/run.py) on the CPU: two gloo ranks
a run (tests/torch_multihost_worker.py), each with its own one thread, the
rendezvous through a file. Mirrors tests/test_multihost.py.

- the helpers: rank 0's string, flag and version_N adopted by both ranks,
  the largest of the ranks' values (the RSS exit's reading),
  rank 0's checkpoint files sent to a rank that has no copy, barriers, and
  ``barrier_timeout`` returning False when the other rank never joins;
- the trainer as a 2-process cluster on a 2 x 1 mesh with sharded latent
  tables and image grids (tests/test_multihost.py::
  test_cli_two_process_cluster): one run directory, rank 0 alone writes,
  the chain completes, the losses match one process's (rtol 2e-4);
- ``RENI_TPU_CKPT_WALL_S`` set on rank 0 only: rank 0's value is adopted,
  so both ranks make the same segments (one epoch each) and the run ends;
  a per-rank read would segment the ranks differently and mispair their
  collectives;
- the chain killed on both ranks after its first checkpoint (FIT_DECODER
  epoch 2 of 8, mid-stage) and relaunched with ``--resume``: its finals
  equal the uncut 2-rank chain's bit for bit; and a crash on both ranks
  that ``--retries 1`` recovers in the process: both ranks meet at the
  retry rendezvous, adopt rank 0's resume plan and end at the same bits.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from reni_tpu_torch.cli import run as trun
from reni_tpu_torch.utils.config import get_cfg_defaults
from torch_ranks import ROOT, Ranks

WORKER = str(ROOT / "tests" / "torch_multihost_worker.py")
RUN_S = 180  # time limit of each 2-rank run


def _config(data: str, runs: str):
    """tests/test_multihost.py::test_cli_two_process_cluster's config, with
    a checkpoint every 2 epochs."""
    cfg = get_cfg_defaults()
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT"]
    cfg.RENI.CONDITIONING = "Cond-by-Concat"
    cfg.RENI.LATENT_DIMENSION = 4
    cfg.RENI.HIDDEN_LAYERS = 1
    cfg.RENI.HIDDEN_FEATURES = 16
    cfg.RENI.OUTPUT_ACTIVATION = "None"
    for task in ("FIT_DECODER", "FIT_LATENT"):
        t = cfg.RENI[task]
        t.EPOCHS = 8
        t.BATCH_SIZE = 4
        t.MULTI_RES_TRAINING = True
        t.INITAL_RESOLUTION = [8, 16]
        t.FINAL_RESOLUTION = [16, 32]
        t.CURRICULUM = [4]
        t.LR_START = 1e-3
        t.LR_END = 1e-4
    cfg.TPU.SHARD_LATENTS = True  # 5 train rows on a data axis of 2: padded to 6
    cfg.DATASET.NAME = "RENI_LDR"
    cfg.DATASET.RENI_LDR.PATH = data
    cfg.DATASET.RENI_LDR.TRANSFORMS = [["normalize", [[0.5] * 3, [0.5] * 3]]]
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 2
    cfg.TRAINER.LOGGER.LOG_IMAGES = True
    cfg.TRAINER.LOGGER.EPOCHS_BETWEEN_EXAMPLES = 4
    cfg.TRAINER.LOGGER.NUMBER_OF_IMAGES = 2
    cfg.TRAINER.LOGGER_TYPE = "none"
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = runs
    return cfg


def _write(cfg, path) -> str:
    path.write_text(json.dumps(cfg.to_dict()))
    return str(path)


def _versions(runs) -> list:
    return sorted(runs.glob("*/version_*"))


def _losses(log_dir) -> dict:
    rows = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
    return {(r["step"], k): v for r in rows if "step" in r for k, v in r.items()
            if k.endswith("_loss")}


def _finals(log_dir) -> dict:
    out = {}
    for task in ("fit_decoder", "fit_latent"):
        with np.load(log_dir / "checkpoints" / f"{task}_final.npz") as z:
            out.update({f"{task}/{k}": z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank run of the module, started together: the helpers, the
    uncut chain, the chain with RENI_TPU_CKPT_WALL_S on rank 0 only, and the
    chain killed after its first save (then relaunched with --resume)."""
    from PIL import Image

    work = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(0)
    for split, n in (("Train", 5), ("Test", 3)):
        d = work / "ldr" / split
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.uniform(size=(16, 32, 3)) * 255).astype(np.uint8)).save(
                str(d / f"img{i}.png"))
    data = str(work / "ldr")
    for r in range(2):
        (work / f"r{r}").mkdir()
    cfgs = {}
    for name in ("uncut", "wall", "killed", "retried"):
        cfgs[name] = _write(_config(data, str(work / name)), work / f"{name}.json")
    wall_cfg = _config(data, str(work / "wall"))
    wall_cfg.RENI.TASKS = ["FIT_DECODER"]
    cfgs["wall"] = _write(wall_cfg, work / "wall.json")
    launched = {
        "helpers": Ranks([WORKER, "helpers", str(work / "init_helpers"), str(work)], 2,
                         cwd=lambda r: work / f"r{r}"),
        "uncut": Ranks([WORKER, "cli", str(work / "init_uncut"), cfgs["uncut"]], 2),
        "wall": Ranks([WORKER, "cli", str(work / "init_wall"), cfgs["wall"]], 2,
                      env=lambda r: {"RENI_TPU_CKPT_WALL_S": "1e-6"} if r == 0 else {}),
        "killed": Ranks([WORKER, "cli", str(work / "init_killed"), cfgs["killed"], "1"], 2),
        "retried": Ranks([WORKER, "cli", str(work / "init_retried"), cfgs["retried"], "-3", "--",
                          "--retries", "1"], 2),
    }
    done: dict = {}

    def result(name):
        if name not in done:
            if name == "resumed":
                outs = launched["killed"].wait(RUN_S)
                assert [rc for rc, _ in outs] == [17, 17], outs
                (killed,) = _versions(work / "killed")
                launched["resumed"] = Ranks([WORKER, "cli", str(work / "init_resumed"),
                                             cfgs["killed"], "0", "--", "--resume",
                                             str(killed)], 2)
            done[name] = launched[name].check(RUN_S)
        return work, cfgs, done[name]

    yield result
    for procs in launched.values():
        for p in procs.procs:
            if p.poll() is None:
                p.kill()


def test_helpers_over_two_ranks(runs):
    work, _, _ = runs("helpers")
    got = [json.load(open(work / f"helpers_{r}.json")) for r in range(2)]
    for r, g in enumerate(got):
        assert g["world"] == 2 and g["primary"] == (r == 0)
        assert g["str"] == "plan of rank 0" and g["flag"] is True
        assert g["path"] == "runs/exp/version_3"
        assert g["unversioned"] == f"runs/exp_{r}"  # no version_N: each keeps its own
        assert g["largest"] == [3.5, 0.0]  # each entry's largest: rank 1's, rank 0's
        assert g["npz"] and g["json"] == {"epoch": 7}
        assert g["both_join"] is True
    # rank 1 (its own working directory) received rank 0's files
    assert (work / "r1" / "ck" / "best.npz").read_bytes() == bytes(range(256)) * 41
    assert got[0]["alone"] is False and 1.0 <= got[0]["alone_s"] < 30.0


def test_cli_two_process_cluster(runs, tmp_path):
    """One run directory; rank 0 alone wrote metrics (one row an epoch and
    task, as one process writes them), checkpoints and both tasks' image
    grids; the losses match a single-process run of the same config."""
    work, cfgs, _ = runs("uncut")
    (v,) = _versions(work / "uncut")
    mp = _losses(v)
    assert any(k.startswith("fit_latent") for _, k in mp)
    assert len(sorted((v / "checkpoints").glob("*final*"))) == 4
    imgs = sorted((v / "images").glob("*.png"))
    assert any("fit_decoder" in p.name for p in imgs) and any("fit_latent" in p.name for p in imgs)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(cfgs["uncut"])
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / "single")
    _, log_dir = trun.main(cfg, device="cpu")
    sp = _losses(type(v)(log_dir))
    assert sp.keys() == mp.keys()
    for key, val in sp.items():
        np.testing.assert_allclose(mp[key], val, rtol=2e-4, err_msg=str(key))
    rows = [json.loads(line) for line in open(v / "metrics.jsonl")]
    single = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert len(rows) == len(single)


def test_wall_target_on_rank_zero_only_is_agreed(runs):
    """RENI_TPU_CKPT_WALL_S=1e-6 on rank 0 alone: both ranks take rank 0's
    value, so every segment is one epoch (a callback, logged, each epoch)
    and the run ends on both ranks (a per-rank read leaves rank 1 on
    segments of 2 epochs and the collectives mispaired)."""
    work, _, _ = runs("wall")
    (v,) = _versions(work / "wall")
    steps = [r["step"] for r in map(json.loads, open(v / "metrics.jsonl")) if "step" in r]
    assert steps == list(range(1, 9))


def test_killed_chain_resumed_equals_the_uncut_chain(runs):
    """Both ranks end after the first save (FIT_DECODER epoch 2, mid-stage);
    the same 2-rank command with --resume <its run dir> ends at the uncut
    chain's finals bit for bit."""
    work, _, _ = runs("uncut")
    runs("resumed")
    (uncut,) = _versions(work / "uncut")
    killed, resumed = _versions(work / "killed")
    with open(killed / "checkpoints" / "fit_decoder_latest.json") as f:
        assert json.load(f)["epoch"] == 2
    a, b = _finals(uncut), _finals(resumed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_retried_chain_agrees_on_the_plan_and_equals_the_uncut_chain(runs):
    """Both ranks raise after the third save (FIT_DECODER epoch 6); with
    --retries 1 they meet at the retry rendezvous, take rank 0's plan (resume
    from epoch 6 in the same run directory) and end at the uncut chain's
    finals bit for bit; rank 0 logged one retry event."""
    work, _, outs = runs("retried")
    runs("uncut")
    (uncut,) = _versions(work / "uncut")
    (retried,) = _versions(work / "retried")
    for out in outs:
        assert "[retry 1/1] resuming tasks=['FIT_DECODER', 'FIT_LATENT']" in out
    events = [r for r in map(json.loads, open(retried / "metrics.jsonl")) if "event" in r]
    assert [e["event"] for e in events] == ["retry"]
    a, b = _finals(uncut), _finals(retried)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
