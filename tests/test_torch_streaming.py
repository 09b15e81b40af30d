"""The port's out-of-core data path on the CPU (ROADMAP A-9): the lazy dataset
(``data/datasets.py``: ``lazy=True``, ``DiskRowSource``), the streaming
runner (``train/tasks.py::streaming_stage_runner`` behind
``fit_task(stream=True)``) and the trainer's ``TPU.STREAM_*`` keys.

Streaming changes where the images live, never what a step sees: every
streamed run here is held bit for bit to the resident ``fit_task`` on the
same values (host and disk sources, chunk 1 and chunk K, a ragged tail,
re-augmentation, a cut and resumed run); bf16 streaming bit for bit to the
resident tier on bf16-rounded targets; and once against the JAX package's
streamed ``fit_task`` from its own lazy dataset at float64 (epoch 0 to
1e-12). The maps are seed-1 skies written by ``data/synthetic.py``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reni_tpu.cli import run as jrun
from reni_tpu.data import datasets as jd
from reni_tpu.models.reni import RENIConfig as JConfig
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import optim as joptim
from reni_tpu.train import tasks as jtasks
from reni_tpu_torch import params as tparams
from reni_tpu_torch.cli import run as trun
from reni_tpu_torch.data import datasets as td
from reni_tpu_torch.data import exr as te
from reni_tpu_torch.data import synthetic
from reni_tpu_torch.models.reni import RENIConfig, RENIModel
from reni_tpu_torch.parallel import mesh as pmesh
from reni_tpu_torch.train import checkpoint as tck
from reni_tpu_torch.train import optim as toptim
from reni_tpu_torch.train import tasks as ttasks
from reni_tpu_torch.utils.config import get_cfg_defaults

PUBLISHED = [["minmaxnormalise", [-18.0536, 11.4633]]]  # configs/zoo_synthetic.yaml
RES = ((8, 16), (16, 32))  # the two stages of the tasks below; 16 x 32 is the files' size


@pytest.fixture(scope="module")
def skies(tmp_path_factory):
    """5 training and 3 test seed-1 skies at 16 x 32 (ZIP, half)."""
    root = str(tmp_path_factory.mktemp("skies"))
    synthetic.write_dataset(root, train=5, test=3, width=32, seed=1)
    return root


def _train(skies):
    return os.path.join(skies, "Train")


def _flat(tree):
    return tck._flatten(tparams.to_numpy(tree))


def _assert_same_run(a, b):
    (pa, ma), (pb, mb) = a, b
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
    fa, fb = _flat(pa), _flat(pb)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _task(task, epochs=4, curriculum=(2,)):
    """5 maps in batches of 2: 3 batches an epoch, the last one ragged."""
    kw = dict(task=task, batch_size=2, epochs=epochs, multi_res_training=True,
              initial_resolution=RES[0], final_resolution=RES[1], curriculum=curriculum)
    if task == "FIT_DECODER":
        optim = toptim.OptimConfig(lr_start=1e-3, lr_end=1e-5, beta1=0.0, beta2=0.9)
        kw["kld_weighting"] = 1e-4
    else:
        optim = toptim.OptimConfig(lr_start=1e-2, lr_end=1e-4, beta1=0.0, beta2=0.9)
        kw.update(cosine_similarity_weight=1e-4, prior_loss_weight=1e-7)
    return ttasks.TaskConfig(**kw, optim=optim)


def _model(task):
    model = RENIModel(RENIConfig(
        model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4, hidden_layers=2,
        hidden_features=16, output_activation="tanh", fixed_decoder=task != "FIT_DECODER"))
    return model, model.init(torch.Generator().manual_seed(3), 5, device="cpu")


def _fit(task, images_at, **kw):
    model, params = _model(task)
    return ttasks.fit_task(model, params, _task(task), images_at,
                           torch.Generator().manual_seed(7), **kw)


def _resident(ds):
    return lambda res, epoch=None: ds.images_at(res, epoch, device="cpu")


# ---------------------------------------------------------------------------
# the lazy dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transforms", [PUBLISHED, []], ids=["published", "raw"])
def test_lazy_rows_equal_the_eager_stage(skies, transforms):
    """A lazy dataset lists the files and keeps nothing decoded; its rows,
    in every indexing form (int, slice, index array of any shape), its
    images_host_at and its images_at equal the eager stage bit for bit at
    the native size and below it."""
    eager = td.get_dataset("RENI_HDR", _train(skies), transforms, True)
    lazy = td.get_dataset("RENI_HDR", _train(skies), transforms, True, lazy=True)
    assert lazy._native is None and len(lazy) == len(eager) == 5
    for res in ((16, 32), (8, 16), (4, 8)):
        want = eager.images_host_at(res)
        src = lazy.row_source_at(res)
        assert src.shape == want.shape and src.dtype == want.dtype and len(src) == 5
        assert np.array_equal(src[3], want[3])
        assert np.array_equal(src[1:4], want[1:4])
        rows = np.array([[4, 0], [2, 2]])
        assert np.array_equal(src[rows], want[rows])
        assert np.array_equal(lazy.images_host_at(res), want)
        assert np.array_equal(lazy._stage_row(2, res), want[2])
        assert torch.equal(lazy.images_at(res, device="cpu"), torch.from_numpy(want))
    lazy.close()


def test_lazy_minmax_discovery_matches(skies):
    """minmaxnormalise without bounds: the lazy dataset's one bounded pass
    finds the eager dataset's (and the JAX package's) log min/max."""
    cfg = [["minmaxnormalise", []]]
    lazy = td.get_dataset("RENI_HDR", _train(skies), cfg, True, lazy=True)
    eager = td.get_dataset("RENI_HDR", _train(skies), cfg, True)
    theirs = jd.get_dataset("RENI_HDR", _train(skies), cfg, True, lazy=True)
    assert lazy.minmax == eager.minmax == theirs.minmax


def test_lazy_rejects_random_transforms(skies):
    """Random transforms draw one sequential generator over the whole set,
    which rows decoded out of order cannot reproduce: lazy=True refuses them
    with JAX's message; deterministic ones stage."""
    with pytest.raises(ValueError, match="lazy \\(out-of-core\\) decode cannot reproduce"):
        td.get_dataset("RENI_HDR", _train(skies), [["randomhorizontalflip", [0.5]]], True,
                       lazy=True)
    ds = td.get_dataset("RENI_HDR", _train(skies), [["grayscale", []]], True, lazy=True)
    eager = td.get_dataset("RENI_HDR", _train(skies), [["grayscale", []]], True)
    assert np.array_equal(ds.row_source_at((8, 16))[:], eager.images_host_at((8, 16)))
    ds.close()


def test_row_source_lru_is_bounded_and_counts_decodes(skies):
    """The LRU holds at most cache_rows rows (grown to four requests), a
    cached row is not decoded again, ``prefetch`` decodes once for the next
    request, and ``decodes`` counts exactly the rows staged."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=True)
    src = td.DiskRowSource(ds, (8, 16), ds.row_source_at((8, 16))._pool, cache_rows=1)
    src[[0]]
    src[[1]]
    src[[2]]
    assert src.decodes == 3 and list(src._cache) == [0, 1, 2]  # 4 x 1 rows
    src[[2, 1]]
    assert src.decodes == 3  # hits
    src[[3, 4]]
    assert src.decodes == 5 and len(src._cache) <= 8
    src.prefetch([0])
    assert src.decodes == 5  # still cached
    src._cache_rows = 2
    src.prefetch([4])
    assert len(src._cache) == 2 and list(src._cache) == [0, 4]
    src[[4, 0]]
    assert src.decodes == 5
    src[1]
    assert src.decodes == 6
    ds.close()


@pytest.mark.parametrize("fault, retried", [
    (OSError("short read"), True), (te.ExrError("corrupt chunk"), True),
    (FileNotFoundError("gone"), False), (PermissionError("denied"), False)],
    ids=["OSError", "ExrError", "FileNotFoundError", "PermissionError"])
def test_lazy_decode_retries_only_transient_faults(skies, fault, retried):
    """A lazy row decode retries once on OSError or ExrError (a transient
    fault reads clean the second time; a persistent one re-raises the first
    error), never on FileNotFoundError or PermissionError (JAX retries any
    Exception once: a difference kept on purpose)."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=True)
    want = ds._stage_row(1, (8, 16))
    calls = []
    real = ds._reader

    def flaky(path, persistent=False):
        calls.append(path)
        if len(calls) == 1 or persistent:
            raise fault
        return real(path)

    ds._reader = flaky
    if retried:
        assert np.array_equal(ds._stage_row(1, (8, 16)), want) and len(calls) == 2
        calls.clear()
        ds._reader = lambda path: flaky(path, persistent=True)
        with pytest.raises(type(fault)) as got:
            ds._stage_row(1, (8, 16))
        assert got.value is fault and len(calls) == 2
    else:
        with pytest.raises(type(fault)):
            ds._stage_row(1, (8, 16))
        assert len(calls) == 1


# ---------------------------------------------------------------------------
# the streaming runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 3], ids=["chunk1", "chunkK"])
@pytest.mark.parametrize("source", ["host", "disk"])
@pytest.mark.parametrize("task", ["FIT_DECODER", "FIT_LATENT"])
def test_stream_equals_resident(skies, task, source, chunk):
    """fit_task(stream=True) from images_host_at and from a DiskRowSource,
    one batch a copy and K = 3 (the batches of an epoch, with its ragged
    tail) a copy: every metric and every leaf bit for bit the resident
    fit_task's. FIT_DECODER's VAD draws its noise from the generator in the
    same order."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=source == "disk")
    src = ds.row_source_at if source == "disk" else ds.images_host_at
    want = _fit(task, _resident(td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True)))
    _assert_same_run(_fit(task, lambda res: src(res), stream=True, stream_chunk=chunk), want)
    ds.close()


def test_stream_chunk_rounds_to_a_divisor(skies, capsys):
    """STREAM_CHUNK without a divisor of the batches an epoch in range
    streams a batch a copy with JAX's note, and 4 over 3 batches takes 3;
    both equal the resident run."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True)
    want = _fit("FIT_LATENT", _resident(ds))
    for chunk, note in ((2, "no divisor of the 3 batches/epoch in range"),
                        (4, "using 3 (largest divisor of the 3 batches/epoch")):
        _assert_same_run(_fit("FIT_LATENT", ds.images_host_at, stream=True, stream_chunk=chunk),
                         want)
        out = capsys.readouterr().out
        assert out.count(note) == 1, out


@pytest.mark.parametrize("source", ["host", "disk"])
def test_stream_bf16_equals_resident_on_rounded_targets(skies, source):
    """stream_dtype=bfloat16 rounds the rows to bf16 on the host and widens
    them on the device: bit for bit the resident tier whose staged targets
    were rounded to bf16 and widened back (and not the float32 run)."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=source == "disk")
    src = ds.row_source_at if source == "disk" else ds.images_host_at
    eager = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True)
    rounded = {res: torch.from_numpy(eager.images_host_at(res)).to(torch.bfloat16).float()
               for res in RES}
    got = _fit("FIT_DECODER", lambda res: src(res), stream=True, stream_dtype=torch.bfloat16)
    _assert_same_run(got, _fit("FIT_DECODER", lambda res: rounded[res]))
    f32 = _fit("FIT_DECODER", _resident(eager))
    assert not np.array_equal(got[1]["fit_decoder_loss"], f32[1]["fit_decoder_loss"])
    ds.close()


def test_cast_rows_rounds_like_ml_dtypes():
    """_CastRows (the host-side bf16 cast) rounds to nearest even, as the
    JAX package's ml_dtypes cast does: the same bits on values around every
    rounding case, ties included."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    bits[:256] = (bits[:256] & 0xFFFF0000) | 0x8000  # exact ties
    x = bits.view(np.float32)
    x = np.where(np.isfinite(x), x, 1.0).astype(np.float32).reshape(-1, 8, 1)
    got = ttasks._CastRows(x, torch.bfloat16)[np.arange(x.shape[0])]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def test_stream_reaugment_equals_resident(skies):
    """With random transforms and reaugment, images_at(res, epoch) is called
    every epoch: the host arrays streamed equal the resident tensors."""
    cfg = [*PUBLISHED, ["randomhorizontalflip", [0.5]]]
    ds = td.get_dataset("RENI_HDR", _train(skies), cfg, True)
    want = _fit("FIT_LATENT", _resident(ds), reaugment=True)
    got = _fit("FIT_LATENT", lambda res, epoch=None: ds.images_host_at(res, epoch),
               reaugment=True, stream=True)
    _assert_same_run(got, want)


@pytest.mark.parametrize("source", ["host", "disk"])
def test_stream_cut_and_resumed_is_the_uncut_run(skies, tmp_path, source):
    """A streamed FIT_DECODER stopped by its callback mid-stage (epoch 3 of
    4, callbacks every epoch: the runner re-enters every segment), saved and
    resumed from the files: bit for bit the uncut streamed run, which is the
    resident run."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=source == "disk")
    src = ds.row_source_at if source == "disk" else ds.images_host_at
    model, params = _model("FIT_DECODER")
    task = _task("FIT_DECODER")
    kw = dict(stream=True, stream_chunk=3, callback_every=1)
    seen = []
    full = ttasks.fit_task(model, params, task, src, torch.Generator().manual_seed(7),
                           callback=lambda *a: seen.append(a[1]), **kw)
    assert seen == [1, 2, 3, 4]
    path = str(tmp_path / "cut")

    def stop(state, epoch, metrics, res):
        if epoch == 3:
            tck.save_checkpoint(path, state.params, model_config=model.config,
                                metadata={"task": "FIT_DECODER", "epoch": epoch, "loss": 0.0},
                                opt_state=tck.opt_state_arrays(state.optimizer),
                                generator=state.generator)
            return True
        return False

    ttasks.fit_task(model, params, task, src, torch.Generator().manual_seed(7), callback=stop,
                    **kw)
    saved, meta = tck.load_checkpoint(path)
    rest = ttasks.fit_task(
        model, tparams.from_numpy(saved, "cpu"), task, src, torch.Generator().manual_seed(99),
        start_epoch=meta["epoch"], initial_opt_state=lambda st: tck.load_train_state(path, st),
        **kw)
    fa, fb = _flat(full[0]), _flat(rest[0])
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    np.testing.assert_array_equal(full[1]["fit_decoder_loss"][3:], rest[1]["fit_decoder_loss"])
    eager = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True)
    _assert_same_run(full, _fit("FIT_DECODER", _resident(eager)))
    ds.close()


def test_stream_with_a_mesh_names_a11(skies):
    """A streamed run on a mesh (ROADMAP A-11, ported: the mesh half of the
    runner is held on four ranks in tests/test_torch_parallel.py) runs; on
    the one-rank mesh of a single process it is the unsharded streamed run
    bit for bit. A stream_dtype other than float32 or bfloat16 raises."""
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True)
    plain = _fit("FIT_LATENT", ds.images_host_at, stream=True)
    on_mesh = _fit("FIT_LATENT", ds.images_host_at, stream=True, mesh=pmesh.make_mesh(device="cpu"),
                   shard_latents=True)
    assert plain[1].keys() == on_mesh[1].keys()
    for k in plain[1]:
        np.testing.assert_array_equal(plain[1][k], on_mesh[1][k])
    assert torch.equal(plain[0]["latents"]["mu"], on_mesh[0]["latents"]["mu"])
    with pytest.raises(ValueError, match="stream_dtype must be float32 or bfloat16"):
        _fit("FIT_LATENT", ds.images_host_at, stream=True, stream_dtype="float16")


class _F64Rows:
    """A row source's rows as float64 (prefetch passes through), so that a
    run is float64 end to end in both packages."""

    def __init__(self, source):
        self._src = source
        self.shape = source.shape
        self.dtype = np.dtype(np.float64)
        self.prefetch = source.prefetch

    def __getitem__(self, rows):
        return np.asarray(self._src[rows], np.float64)


def test_stream_from_disk_matches_jax_f64(skies):
    """FIT_LATENT streamed from each package's lazy dataset on the same
    files, at float64 on both sides (parameters, and the rows widened from
    the files' float32): epoch 0's metrics to 1e-12 relative, every epoch
    to 1e-6."""
    cfg = dict(model_type="VariationalAutoDecoder", equivariance="SO2", latent_dim=4,
               hidden_layers=2, hidden_features=16, output_activation="tanh",
               fixed_decoder=True)
    jm = JModel(JConfig(**cfg))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(4), dataset_size=5))
    jp["latents"]["mu"] = 0.3 * np.random.default_rng(4).normal(
        size=jp["latents"]["mu"].shape).astype(np.float32)
    task = _task("FIT_LATENT")
    jtask = jtasks.TaskConfig(**{**dataclasses.asdict(task), "optim": joptim.OptimConfig(
        **dataclasses.asdict(task.optim))})
    jds = jd.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=True)
    with jax.enable_x64():
        jp64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), jp)
        _, jmet = jtasks.fit_task(jm, jp64, jtask, lambda res: _F64Rows(jds.row_source_at(res)),
                                  jax.random.PRNGKey(0), stream=True)
    ds = td.get_dataset("RENI_HDR", _train(skies), PUBLISHED, True, lazy=True)
    tp = tparams.from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float64), jp), "cpu")
    _, tmet = ttasks.fit_task(RENIModel(RENIConfig(**cfg)), tp, task,
                              lambda res: _F64Rows(ds.row_source_at(res)),
                              torch.Generator().manual_seed(0), stream=True)
    assert tmet.keys() == jmet.keys()
    for k in jmet:
        np.testing.assert_allclose(tmet[k][0], jmet[k][0], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-6, err_msg=k)
    ds.close()


# ---------------------------------------------------------------------------
# the trainer's TPU.STREAM_* keys
# ---------------------------------------------------------------------------


def _config(tmp_path, skies):
    """A FIT_DECODER -> FIT_LATENT chain at the tiny sizes above, on the
    seed-1 skies with the published transform, grids every 2 epochs."""
    cfg = get_cfg_defaults()
    cfg.RENI.TASKS = ["FIT_DECODER", "FIT_LATENT"]
    cfg.RENI.LATENT_DIMENSION = 4
    cfg.RENI.HIDDEN_LAYERS = 1
    cfg.RENI.HIDDEN_FEATURES = 16
    for task in ("FIT_DECODER", "FIT_LATENT"):
        t = cfg.RENI[task]
        t.EPOCHS, t.BATCH_SIZE, t.CURRICULUM = 4, 2, [2]
        t.INITAL_RESOLUTION, t.FINAL_RESOLUTION = list(RES[0]), list(RES[1])
    cfg.DATASET.NAME = "RENI_HDR"
    cfg.DATASET.RENI_HDR.PATH = skies
    cfg.DATASET.RENI_HDR.TRANSFORMS = PUBLISHED
    cfg.TRAINER.CHKPTS.EVERY_N_EPOCHS = 2
    cfg.TRAINER.LOGGER_TYPE = "jsonl"
    cfg.TRAINER.LOGGER.EPOCHS_BETWEEN_EXAMPLES = 2
    cfg.TRAINER.LOGGER.NUMBER_OF_IMAGES = 2
    cfg.TRAINER.LOGGER.TB.SAVE_DIR = str(tmp_path / "runs")
    return cfg


def _finals(log_dir):
    out = {}
    for task in ("fit_decoder", "fit_latent"):
        with np.load(os.path.join(log_dir, "checkpoints", f"{task}_final.npz")) as z:
            out[task] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def resident_chain(skies, tmp_path_factory):
    """The final checkpoints of the chain without streaming."""
    cfg = _config(tmp_path_factory.mktemp("resident"), skies)
    return _finals(trun.main(cfg, device="cpu")[1])


@pytest.mark.parametrize("keys", [
    dict(STREAM_DATA=True), dict(STREAM_FROM_DISK=True), dict(STREAM_DATA=True, STREAM_CHUNK=3),
    dict(STREAM_DATA=True, STREAM_DTYPE="bfloat16")],
    ids=["STREAM_DATA", "STREAM_FROM_DISK", "STREAM_CHUNK", "STREAM_DTYPE"])
def test_stream_keys_run_the_chain(tmp_path, skies, resident_chain, keys):
    """Each TPU.STREAM_* key runs the trainer's chain (grids from host rows
    or from disk included); the float32 tiers end at the resident chain's
    final checkpoints bit for bit, bf16 at finite losses of its own."""
    want = resident_chain
    cfg = _config(tmp_path, skies)
    cfg.TPU.update(keys)
    results, log_dir = trun.main(cfg, device="cpu")
    assert sorted(os.listdir(os.path.join(log_dir, "images"))) == [
        f"{t}_images_{e:06d}.png" for t in ("fit_decoder", "fit_latent") for e in (2, 4)]
    got = _finals(log_dir)
    if "STREAM_DTYPE" in keys:
        for task, (_, metrics) in results.items():
            assert np.isfinite(metrics[f"{task.lower()}_loss"]).all()
        assert not np.array_equal(got["fit_decoder"]["latents/mu"],
                                  want["fit_decoder"]["latents/mu"])
        return
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k in want[task]:
            np.testing.assert_array_equal(got[task][k], want[task][k], err_msg=f"{task} {k}")


@pytest.mark.parametrize("keys", [dict(STREAM_CHUNK=0), dict(STREAM_DTYPE="float16")],
                         ids=["STREAM_CHUNK", "STREAM_DTYPE"])
def test_stream_key_validation_matches_jax(tmp_path, skies, keys):
    """An invalid STREAM_CHUNK or STREAM_DTYPE exits with the JAX trainer's
    message (its text in reni_tpu/cli/run.py), before any run directory."""
    cfg = _config(tmp_path, skies)
    cfg.TPU.update(keys)
    with pytest.raises(SystemExit) as e:
        trun.main(cfg, device="cpu")
    want = {"STREAM_CHUNK": ("TPU.STREAM_CHUNK must be >= 1, got 0",
                             'f"TPU.STREAM_CHUNK must be >= 1, got {stream_chunk}"'),
            "STREAM_DTYPE": ("TPU.STREAM_DTYPE must be float32 or bfloat16, got 'float16'",
                             'f"TPU.STREAM_DTYPE must be float32 or bfloat16, got {_sd!r}"')}
    msg, jax_source = want[next(iter(keys))]
    assert str(e.value) == msg
    with open(jrun.__file__) as f:
        assert jax_source in f.read()
    assert not os.path.exists(cfg.TRAINER.LOGGER.TB.SAVE_DIR)


def test_stream_notes_match_jax(tmp_path, skies, capsys):
    """STREAM_CHUNK and STREAM_DTYPE without STREAM_DATA are ignored with
    the JAX trainer's notes (each names the package that prints it), once a
    task."""
    cfg = _config(tmp_path, skies)
    cfg.RENI.TASKS = ["FIT_DECODER"]
    cfg.TPU.update(STREAM_CHUNK=3, STREAM_DTYPE="bfloat16")
    trun.main(cfg, device="cpu")
    out = capsys.readouterr().out
    for note in ("TPU.STREAM_DTYPE ignored without TPU.STREAM_DATA",
                 "TPU.STREAM_CHUNK ignored without TPU.STREAM_DATA"):
        assert out.count(f"[reni_tpu_torch] {note}") == 1
        with open(jrun.__file__) as f:
            assert f"[reni_tpu] {note}" in f.read()
