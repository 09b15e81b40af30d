"""The port's config, EXR codec, transforms, datasets and synthetic skies
(reni_tpu_torch.utils.config, reni_tpu_torch.data.*) held against the JAX
package's on the same files and inputs: bitwise where the arithmetic is the
same, within a stated tolerance where it is not (the bilinear resize below
the native size, the synthetic skies' directions)."""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from reni_tpu.data import datasets as jd
from reni_tpu.data import exr as je
from reni_tpu.data import transforms as jt
from reni_tpu.utils import config as jc
from reni_tpu_torch.data import datasets as td
from reni_tpu_torch.data import exr as te
from reni_tpu_torch.data import synthetic as sy
from reni_tpu_torch.data import transforms as tt
from reni_tpu_torch.utils import config as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import make_synthetic_dataset as ms  # noqa: E402

# The port's resize (torch bilinear) against OpenCV's INTER_LINEAR, which the
# JAX package calls: both compute the same 2x2 weighted sums in float32, in
# another order, so they differ by a few ulps (measured: at most 2.1e-7
# relative at 32x64, 16x32 and 8x16 from 64x128); at the native size both
# return the image unchanged.
RESIZE_RTOL = 1e-6
# the same after MinMaxNormalise: a relative error e before the log is an
# absolute error e x 2 / (hi - lo) after it, under the float32 rounding of
# values of magnitude 1 (1.2e-7 an ulp): 1e-6 is 8 ulps
RESIZE_NORM_ATOL = 1e-6
PUBLISHED_MINMAX = [-18.0536, 11.4633]  # configs/zoo_synthetic.yaml
COMPRESSIONS = ["NONE", "RLE", "ZIPS", "ZIP", "PXR24"]
UNPORTED = ["PIZ", "B44", "B44A", "DWAA", "DWAB"]


def _hdr_image(seed=0, shape=(37, 53, 3)):
    """An HDR-like float32 image: positive, four decades, odd sizes (a
    ragged last ZIP chunk and tile)."""
    rng = np.random.default_rng(seed)
    return (rng.lognormal(sigma=2.0, size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


ZOO_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "data", "Zoo", "*", "config.yaml")))


@pytest.mark.parametrize(
    "path", [None, os.path.join(ROOT, "configs", "zoo_synthetic.yaml"), *ZOO_CONFIGS],
    ids=lambda p: "defaults" if p is None else os.path.relpath(p, ROOT))
def test_config_trees_match_jax(path):
    """The default tree, and the tree with a published YAML merged in: the
    same nested dict and the same experiment name in both packages."""
    ours, theirs = tc.get_cfg_defaults(), jc.get_cfg_defaults()
    if path is not None:
        ours.merge_from_file(path)
        theirs.merge_from_file(path)
    assert ours.to_dict() == theirs.to_dict()
    assert tc.experiment_name(ours) == jc.experiment_name(theirs)
    assert ours.RENI.FIT_DECODER.BATCH_SIZE == ours["RENI"]["FIT_DECODER"]["BATCH_SIZE"]
    clone = ours.clone()
    clone.RENI.LATENT_DIMENSION = -1
    assert ours.RENI.LATENT_DIMENSION != -1


def test_config_rejects_unknown_keys_like_jax():
    """A key absent from the defaults raises KeyError with the dotted name,
    as in the JAX package (a per-task block misplaced at the top level)."""
    for mod in (tc, jc):
        with pytest.raises(KeyError, match="non-existent config key: 'FIT_DECODER'"):
            mod.get_cfg_defaults().merge_from_dict({"FIT_DECODER": {"EPOCHS": 1}})
        with pytest.raises(KeyError, match="'RENI.NOPE'"):
            mod.get_cfg_defaults().merge_from_dict({"RENI": {"NOPE": 1}})


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------


def _jax_reads(path):
    """JAX's read of a file through its native decoder (where it builds) and
    through its Python decoder."""
    reads = [je.read(path)]
    with je.force_python_decoder():
        reads.append(je.read(path))
    return reads


@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_exr_scanline_matches_jax(tmp_path, compression, pixel_type):
    """Scanline files of every ported codec and both pixel types: the JAX
    writer's file reads bitwise equal through the port and through both JAX
    decoders; the port's writer gives the same bytes, and the JAX reader
    reads the port's file equal."""
    img = _hdr_image(1)
    theirs, ours = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    je.write(theirs, img, pixel_type=pixel_type, compression=compression)
    te.write(ours, img, pixel_type=pixel_type, compression=compression)
    got = te.read(theirs)
    assert got.dtype == np.float32 and got.shape == img.shape
    for ref in _jax_reads(theirs):
        assert np.array_equal(got, ref)
    with open(theirs, "rb") as f, open(ours, "rb") as g:
        assert f.read() == g.read()
    assert np.array_equal(je.read(ours), got)


@pytest.mark.parametrize("compression", ["ZIP", "RLE", "PXR24"])
def test_exr_tiled_matches_jax(tmp_path, compression):
    """A tiled file (16 x 16 tiles over 37 x 53: clamped edge tiles): the
    same reads, the same bytes from both writers."""
    img = _hdr_image(2)
    theirs, ours = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    je.write_tiled(theirs, img, tile=(16, 16), compression=compression)
    te.write_tiled(ours, img, tile=(16, 16), compression=compression)
    got = te.read(theirs)
    for ref in _jax_reads(theirs):
        assert np.array_equal(got, ref)
    with open(theirs, "rb") as f, open(ours, "rb") as g:
        assert f.read() == g.read()


def test_exr_multipart_and_grayscale_match_jax(tmp_path):
    """A two-part file of different sizes and codecs (part 1 grayscale,
    replicated to 3 channels on read): read, read_part of each part, the
    same bytes from both writers; a single-part file has only part 0."""
    a, b = _hdr_image(3), _hdr_image(4, (10, 20, 1))
    theirs, ours = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    je.write_multipart(theirs, [a, b], compressions=["ZIP", "RLE"], names=["sky", "y"])
    te.write_multipart(ours, [a, b], compressions=["ZIP", "RLE"], names=["sky", "y"])
    with open(theirs, "rb") as f, open(ours, "rb") as g:
        assert f.read() == g.read()
    assert np.array_equal(te.read(theirs), je.read(theirs))
    for part in (0, 1):
        got = te.read_part(theirs, part)
        assert np.array_equal(got, je.read_part(theirs, part))
    assert te.read_part(theirs, 1).shape == (10, 20, 3)
    single = str(tmp_path / "single.exr")
    te.write(single, a)
    assert np.array_equal(te.read_part(single, 0), je.read(single))
    with pytest.raises(te.ExrError, match="only part 0"):
        te.read_part(single, 1)


@pytest.mark.parametrize("compression", UNPORTED)
def test_exr_unported_codecs_raise(tmp_path, compression):
    """A file in a codec the port does not decode yet raises ExrError naming
    the codec and ROADMAP A-6b, from the reader and the writer alike."""
    path = str(tmp_path / "x.exr")
    je.write(path, _hdr_image(5), compression=compression)
    with pytest.raises(te.ExrError, match=f"{compression} compression is not ported yet "
                                          r"\(ROADMAP A-6b\)"):
        te.read(path)
    with pytest.raises(te.ExrError, match=r"A-6b"):
        te.write(str(tmp_path / "y.exr"), _hdr_image(5), compression=compression)


def test_exr_corrupt_file_names_the_path(tmp_path):
    """A truncated file and a file that is not an EXR raise ExrError with the
    path, as in the JAX package."""
    path = str(tmp_path / "t.exr")
    te.write(path, _hdr_image(6))
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(te.ExrError, match="t.exr"):
        te.read(path)
    with open(path, "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(te.ExrError, match="not an EXR"):
        te.read(path)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


REGISTRY = [
    ("resize", [37, 53]),
    ("randomhorizontalflip", None),
    ("randomverticalflip", None),
    ("randomcrop", [20, 30]),
    ("randomrotation", 30),
    ("colorjitter", [0.3, 0.3, 0.3, 0.1]),
    ("centercrop", [21, 33]),
    ("grayscale", None),
    ("normalize", [[0.5] * 3, [0.25] * 3]),
    ("minmaxnormalise", PUBLISHED_MINMAX),
    ("minmaxormalise", PUBLISHED_MINMAX),
    ("to_tensor", None),
]


@pytest.mark.parametrize("name,args", REGISTRY, ids=[n for n, _ in REGISTRY])
def test_transform_registry_matches_jax(name, args):
    """Every registry entry on a seeded image (resize at the native size),
    drawing from the same seeded generators five times: bitwise equal."""
    ours = tt.get_transform(name, args, np.random.default_rng(9))
    theirs = jt.get_transform(name, args, np.random.default_rng(9))
    for k in range(5):
        img = _hdr_image(10 + k) / 50.0
        a, b = ours(img), theirs(img)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b), (name, k)


def test_transform_builder_and_inverses_match_jax():
    """A composed pipeline, the inverses (numpy, and torch for the port) and
    the helpers: equal to the JAX package's."""
    cfg = [["randomhorizontalflip", None], ["colorjitter", [0.2, 0.2, 0.2, 0.05]],
           ["minmaxnormalise", PUBLISHED_MINMAX]]
    img = _hdr_image(20)
    assert np.array_equal(tt.transform_builder(cfg, 3)(img), jt.transform_builder(cfg, 3)(img))
    x = jt.MinMaxNormalise(PUBLISHED_MINMAX)(img)
    ref = jt.UnMinMaxNormalise(PUBLISHED_MINMAX)(x)
    assert np.array_equal(tt.UnMinMaxNormalise(PUBLISHED_MINMAX)(x), ref)
    back = tt.UnMinMaxNormalise(PUBLISHED_MINMAX)(torch.from_numpy(x))
    assert isinstance(back, torch.Tensor)
    np.testing.assert_allclose(back.numpy(), ref, rtol=1e-6)
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.4]
    y = tt.Normalise(mean, std)(img)
    assert np.array_equal(y, jt.Normalise(mean, std)(img))
    chw = np.ascontiguousarray(np.transpose(y, (2, 0, 1))[None])
    assert np.array_equal(tt.UnNormalise(mean, std)(chw), jt.UnNormalise(mean, std)(chw))
    assert np.array_equal(tt.UnNormalise(mean, std)(y), jt.UnNormalise(mean, std)(y))
    bad = img.copy()
    bad[0, 0] = np.inf
    bad[0, 1] = 0.0
    assert np.array_equal(tt.clip_positive_finite(bad), jt.clip_positive_finite(bad))
    imgs = [_hdr_image(s) for s in range(4)]
    assert tt.compute_log_minmax(imgs) == jt.compute_log_minmax(imgs)
    hue = np.clip(_hdr_image(21) / 10, 0, 1)
    assert np.array_equal(tt.shift_hue(hue, 0.3), jt.shift_hue(hue, 0.3))
    assert tt.RANDOM_TRANSFORMS == jt.RANDOM_TRANSFORMS
    with pytest.raises(ValueError, match="unsupported transform"):
        tt.get_transform("nope", None)


@pytest.mark.parametrize("layout", ["channel_last", "channel_first"])
def test_unnormalise_takes_tensors_with_gradients(layout):
    """UnNormalise on a tensor that requires grad (FIT_INVERSE unnormalises
    the decoder's output of an LDR config): JAX's values, float64 kept, and
    the gradient std per channel."""
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.4]
    y = np.random.default_rng(0).normal(size=(2, 5, 7, 3))
    if layout == "channel_first":
        y = np.ascontiguousarray(np.transpose(y, (0, 3, 1, 2)))
    x = torch.from_numpy(y).requires_grad_(True)
    out = tt.UnNormalise(mean, std)(x)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.detach().numpy(), jt.UnNormalise(mean, std)(y), rtol=1e-15)
    out.sum().backward()
    want = np.asarray(std, np.float32).astype(np.float64)
    want = want.reshape(1, 3, 1, 1) if layout == "channel_first" else want
    np.testing.assert_array_equal(x.grad.numpy(), np.broadcast_to(want, y.shape))


@pytest.mark.parametrize("size", [(64, 128), (32, 64), (16, 32)])
def test_resize_matches_opencv(size):
    """The port's bilinear resize of a 64 x 128 HDR map against OpenCV's
    INTER_LINEAR (the JAX package's): equal at the native size, within
    RESIZE_RTOL of each value below it."""
    img = _hdr_image(30, (64, 128, 3))
    ours, theirs = tt.resize_bilinear(img, *size), jt.resize_bilinear(img, *size)
    assert ours.shape == theirs.shape == (*size, 3) and ours.dtype == np.float32
    if size == img.shape[:2]:
        assert np.array_equal(ours, theirs) and ours is not img
    else:
        np.testing.assert_allclose(ours, theirs, rtol=RESIZE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic_sets(tmp_path_factory):
    """A small seeded set written by the JAX script in process: 12 train and
    5 test HDR maps at 16 x 32 (ZIP, half), and the same skies as LDR PNGs."""
    root = tmp_path_factory.mktemp("synthetic")
    hdr, ldr = str(root / "hdr"), str(root / "ldr")
    args = ["--train", "12", "--test", "5", "--width", "32", "--seed", "1"]
    ms.main(["--out", hdr, *args])
    ms.main(["--out", ldr, *args, "--ldr"])
    return hdr, ldr


def _assert_staged(ours, theirs, res, native, normalised):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.float32
    if res == native:
        assert np.array_equal(ours, theirs)
    elif normalised:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=RESIZE_NORM_ATOL)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=RESIZE_RTOL, atol=0)


@pytest.mark.parametrize("minmax", [PUBLISHED_MINMAX, []], ids=["published", "discovered"])
@pytest.mark.parametrize("split", ["Train", "Test"])
def test_hdr_dataset_matches_jax(synthetic_sets, split, minmax):
    """The HDR pipeline on the JAX script's maps, both splits: the same file
    order and log min/max (published or discovered), images_host_at bitwise
    equal at the native 16 x 32 and within the resize tolerance at 8 x 16
    and 4 x 8; images_at gives the same values as a tensor on the asked
    device and dtype; the alias minmaxormalise gives the same."""
    path = os.path.join(synthetic_sets[0], split)
    for alias in ("minmaxnormalise", "minmaxormalise"):
        cfg = [[alias, minmax]]
        ours = td.get_dataset("RENI_HDR", path, cfg, True)
        theirs = jd.get_dataset("RENI_HDR", path, cfg, True)
        assert ours.img_names == theirs.img_names and len(ours) == (12 if split == "Train" else 5)
        assert ours.minmax == theirs.minmax
        for res in ((16, 32), (8, 16), (4, 8)):
            _assert_staged(ours.images_host_at(res), theirs.images_host_at(res), res, (16, 32),
                           True)
        host = ours.images_host_at((8, 16))
        dev = ours.images_at((8, 16), device="cpu", dtype=torch.float64)
        assert dev.dtype == torch.float64 and torch.equal(dev, torch.from_numpy(host).double())
        assert ours.images_at((8, 16), device="cpu", dtype=torch.float64) is dev
    unnorm = ours.unnormalise(ours.images_host_at((16, 32)))
    np.testing.assert_allclose(unnorm, theirs.unnormalise(theirs.images_host_at((16, 32))),
                               rtol=1e-6)


def test_hdr_dataset_raw_pyramid_matches_jax(synthetic_sets):
    """No transforms: the decoded maps themselves at the native resolution
    (bitwise) and below it (within RESIZE_RTOL)."""
    path = os.path.join(synthetic_sets[0], "Train")
    ours, theirs = td.get_dataset("RENI_HDR", path, [], True), jd.EnvironmentMapDataset(
        path, True, [])
    for res in ((16, 32), (8, 16)):
        _assert_staged(ours.images_host_at(res), theirs.images_host_at(res), res, (16, 32), False)


def test_ldr_dataset_matches_jax(synthetic_sets):
    """The LDR pipeline (PNGs through PIL, normalize(0.5, 0.5)) on the JAX
    script's --ldr maps: equal at the native size, within the resize
    tolerance below it."""
    path = os.path.join(synthetic_sets[1], "Train")
    cfg = [["normalize", [[0.5] * 3, [0.5] * 3]]]
    ours = td.get_dataset("RENI_LDR", path, cfg, False)
    theirs = jd.get_dataset("RENI_LDR", path, cfg, False)
    assert ours.img_names == theirs.img_names and not ours.is_hdr
    for res in ((16, 32), (8, 16)):
        _assert_staged(ours.images_host_at(res), theirs.images_host_at(res), res, (16, 32), True)


def test_read_hdr_and_ldr_match_jax(tmp_path):
    """The readers of the other formats: a Radiance .hdr (OpenCV, imported
    at call time) and an RGBA PNG (PIL, alpha dropped) read equal to the JAX
    package's."""
    import cv2
    from PIL import Image

    hdr = str(tmp_path / "x.hdr")
    cv2.imwrite(hdr, _hdr_image(40, (8, 16, 3)))
    ours = td.read_hdr(hdr)
    assert ours.shape == (8, 16, 3) and np.array_equal(ours, jd.read_hdr(hdr))
    png = str(tmp_path / "x.png")
    rgba = np.random.default_rng(41).integers(0, 256, (8, 16, 4), dtype=np.uint8)
    Image.fromarray(rgba).save(png)
    ours = td.read_ldr(png)
    assert ours.shape == (8, 16, 3) and np.array_equal(ours, jd.read_ldr(png))


def test_dataset_refuses_lazy_and_empty_folders(tmp_path, synthetic_sets):
    """lazy=True names ROADMAP A-9; an empty folder raises as in JAX; the
    natural sort is JAX's."""
    with pytest.raises(NotImplementedError, match="A-9"):
        td.get_dataset("RENI_HDR", os.path.join(synthetic_sets[0], "Train"), [], True, lazy=True)
    with pytest.raises(FileNotFoundError, match="no HDR images"):
        td.get_dataset("RENI_HDR", str(tmp_path), [], True)
    names = ["img10.exr", "img2.exr", "Img1.exr", "img2a.exr"]
    assert td.natsorted(names) == jd.natsorted(names)


# ---------------------------------------------------------------------------
# synthetic skies
# ---------------------------------------------------------------------------

# The port's directions agree with JAX's to about 1e-7 (on some CPUs bit for
# bit); the sun lobe exp(s (d.sun - 1)) with s up to 400 turns a direction
# error e into a relative error of about 400 e = 4e-5 of that term.
SKY_RTOL = 1e-4


def test_make_sky_matches_the_script():
    """synthetic.make_sky against examples/make_synthetic_dataset.make_sky,
    seed 1, the first 8 maps at width 128 (one generator, in order): within
    SKY_RTOL; after quantisation to half (what the files hold) no value is
    more than one half ulp apart."""
    r_port, r_jax = np.random.default_rng(1), np.random.default_rng(1)
    dirs = sy.directions(128)
    differing = 0
    for _ in range(8):
        ours, theirs = sy.make_sky(r_port, 128, dirs), ms.make_sky(r_jax, 128)
        assert ours.shape == theirs.shape == (64, 128, 3) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, rtol=SKY_RTOL, atol=0)
        a = ours.astype(np.float16).view(np.int16).astype(np.int32)
        b = theirs.astype(np.float16).view(np.int16).astype(np.int32)
        assert np.abs(a - b).max() <= 1
        differing += int((a != b).sum())
    print(f"half values that differ by one ulp in 8 maps: {differing} of {8 * 64 * 128 * 3}")
    assert np.array_equal(sy.make_sky(np.random.default_rng(2), 32),
                          sy.make_sky(np.random.default_rng(2), 32, sy.directions(32)))


def test_written_dataset_reads_like_the_scripts(tmp_path, synthetic_sets):
    """synthetic.main writes the script's layout (Train/, Test/,
    sky_NNNN.exr) from one generator over both splits; its maps decode
    within one half ulp of the script's (same seed, same width)."""
    out = str(tmp_path / "port")
    sy.main(["--out", out, "--train", "12", "--test", "5", "--width", "32", "--seed", "1"])
    for split, n in (("Train", 12), ("Test", 5)):
        names = sorted(os.listdir(os.path.join(out, split)))
        assert names == sorted(os.listdir(os.path.join(synthetic_sets[0], split)))
        assert len(names) == n
        for name in names:
            a = te.read(os.path.join(out, split, name)).astype(np.float16)
            b = je.read(os.path.join(synthetic_sets[0], split, name)).astype(np.float16)
            diff = a.view(np.int16).astype(np.int32) - b.view(np.int16).astype(np.int32)
            assert np.abs(diff).max() <= 1
