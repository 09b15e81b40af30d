"""The LDR Zoo entry's path in the port (ROADMAP A-6c) against the JAX
package on the CPU: ``data/synthetic.tonemap_ldr`` and ``--ldr`` against
``examples/make_synthetic_dataset.py``, ``data/datasets.read_ldr`` (a PNG
through ``core.sphere.read_png``, no PIL) against the JAX package's PIL
reader, and the LDR entry's evaluation against ``reni_tpu.eval`` on the
same PNG files."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from reni_tpu import eval as jev
from reni_tpu.data import datasets as jds
from reni_tpu.models.reni import RENIModel as JModel
from reni_tpu.train import checkpoint as jck
from reni_tpu_torch import eval as tev
from reni_tpu_torch import params as tparams
from reni_tpu_torch.core import sphere
from reni_tpu_torch.data import datasets as tds
from reni_tpu_torch.data import synthetic as sy
from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.train import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import make_synthetic_dataset as ms  # noqa: E402

LDR = os.path.join(ROOT, "data", "Zoo", "latent_dim_49_net_5_256_vad_cbc_tanh_ldr")
TRANSFORMS = [["normalize", [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]]]]  # the entry's config.yaml
DB, SSIM = 0.01, 1e-3  # ROADMAP A-5


@pytest.fixture(scope="module")
def ldr_sets(tmp_path_factory):
    """(the script's, the port's) seed-1 LDR sets: 2 train + 4 test maps at
    width 128, the Zoo recipe's generator."""
    tmp = tmp_path_factory.mktemp("ldr")
    script, port = str(tmp / "script"), str(tmp / "port")
    ms.main(["--out", script, "--train", "2", "--test", "4", "--width", "128", "--seed", "1",
             "--ldr"])
    sy.main(["--out", port, "--train", "2", "--test", "4", "--width", "128", "--seed", "1",
             "--ldr"])
    return script, port


def test_tonemap_matches_the_script_uint8():
    """On the same HDR skies (the port's and the script's, seed 1), the
    port's tonemap equals the script's as uint8."""
    r_port, r_jax = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(6):
        for sky in (sy.make_sky(r_port, 128), ms.make_sky(r_jax, 128)):
            ours = sy.tonemap_ldr(sky)
            assert ours.dtype == np.uint8 and ours.shape == (64, 128, 3)
            np.testing.assert_array_equal(ours, ms.tonemap_ldr(sky))


def test_seed1_pngs_within_one_code_value(ldr_sets):
    """The files of --ldr: the script's layout and names, and pixels within
    one code value of the script's (the skies agree to a tolerance, not bit
    for bit: tests/test_torch_data.py::test_make_sky_matches_the_script)."""
    script, port = ldr_sets
    for split, n in (("Train", 2), ("Test", 4)):
        names = sorted(os.listdir(os.path.join(port, split)))
        assert names == sorted(os.listdir(os.path.join(script, split)))
        assert names == [f"sky_{i:04d}.png" for i in range(n)]
        for name in names:
            a = np.asarray(Image.open(os.path.join(port, split, name)))
            b = np.asarray(Image.open(os.path.join(script, split, name)))
            assert a.shape == b.shape == (64, 128, 3) and a.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_write_dataset_ldr_writes_the_tonemapped_skies(tmp_path):
    """``write_dataset(..., ldr=True)``: Train then Test PNGs, each
    ``tonemap_ldr`` of the next sky of one generator, as written and read
    back by the port's PNG writer and reader."""
    folders = sy.write_dataset(str(tmp_path), 2, 3, 64, 1, ldr=True)
    rng, dirs = np.random.default_rng(1), sy.directions(64)
    for split, n in (("Train", 2), ("Test", 3)):
        assert sorted(os.listdir(folders[split])) == [f"sky_{i:04d}.png" for i in range(n)]
        for i in range(n):
            np.testing.assert_array_equal(
                sphere.read_png(os.path.join(folders[split], f"sky_{i:04d}.png")),
                sy.tonemap_ldr(sy.make_sky(rng, 64, dirs)))


def test_read_ldr_equals_pil_on_the_ports_files(ldr_sets):
    for split in ("Train", "Test"):
        for folder in ldr_sets:
            d = os.path.join(folder, split)
            for name in os.listdir(d):
                path = os.path.join(d, name)
                np.testing.assert_array_equal(sphere.read_png(path),
                                              np.asarray(Image.open(path)))
                ours = tds.read_ldr(path)
                assert ours.dtype == np.float32
                np.testing.assert_array_equal(ours, jds.read_ldr(path))


def _filters(path: str) -> set:
    """The filter types of a PNG's scanlines."""
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, _, colour = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
    raw = zlib.decompress(b"".join(idat))
    stride = w * {0: 1, 4: 2, 2: 3, 6: 4}[colour] + 1
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_read_ldr_equals_pil_on_every_filter_type(tmp_path, mode):
    """PIL-written PNGs of grey, grey + alpha, RGB and RGBA whose scanlines
    between them use all five filter types (PIL picks a filter per line):
    ``read_png`` equals PIL's decode and ``read_ldr`` the JAX package's."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:48, 0:96]
    smooth = np.stack([x * 2, y * 3, x + y, 255 - x], -1) % 256
    images = [smooth, np.clip(smooth + rng.integers(-3, 4, smooth.shape), 0, 255),
              rng.integers(0, 256, smooth.shape), np.zeros_like(smooth)]
    channels = {"L": [0], "LA": [0, 3], "RGB": [0, 1, 2], "RGBA": [0, 1, 2, 3]}[mode]
    seen = set()
    for i, img in enumerate(images):
        arr = img[..., channels].astype(np.uint8)
        for optimize in (False, True):
            path = str(tmp_path / f"{i}_{optimize}.png")
            Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path,
                                                                           optimize=optimize)
            seen |= _filters(path)
            np.testing.assert_array_equal(sphere.read_png(path), np.asarray(Image.open(path)))
            np.testing.assert_array_equal(tds.read_ldr(path), jds.read_ldr(path))
    assert seen == {0, 1, 2, 3, 4}


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        sphere.read_png(path)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    (tmp_path / "q.png").write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="bit depth 16"):
        sphere.read_png(str(tmp_path / "q.png"))


def test_ldr_entry_evaluation_matches_jax(tmp_path):
    """The LDR entry's first three test latents against the first three of
    the Zoo recipe's seed-1 Test PNGs (drawn after its 1,000 training skies)
    at 32 x 64 (its normalize(0.5, 0.5) transform,
    LDR display): psnr_mean and rotated_reconstruction_psnr within 0.01 dB,
    ssim_mean within 1e-3 of the JAX package's evaluation of the same
    files."""
    res, n = (32, 64), 3
    test_dir = sy.write_dataset(str(tmp_path), 1000, n, 128, 1, ldr=True)["Test"]
    ck = os.path.join(LDR, "latents_test")
    saved, _ = jck.load_checkpoint(ck)
    cut = {"decoder": saved["decoder"],
           "latents": {k: np.asarray(v)[:n] for k, v in saved["latents"].items()}}

    jset = jds.get_dataset("RENI_LDR", test_dir, TRANSFORMS, False)
    jmodel = JModel(jck.load_model_config(ck))
    jimg = jset.images_at(res)[:n]
    kw = dict(unnormalise=jset.unnormalise, is_hdr=False)
    ref = {**jev.reconstruction_psnr(jmodel, cut, jimg, res, **kw),
           **jev.equivariance_eval(jmodel, cut, jimg, res, **kw)}

    tset = tds.get_dataset("RENI_LDR", test_dir, TRANSFORMS, False)
    tmodel = RENIModel(tck.load_model_config(ck))
    timg = tset.images_at(res, device="cpu")[:n]
    # the resize to 32 x 64 is torch's bilinear against cv2's: one float32
    # rounding apart (tests/test_torch_data.py), in [-1, 1] after normalize
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=2.4e-7)
    params = tparams.from_numpy(cut, "cpu")
    kw = dict(unnormalise=tset.unnormalise, is_hdr=False)
    got = {**tev.reconstruction_psnr(tmodel, params, timg, res, **kw),
           **tev.equivariance_eval(tmodel, params, timg, res, **kw)}
    for k, bar in (("psnr_mean", DB), ("rotated_reconstruction_psnr", DB), ("ssim_mean", SSIM)):
        assert abs(got[k] - ref[k]) <= bar, (k, got[k], ref[k])
    # the maps the latents were fitted to (31.5 dB here; the Test maps of a
    # set drawn with fewer training skies give about 12)
    assert got["psnr_mean"] > 25.0, got["psnr_mean"]
