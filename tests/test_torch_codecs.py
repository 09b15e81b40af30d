"""The port's remaining EXR codecs (ROADMAP A-6b) and its native decoder on
the CPU: PIZ, B44, B44A, DWAA and DWAB (``reni_tpu_torch/data/piz.py``,
``b44.py``, ``dwa.py``, routed by ``data/exr.py``) in HALF and FLOAT, on the
scanline, tiled and multi-part paths, at odd sizes (37 x 53, 1 x 1).

Every file the JAX writer writes decodes to the same bits through the
port's native decoder (``data/csrc/exr_decode.cpp``, the default), the
port's Python decoder (the oracle, ``force_python_decoder``) and both JAX
decoders; the port's writer writes the JAX writer's bytes. For the lossy
codecs the comparison is with JAX's decode, not with the source image.
Where the system OpenEXR is found (``tests/exr_oracle.py``) the port's
decode is also pinned to OpenEXR's own. The Python decoders of DWA take
about 0.5 s a 64 x 128 map, so the images here stay small."""

import struct

import numpy as np
import pytest

from reni_tpu.data import exr as je
from reni_tpu.data import piz as jpiz
from reni_tpu_torch.data import exr as te
from reni_tpu_torch.data import piz as tpiz

CODECS = ["PIZ", "B44", "B44A", "DWAA", "DWAB"]
LAYOUTS = ["scanline", "tiled", "multipart"]


def _image(seed=0, shape=(37, 53, 3)):
    """HDR-like float32 values over four decades, with zeros, negatives and
    values past the half range's fine steps."""
    rng = np.random.default_rng(seed)
    img = rng.lognormal(sigma=2.0, size=shape).astype(np.float32)
    img.reshape(-1)[::17] = 0.0
    img.reshape(-1)[5::23] *= -1.0
    return img


def _write(mod, layout, path, comp, pt, img):
    if layout == "scanline":
        mod.write(path, img, pixel_type=pt, compression=comp)
    elif layout == "tiled":  # 16 x 16 tiles over 37 x 53: clamped edge tiles
        mod.write_tiled(path, img, tile=(16, 16), pixel_type=pt, compression=comp)
    else:  # a grayscale part of another size before the RGB part
        mod.write_multipart(path, [img[:20, :30, :1], img], pixel_type=pt,
                            compressions=[comp, comp], names=["y", "sky"])


def _reads(path, layout):
    """(the port's native read, the port's Python read, JAX's native read,
    JAX's Python read) of each image part of the file."""
    parts = (0, 1) if layout == "multipart" else (0,)
    out = []
    for decoder in (te, je):
        out.append([decoder.read_part(path, p) for p in parts])
        with decoder.force_python_decoder():
            out.append([decoder.read_part(path, p) for p in parts])
    return out


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def _check_file(tmp_path, layout, comp, pt, img):
    theirs, ours = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    _write(je, layout, theirs, comp, pt, img)
    _write(te, layout, ours, comp, pt, img)
    with open(theirs, "rb") as f, open(ours, "rb") as g:
        assert f.read() == g.read(), "the port's writer did not write the JAX writer's bytes"
    native, python, jax_native, jax_python = _reads(theirs, layout)
    for part in range(len(native)):
        got = native[part]
        assert got.dtype == np.float32 and got.shape[-1] == 3 and np.isfinite(got).all()
        for name, ref in (("python", python), ("jax native", jax_native),
                          ("jax python", jax_python)):
            assert _same_bits(got, ref[part]), f"part {part}: native != {name}"
    return native[-1]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("comp", CODECS)
def test_codec_matches_jax(tmp_path, comp, pixel_type, layout):
    """37 x 53: the JAX writer's file decodes to the same bits through the
    port's native and Python decoders and both of JAX's (each part of a
    multi-part file); the port's writer gives the same bytes. PIZ is
    lossless; B44 keeps FLOAT channels raw."""
    img = _image(1)
    got = _check_file(tmp_path, layout, comp, pixel_type, img)
    if comp == "PIZ" or (comp.startswith("B44") and pixel_type == "float"):
        want = img if pixel_type == "float" else img.astype(np.float16).astype(np.float32)
        assert _same_bits(got, want)


@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("comp", CODECS)
def test_codec_one_pixel_matches_jax(tmp_path, comp, pixel_type):
    """A 1 x 1 image (one partial DCT block, one partial 4 x 4 block, a
    one-value wavelet): the same bits and bytes as above."""
    _check_file(tmp_path, "scanline", comp, pixel_type, _image(2, (1, 1, 3)))


@pytest.mark.parametrize("unit", ["lut", "wav2_14bit", "wav2_16bit", "huffman"])
def test_piz_units_match_jax(unit):
    """PIZ's pieces against reni_tpu/data/piz.py's: the value bitmap and its
    look-up tables, the 2D wavelet in place with the 14-bit and the 16-bit
    arithmetic, and the Huffman coder's bytes and decode."""
    rng = np.random.default_rng(3)
    if unit == "lut":
        data = rng.choice(rng.integers(0, 65536, 300), 2000).astype(np.uint16)
        bt, bj = tpiz.bitmap_from_data(data), jpiz.bitmap_from_data(data)
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(bt, bj))
        for fn in ("forward_lut_from_bitmap", "reverse_lut_from_bitmap"):
            ot, oj = getattr(tpiz, fn)(bt[0]), getattr(jpiz, fn)(bj[0])
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
                ot if isinstance(ot, tuple) else (ot,), oj if isinstance(oj, tuple) else (oj,)))
    elif unit.startswith("wav2"):
        max_value = 2**14 - 1 if unit == "wav2_14bit" else 65535
        a = rng.integers(0, max_value + 1, (13, 21)).astype(np.uint16)
        at, aj = a.copy(), a.copy()
        tpiz.wav2_encode(at, max_value)
        jpiz.wav2_encode(aj, max_value)
        assert np.array_equal(at, aj) and not np.array_equal(at, a)
        tpiz.wav2_decode(at, max_value)
        jpiz.wav2_decode(aj, max_value)
        assert np.array_equal(at, a) and np.array_equal(aj, a)
    else:
        data = np.minimum(rng.geometric(0.05, 5000), 400).astype(np.uint16)
        data[1000:1300] = 7  # a run for the run-length escape
        z = tpiz.huf_compress(data)
        assert z == jpiz.huf_compress(data)
        assert np.array_equal(tpiz.huf_uncompress(z, data.size), data)
        assert np.array_equal(jpiz.huf_uncompress(z, data.size), data)


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------


def test_native_decoder_is_the_default(tmp_path, monkeypatch):
    """read() goes through the native library unless the Python decoder is
    asked for, by force_python_decoder() or RENI_TPU_EXR_NATIVE=0."""
    path = str(tmp_path / "x.exr")
    te.write(path, _image(4), compression="PIZ")
    assert te._native() is te.library() and te.library_path().exists()
    calls = []
    python = te._decode_scanlines_python
    monkeypatch.setattr(te, "_decode_scanlines_python",
                        lambda *a: calls.append(1) or python(*a))
    te.read(path)
    assert calls == []
    with te.force_python_decoder():
        te.read(path)
    assert calls == [1] and te._native() is not None
    monkeypatch.setenv("RENI_TPU_EXR_NATIVE", "0")
    te.read(path)
    assert calls == [1, 1]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A native decoder that does not build raises with the compiler's
    output; nothing falls back to the Python decoder."""
    path = str(tmp_path / "x.exr")
    je.write(path, _image(5), compression="ZIP")
    monkeypatch.setattr(te, "_lib", None)
    monkeypatch.setattr(te, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(te, "GXX_FLAGS", te.GXX_FLAGS + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\\n)*no_such_header"):
        te.read(path)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("comp, code", [("PIZ", 6), ("DWAB", 9), ("ZIP", 4)])
def test_corrupt_payload_names_the_file(tmp_path, comp, code):
    """A payload that does not decompress raises ExrError naming the file
    and the native decoder's error at once; the Python decoder raises an
    ExrError naming the file too."""
    path = str(tmp_path / "bad.exr")
    img = np.full((37, 53, 3), 0.5, np.float32)
    img[::3] = 2.0
    je.write(path, img, compression=comp)
    data = bytearray(open(path, "rb").read())
    _, pos = te._parse_attrs(path, bytes(data), 8)
    first = struct.unpack_from("<q", data, pos)[0]  # the first chunk: y, size, payload
    size = struct.unpack_from("<i", data, first + 4)[0]
    # PIZ: a bitmap range past the bitmap; the others: the middle of the stream
    at = first + 8 + (0 if comp == "PIZ" else size // 2)
    data[at:at + 16] = b"\xff" * 16
    open(path, "wb").write(bytes(data))
    with pytest.raises(te.ExrError, match=f"bad.exr: corrupt EXR .*native decoder error {code}"):
        te.read(path)
    with te.force_python_decoder(), pytest.raises(te.ExrError, match="bad.exr"):
        te.read(path)


def test_truncated_framing_gives_the_python_message(tmp_path):
    """A file cut inside its chunk framing: the native decoder refuses it
    and the read raises the Python decoder's precise message."""
    path = str(tmp_path / "cut.exr")
    je.write(path, _image(6), compression="PIZ")
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) - 100])
    with pytest.raises(te.ExrError, match="cut.exr: truncated EXR — chunk 2/2"):
        te.read(path)


# ---------------------------------------------------------------------------
# the system OpenEXR, where it is found
# ---------------------------------------------------------------------------


@pytest.fixture()
def oracle():
    from tests import exr_oracle

    if not exr_oracle.available():
        pytest.skip("system OpenEXR (libopenexr-dev) not present")
    return exr_oracle


@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("comp", CODECS)
def test_decode_matches_openexr(tmp_path, oracle, comp, pixel_type):
    """OpenEXR's file decodes through the port's native decoder to OpenEXR's
    own decode, bit for bit; OpenEXR reads the port's file as the port
    does."""
    img = _image(7)
    theirs, ours = str(tmp_path / "openexr.exr"), str(tmp_path / "port.exr")
    oracle.write(theirs, img, compression=comp, pixel_type=pixel_type)
    assert _same_bits(te.read(theirs), oracle.read(theirs))
    te.write(ours, img, pixel_type=pixel_type, compression=comp)
    assert _same_bits(oracle.read(ours), te.read(ours))
