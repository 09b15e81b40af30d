"""OpenEXR reader and writer: the port's own copy of the codec of
``reni_tpu/data/exr.py`` (the port imports nothing of the JAX package),
which replaces the reference's native OpenEXR dependency (reference:
src/data/datasets.py:80).

The reader and writer give the JAX package's results bit for bit: a file
either package writes decodes to the same float32 image in both, and both
writers give the same bytes for the same image (tests/test_torch_data.py,
tests/test_torch_codecs.py).

The header is parsed here in Python; the chunks are decoded by the native
decoder ``csrc/exr_decode.cpp`` (the port's copy of the JAX package's
``native/exr_decode.cpp``: zlib inflate, RLE, PIZ, PXR24, B44 and DWA,
HALF to float, the scatter into the image, chunks on a few threads, the GIL
released by ``ctypes``, so the datasets' thread pool over files scales). It
is built with ``g++ -O3 -shared -fPIC -ffp-contract=off ... -lz`` at first
use into ``build/reni_tpu_torch/exr_decode-<hash>.so`` at the repository
root, keyed by a hash of the source and the flags, and loaded with
``ctypes``. ``-ffp-contract=off`` keeps the DWA inverse DCT bit for bit the
numpy float32 code of ``data/dwa.py``. A failed build raises, with the
compiler's output: nothing falls back to Python. The Python decoder runs
only when asked, by ``force_python_decoder()`` or ``RENI_TPU_EXR_NATIVE=0``
(the JAX package's names); it is the tests' oracle.

Where the native decoder refuses a chunk's framing (its errors 1 and 2) the
Python decoder is run for its precise message, and if it reads the file
after all, an ``ExrError`` says that the two disagree: the JAX package
returns the Python decode there instead (a difference kept on purpose). A
corrupt payload (errors 3-9) raises ``ExrError`` naming the file at once.

Supported:
- single-part scanline images, version 2
- single-part TILED images (ONE_LEVEL, and the level-0 plane of MIPMAP
  pyramids)
- MULTI-PART files (version bit 0x1000): ``read`` returns the first
  scanline/tiled image part (what OpenEXR-based readers return),
  ``read_part``/``write_multipart`` expose the rest; deep parts rejected
- pixel types HALF, FLOAT and UINT; channels R, G, B (A and Y read too)
- compression: NONE, RLE (1 line/chunk), ZIPS (1), ZIP (16), PIZ (32,
  ``data/piz.py``), PXR24 (16; lossless for HALF/UINT, 24-bit-rounded for
  FLOAT by design), B44 and B44A (32; lossy 4x4-block HALF packing,
  ``data/b44.py``), DWAA (32) and DWAB (256; lossy DCT, ``data/dwa.py``)
- both line orders (every chunk carries its own y)

Unsupported (raises): deep data, RIPMAP tiling.

Format reference: the public OpenEXR file-format documentation
(openexr.com/en/latest/OpenEXRFileLayout.html).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
# NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB
_COMPRESSION_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32, 8: 32, 9: 256}
_COMPRESSION_NAMES = {
    0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ", 5: "PXR24",
    6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB",
}

# -- the native decoder ----------------------------------------------------

SOURCE = Path(__file__).resolve().parent / "csrc" / "exr_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "reni_tpu_torch"
# -ffp-contract=off: the DWA inverse DCT must round exactly as the numpy
# float32 operations it is pinned to (no FMA contraction)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
GXX_LIBS = ("-lz",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_python_only = False  # force_python_decoder()

# the native decoder's errors 3-9: a chunk PAYLOAD failed to decompress
_NATIVE_PAYLOAD_ERRORS = {
    3: "chunk stored raw but shorter than its scanlines",
    4: "zlib inflate failed",
    5: "RLE decode failed",
    6: "PIZ decode failed",
    7: "PXR24 decode failed",
    8: "B44 decode failed",
    9: "DWA decode failed",
}


def library_path() -> Path:
    """Where ``csrc/exr_decode.cpp`` builds to (the hash covers the source and
    the flags)."""
    key = SOURCE.read_bytes() + " ".join(GXX_FLAGS + GXX_LIBS).encode()
    return BUILD_DIR / f"exr_decode-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native decoder unless its library is already built;
    raises RuntimeError with the compiler's output when ``g++`` fails."""
    from reni_tpu_torch.kernels import _build
    from reni_tpu_torch.utils import progress

    out = library_path()
    if out.exists():
        return out
    with _build.name_lock(str(out)):
        if out.exists():  # another thread built it meanwhile
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _build.temporary(out)
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS]
        try:
            progress.note("g++ exr_decode")
            res = subprocess.run(cmd, capture_output=True, text=True)
            progress.note("g++ exr_decode done")
        except FileNotFoundError as e:
            raise RuntimeError(f"the native EXR decoder needs g++: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
        return out


def library() -> ctypes.CDLL:
    """The loaded native decoder, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            common = [
                ctypes.c_int,  # compression
                ctypes.c_int,  # width
                ctypes.c_int,  # height
            ]
            channels = [
                ctypes.c_int,  # n_file_channels
                ctypes.POINTER(ctypes.c_int32),  # ch_ptypes
                ctypes.POINTER(ctypes.c_int32),  # ch_out
                ctypes.c_int,  # out_channels
                ctypes.POINTER(ctypes.c_float),  # out
                ctypes.c_int,  # n_threads (0: the host's cores)
                ctypes.c_char_p,  # ch_names (NUL-separated, file order)
                ctypes.POINTER(ctypes.c_uint16),  # DWA toLinear table (or None)
            ]
            lib.exr_decode_chunks.argtypes = [
                ctypes.c_char_p,  # data
                ctypes.c_longlong,  # data_size
                ctypes.c_longlong,  # pos (first chunk offset)
                ctypes.c_int,  # n_chunks
                ctypes.c_int,  # lines_per_chunk
                *common,
                ctypes.c_int,  # ymin
                *channels,
            ]
            lib.exr_decode_chunks.restype = ctypes.c_int
            lib.exr_decode_tiles.argtypes = [
                ctypes.c_char_p,  # data
                ctypes.c_longlong,  # data_size
                ctypes.POINTER(ctypes.c_longlong),  # tile-chunk offsets
                ctypes.c_int,  # n_offsets
                ctypes.c_int,  # tile x size
                ctypes.c_int,  # tile y size
                *common,
                *channels,
            ]
            lib.exr_decode_tiles.restype = ctypes.c_int
            _lib = lib
        return _lib


@contextlib.contextmanager
def force_python_decoder():
    """Decode with the Python decoder inside the block (the tests' oracle).
    Not thread-safe with reads on other threads."""
    global _python_only
    saved = _python_only
    _python_only = True
    try:
        yield
    finally:
        _python_only = saved


def _native() -> ctypes.CDLL | None:
    """The native decoder, or None where the Python decoder was asked for."""
    if _python_only or os.environ.get("RENI_TPU_EXR_NATIVE", "1") == "0":
        return None
    return library()


class _NativeArgs:
    """The channel and output marshalling of both native entry points. Holds
    the numpy arrays so that their buffers outlive the ctypes call; for DWA
    it carries the toLinear table of ``data/dwa.py``, so that both decoders
    index the same table."""

    def __init__(self, channels, compression, width, height):
        ch_names = [c[0] for c in channels]
        self.out_names, self.replicate_y = _select_channels(ch_names)
        out_index = {n: i for i, n in enumerate(self.out_names)}
        # zeros: a malformed file whose chunks do not cover every row must
        # never expose uninitialised memory
        self.out = np.zeros((height, width, len(self.out_names)), dtype=np.float32)
        self._ptypes = np.asarray([pt for _, pt, _, _ in channels], dtype=np.int32)
        self._chout = np.asarray([out_index.get(n, -1) for n in ch_names], dtype=np.int32)
        self.names_blob = b"".join(n.encode("latin-1") + b"\0" for n in ch_names)
        self.table_ptr = None
        if compression in (8, 9):
            from reni_tpu_torch.data import dwa

            self._to_linear = np.ascontiguousarray(dwa._tables()[0])
            self.table_ptr = self._to_linear.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))

    def channel_args(self, n_channels: int) -> tuple:
        return (
            n_channels,
            self._ptypes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._chout.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.out_names),
            self.out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            0,
            self.names_blob,
            self.table_ptr,
        )

    def result(self) -> np.ndarray:
        return np.repeat(self.out, 3, axis=-1) if self.replicate_y else self.out


def _native_refused(path: str, rc: int, python_decode) -> None:
    """Raise for a native decoder error ``rc``: a corrupt payload at once;
    otherwise the Python decoder's precise message, or, where the Python
    decoder reads the file after all, the disagreement."""
    if rc in _NATIVE_PAYLOAD_ERRORS:
        raise ExrError(f"{path}: corrupt EXR — {_NATIVE_PAYLOAD_ERRORS[rc]} "
                       f"(native decoder error {rc})")
    python_decode()
    raise ExrError(f"{path}: the native decoder refused the file (error {rc}) that the Python "
                   "decoder reads")

# -- PXR24 (compression id 5): per-row byte-planed deltas + deflate --------
#
# Each scanline's channel row becomes MSB-first byte planes of the
# HORIZONTAL first difference of its values (HALF: 16-bit kept, lossless;
# FLOAT: rounded to a 24-bit float, lossy by design; UINT: 32-bit kept),
# and the whole chunk deflates. Published format: ImfPxr24Compressor.


def _float_to_f24(bits: np.ndarray) -> np.ndarray:
    """f32 bit patterns -> 24-bit float bit patterns (1s + 8e + 15m),
    round-to-nearest-even; NaN keeps >=1 significand bit so it does not
    collapse to infinity."""
    bits = bits.astype(np.uint32)
    s = bits & 0x80000000
    e = bits & 0x7F800000
    m = bits & 0x007FFFFF
    inf_nan = e == 0x7F800000
    nan_m = m >> 9
    nan24 = (s >> 8) | 0x7F8000 | np.where(m != 0, np.where(nan_m != 0, nan_m, 1), 0)
    fin24 = (s >> 8) | (((e | m) + ((m >> 7) & 1) + 0x7F) >> 8)
    return np.where(inf_nan, nan24, fin24).astype(np.uint32)


def _pxr24_plane_widths(ptype: int) -> int:
    return {0: 4, 1: 2, 2: 3}[ptype]  # bytes per value in the plane stack


def _pxr24_uncompress(payload: bytes, channels, width: int, nrows: int) -> bytes:
    data = np.frombuffer(zlib.decompress(payload), dtype=np.uint8)
    out = []
    pos = 0
    for _ in range(nrows):
        for _, pt, _, _ in channels:
            nb = _pxr24_plane_widths(pt)
            planes = []
            for k in range(nb):
                planes.append(data[pos : pos + width].astype(np.uint64))
                pos += width
            diffs = planes[0]
            for p in planes[1:]:
                diffs = (diffs << 8) | p
            mask = (1 << (8 * nb)) - 1
            vals = np.cumsum(diffs) & mask
            if pt == 1:  # HALF, lossless
                out.append(vals.astype("<u2").tobytes())
            elif pt == 2:  # FLOAT: f24 bits << 8
                out.append((vals << 8).astype("<u4").tobytes())
            else:  # UINT
                out.append(vals.astype("<u4").tobytes())
    return b"".join(out)


def _pxr24_compress(raw: bytes, channels, width: int, nrows: int) -> bytes:
    src = memoryview(raw)
    planes_out = []
    pos = 0
    for _ in range(nrows):
        for _, pt, _, _ in channels:
            nb = _pxr24_plane_widths(pt)
            if pt == 1:
                vals = np.frombuffer(src, "<u2", width, pos).astype(np.uint64)
                pos += 2 * width
            elif pt == 2:
                bits = np.frombuffer(src, "<u4", width, pos)
                pos += 4 * width
                vals = _float_to_f24(bits).astype(np.uint64)
            else:
                vals = np.frombuffer(src, "<u4", width, pos).astype(np.uint64)
                pos += 4 * width
            mask = (1 << (8 * nb)) - 1
            diffs = np.empty_like(vals)
            diffs[0] = vals[0]
            diffs[1:] = (vals[1:] - vals[:-1]) & mask
            for k in range(nb):
                planes_out.append(
                    ((diffs >> (8 * (nb - 1 - k))) & 0xFF).astype(np.uint8)
                )
    return zlib.compress(np.concatenate(planes_out).tobytes())


def _rle_uncompress(payload: bytes) -> bytes:
    """OpenEXR RLE (ImfRle.cpp rleUncompress): signed count byte — negative
    n copies -n literal bytes, non-negative n repeats the next byte n+1
    times. The result still carries the ZIP pre-filter."""
    out = bytearray()
    i, n = 0, len(payload)
    while i < n:
        b = payload[i]
        i += 1
        if b > 127:  # signed negative: literal run
            count = 256 - b
            if i + count > n:
                raise ExrError("corrupt RLE chunk (literal overrun)")
            out += payload[i : i + count]
            i += count
        else:
            if i >= n:
                raise ExrError("corrupt RLE chunk (missing run byte)")
            out += payload[i : i + 1] * (b + 1)
            i += 1
    return bytes(out)


def _rle_compress(data: bytes) -> bytes:
    """OpenEXR RLE (ImfRle.cpp rleCompress): runs of >=3 equal bytes become
    (count-1, byte); literal stretches become (-count, bytes...)."""
    MAX_RUN, MIN_RUN = 127, 3
    out = bytearray()
    n = len(data)
    rs, re = 0, 1
    while rs < n:
        while re < n and data[rs] == data[re] and re - rs - 1 < MAX_RUN:
            re += 1
        if re - rs >= MIN_RUN:
            out.append(re - rs - 1)
            out.append(data[rs])
            rs = re
        else:
            while (
                re < n
                and (
                    (re + 1 >= n or data[re] != data[re + 1])
                    or (re + 2 >= n or data[re + 1] != data[re + 2])
                )
                and re - rs < MAX_RUN
            ):
                re += 1
            out.append(256 - (re - rs))  # negative literal count
            out += data[rs:re]
            rs = re
        re += 1
    return bytes(out)


class ExrError(ValueError):
    pass


def _read_cstring(buf: memoryview, pos: int) -> tuple[str, int]:
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode("latin-1"), end + 1


def _parse_channels(data: bytes):
    channels = []
    mv = memoryview(data)
    pos = 0
    while mv[pos] != 0:
        name, pos = _read_cstring(mv, pos)
        ptype, xs, ys = struct.unpack_from("<i4xii", data, pos)
        pos += 16
        channels.append((name, ptype, xs, ys))
    return channels


def _unpredict_deinterleave(raw: bytes) -> np.ndarray:
    """Invert the EXR ZIP pre-filter: delta-decode, then de-interleave the
    two halves (ImfZip.cpp uncompress path)."""
    arr = np.frombuffer(raw, dtype=np.uint8).astype(np.int16)
    arr[1:] -= 128
    arr = np.cumsum(arr, dtype=np.int64).astype(np.uint8)
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out


def _predict_interleave(data: np.ndarray) -> bytes:
    """The forward ZIP pre-filter (ImfZip.cpp compress path)."""
    n = data.size
    half = (n + 1) // 2
    tmp = np.empty(n, dtype=np.uint8)
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return d.astype(np.uint8).tobytes()


def _decode_payload(payload, compression, channels, width, nrows):
    """One compressed chunk/tile payload -> scanline-interleaved raw bytes
    (per row, each channel's run in file order)."""
    raw_size = nrows * width * sum(
        np.dtype(_PIXEL_DTYPES[pt]).itemsize for _, pt, _, _ in channels
    )
    if compression == 0 or len(payload) >= raw_size:
        # uncompressed, or the writer stored the chunk raw (any compressor
        # whose output would not shrink). Slice to the exact scanline size:
        # a SHORT uncompressed payload (a truncated file) must reach the
        # caller's size check as-is and fail there with chunk coordinates
        return np.frombuffer(payload, dtype=np.uint8)[:raw_size]
    if compression == 1:
        return _unpredict_deinterleave(_rle_uncompress(payload))
    if compression == 4:
        from reni_tpu_torch.data import piz

        ptypes = [pt for _, pt, _, _ in channels]
        return np.frombuffer(piz.decompress(payload, ptypes, width, nrows), dtype=np.uint8)
    if compression == 5:
        return np.frombuffer(
            _pxr24_uncompress(payload, channels, width, nrows), dtype=np.uint8
        )
    if compression in (6, 7):
        from reni_tpu_torch.data import b44

        ptypes = [pt for _, pt, _, _ in channels]
        return np.frombuffer(b44.decompress(payload, ptypes, width, nrows), dtype=np.uint8)
    if compression in (8, 9):
        from reni_tpu_torch.data import dwa

        named = [(n, pt) for n, pt, _, _ in channels]
        return np.frombuffer(dwa.decompress(payload, named, width, nrows), dtype=np.uint8)
    return _unpredict_deinterleave(zlib.decompress(payload))


def _scatter_rows(raw, planes, ch_names, ch_dtypes, r0, x0, width, nrows):
    """Scanline-interleaved raw bytes of ``nrows`` rows of ``width`` pixels
    (each row: every channel's run in file order) into the float32 planes at
    row ``r0``, column ``x0``."""
    rows = raw.reshape(nrows, -1)
    off = 0
    for name, dt in zip(ch_names, ch_dtypes):
        nbytes = width * dt.itemsize
        vals = rows[:, off : off + nbytes].copy().view(dt)
        planes[name][r0 : r0 + nrows, x0 : x0 + width] = vals.astype(np.float32)
        off += nbytes


def _result(planes, ch_names):
    out_names, replicate_y = _select_channels(ch_names)
    if replicate_y:
        return np.repeat(planes[out_names[0]][..., None], 3, axis=-1)
    return np.stack([planes[n] for n in out_names], axis=-1)


def _select_channels(ch_names):
    """(out_names, replicate_y): RGB[A] by name, else a single luminance
    channel replicated to 3, else file order."""
    upper = {n.upper(): n for n in ch_names}
    if all(c in upper for c in "RGB"):
        out_names = [upper["R"], upper["G"], upper["B"]]
        if "A" in upper:
            out_names.append(upper["A"])
        return out_names, False
    if "Y" in upper:
        return [upper["Y"]], True
    return list(ch_names), False


def _part_geometry(path: str, attrs):
    """Shared per-(part-)header validation -> (channels, compression,
    width, height, ymin)."""
    channels = _parse_channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    if compression not in _COMPRESSION_NAMES:
        raise ExrError(
            f"{path}: unknown compression id {compression} (the format defines ids 0-9: "
            "NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB)"
        )
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = xmax - xmin + 1, ymax - ymin + 1
    if any(xs != 1 or ys != 1 for _, _, xs, ys in channels):
        raise ExrError(f"{path}: subsampled channels not supported")
    return channels, compression, width, height, ymin


def read(path: str) -> np.ndarray:
    """Read an EXR file -> float32 array (H, W, C) with channels ordered
    R, G, B[, A] (or a single luminance channel replicated to 3). For a
    multi-part file, the first scanline/tiled image part (the part an
    OpenEXR-based reader like the reference's imageio path returns).

    Every decode failure raises ``ExrError`` carrying the file path."""
    with open(path, "rb") as f:
        data = f.read()
    return _guarded_decode(path, lambda: _read_bytes(path, data))


def _guarded_decode(path: str, fn):
    """Run a decode, converting any non-ExrError codec exception (short
    struct unpacks, zlib errors, codec index/value errors on malformed
    bit-streams) into an ExrError that names the file."""
    try:
        return fn()
    except ExrError:
        raise
    except (
        struct.error, zlib.error, ValueError, IndexError, KeyError,
        OverflowError,
    ) as e:
        raise ExrError(
            f"{path}: corrupt or truncated EXR "
            f"({type(e).__name__}: {e})"
        ) from e


def _parse_attrs(path: str, data: bytes, pos: int):
    """One attribute list (terminated by an empty name) -> (attrs, pos).
    Sizes are validated so a corrupt negative size cannot rewind the
    cursor (which would reparse the same bytes forever)."""
    attrs = {}
    mv = memoryview(data)
    while mv[pos] != 0:
        name, pos = _read_cstring(mv, pos)
        _type, pos = _read_cstring(mv, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if size < 0 or pos + size > len(data):
            raise ExrError(f"{path}: corrupt attribute size for {name!r}")
        attrs[name] = (_type, data[pos : pos + size])
        pos += size
    return attrs, pos + 1  # consume the terminator


def _read_bytes(path: str, data: bytes) -> np.ndarray:
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ExrError(f"{path}: not an EXR file")
    if version & 0x800:
        raise ExrError(f"{path}: deep EXR not supported")
    if version & 0x1000:
        return _read_multipart(path, data)

    attrs, pos = _parse_attrs(path, data, 8)
    channels, compression, width, height, ymin = _part_geometry(path, attrs)

    if version & 0x200:  # single-part tiled image
        return _read_tiled(
            path, data, pos, attrs, channels, compression, width, height
        )

    lines_per_chunk = _COMPRESSION_LINES[compression]
    n_chunks = -(-height // lines_per_chunk)
    # skip the offset table; chunks follow in order for increasing-y files
    pos += 8 * n_chunks
    return _decode_scanlines(
        path, data, pos, n_chunks, channels, compression, width, height, ymin
    )


def _decode_scanlines(
    path, data, pos, n_chunks, channels, compression, width, height, ymin
) -> np.ndarray:
    """Decode n_chunks scanline chunks ((y, size, payload) framing starting
    at ``pos``) into the output image: the native decoder unless the Python
    decoder was asked for."""
    args = (path, data, pos, n_chunks, channels, compression, width, height, ymin)
    lib = _native()
    if lib is None:
        return _decode_scanlines_python(*args)
    na = _NativeArgs(channels, compression, width, height)
    rc = lib.exr_decode_chunks(
        data, len(data), pos, n_chunks, _COMPRESSION_LINES[compression], compression,
        width, height, ymin, *na.channel_args(len(channels)),
    )
    if rc:
        _native_refused(path, rc, lambda: _decode_scanlines_python(*args))
    return na.result()


def _decode_scanlines_python(
    path, data, pos, n_chunks, channels, compression, width, height, ymin
) -> np.ndarray:
    """The Python decoder of ``_decode_scanlines``."""
    lines_per_chunk = _COMPRESSION_LINES[compression]
    ch_dtypes = [np.dtype(_PIXEL_DTYPES[pt]).newbyteorder("<") for _, pt, _, _ in channels]
    ch_names = [c[0] for c in channels]
    planes = {n: np.zeros((height, width), dtype=np.float32) for n in ch_names}
    bytes_per_row = width * sum(dt.itemsize for dt in ch_dtypes)
    for k in range(n_chunks):
        if pos + 8 > len(data):
            raise ExrError(
                f"{path}: truncated EXR — file ends inside chunk "
                f"{k + 1}/{n_chunks}'s (y, size) framing"
            )
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        if size < 0 or pos + size > len(data):
            raise ExrError(
                f"{path}: truncated EXR — chunk {k + 1}/{n_chunks} (y={y}) "
                f"claims {size} payload bytes but only "
                f"{len(data) - pos} remain"
            )
        payload = data[pos : pos + size]
        pos += size
        row0 = y - ymin
        if not 0 <= row0 < height:
            raise ExrError(
                f"{path}: scanline chunk y={y} outside the data window "
                f"[{ymin}, {ymin + height - 1}]"
            )
        nrows = min(lines_per_chunk, height - row0)
        raw = _decode_payload(payload, compression, channels, width, nrows)
        if raw.size != nrows * bytes_per_row:
            raise ExrError(
                f"{path}: corrupt EXR — chunk {k + 1}/{n_chunks} (y={y}, "
                f"{_COMPRESSION_NAMES[compression]}) decoded to {raw.size} "
                f"bytes, expected {nrows * bytes_per_row} "
                f"({nrows} rows x {bytes_per_row} B)"
            )
        _scatter_rows(raw, planes, ch_names, ch_dtypes, row0, 0, width, nrows)
    return _result(planes, ch_names)


def _mip_levels(width: int, height: int, round_up: bool) -> int:
    """Number of mipmap levels (ImfTiledMisc calculateNumLevels)."""
    import math

    m = max(width, height)
    lv = math.ceil(math.log2(m)) if round_up else math.floor(math.log2(m))
    return int(lv) + 1


def _level_size(s: int, level: int, round_up: bool) -> int:
    d = s / (1 << level)
    return max(1, int(-(-d // 1)) if round_up else int(d))


def _read_tiled(path, data, pos, attrs, channels, compression, width, height):
    """Single-part tiled image (version bit 0x200): ONE_LEVEL or the level-0
    plane of a MIPMAP pyramid (the lower mips are redundant with the
    full-resolution data; RIPMAP is rejected). Each tile chunk is
    (dx, dy, lx, ly, size, payload) with the payload compressed exactly like
    a scanline chunk of the tile's dimensions."""
    if "tiles" not in attrs:
        raise ExrError(f"{path}: tiled flag set but no 'tiles' attribute")
    txs, tys, mode = struct.unpack_from("<IIB", attrs["tiles"][1], 0)
    level_mode = mode & 0xF
    round_up = (mode >> 4) == 1
    if level_mode == 2:
        raise ExrError(f"{path}: RIPMAP tiled EXR not supported")
    if level_mode == 0:
        n_offsets = (-(-width // txs)) * (-(-height // tys))
    else:  # MIPMAP: offsets for every level's tile grid
        n_offsets = 0
        for lv in range(_mip_levels(width, height, round_up)):
            lw = _level_size(width, lv, round_up)
            lh = _level_size(height, lv, round_up)
            n_offsets += (-(-lw // txs)) * (-(-lh // tys))
    offsets = struct.unpack_from(f"<{n_offsets}q", data, pos)
    return _decode_tiles(
        path, data, offsets, txs, tys, channels, compression, width, height
    )


def _decode_tiles(
    path, data, offsets, txs, tys, channels, compression, width, height
) -> np.ndarray:
    """Decode tile chunks ((dx, dy, lx, ly, size, payload) framing at the
    given ``offsets``; non-level-0 tiles skipped) into the output image: the
    native decoder unless the Python decoder was asked for."""
    args = (path, data, offsets, txs, tys, channels, compression, width, height)
    lib = _native()
    if lib is None:
        return _decode_tiles_python(*args)
    na = _NativeArgs(channels, compression, width, height)
    offs = np.asarray(offsets, dtype=np.int64)
    rc = lib.exr_decode_tiles(
        data, len(data), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(offs),
        txs, tys, compression, width, height, *na.channel_args(len(channels)),
    )
    if rc:
        _native_refused(path, rc, lambda: _decode_tiles_python(*args))
    return na.result()


def _decode_tiles_python(
    path, data, offsets, txs, tys, channels, compression, width, height
) -> np.ndarray:
    """The Python decoder of ``_decode_tiles``."""
    ch_names = [c[0] for c in channels]
    ch_dtypes = [
        np.dtype(_PIXEL_DTYPES[pt]).newbyteorder("<") for _, pt, _, _ in channels
    ]
    planes = {n: np.zeros((height, width), dtype=np.float32) for n in ch_names}
    itembytes = sum(dt.itemsize for dt in ch_dtypes)
    for off in offsets:
        if off < 0 or off + 20 > len(data):
            raise ExrError(
                f"{path}: truncated EXR — tile chunk offset {off} outside "
                f"the file ({len(data)} bytes)"
            )
        dx, dy, lx, ly, size = struct.unpack_from("<5i", data, off)
        if lx or ly:
            continue  # lower mip level: redundant with level 0
        if size < 0 or off + 20 + size > len(data):
            raise ExrError(
                f"{path}: truncated EXR — tile ({dx},{dy}) claims {size} "
                f"payload bytes but only {len(data) - off - 20} remain"
            )
        payload = data[off + 20 : off + 20 + size]
        x0, y0 = dx * txs, dy * tys
        tw = min(txs, width - x0)
        th = min(tys, height - y0)
        if dx < 0 or dy < 0 or tw <= 0 or th <= 0:
            raise ExrError(f"{path}: tile ({dx},{dy}) outside the data window")
        raw = _decode_payload(payload, compression, channels, tw, th)
        if raw.size != th * tw * itembytes:
            raise ExrError(
                f"{path}: corrupt EXR — tile ({dx},{dy}) "
                f"({_COMPRESSION_NAMES[compression]}) decoded to {raw.size} "
                f"bytes, expected {th * tw * itembytes} ({th}x{tw} px)"
            )
        _scatter_rows(raw, planes, ch_names, ch_dtypes, y0, x0, tw, th)
    return _result(planes, ch_names)


def _read_multipart(path: str, data: bytes, *, part: int | None = None) -> np.ndarray:
    """Multi-part EXR (version bit 0x1000). Decodes the first
    scanline/tiled image part — the part an OpenEXR-based reader (the
    reference's imageio path, src/data/datasets.py:80) returns — or the
    explicitly requested ``part`` index. Deep parts are skipped/rejected.

    Layout (OpenEXR 2.0 multi-part): per-part headers each terminated by an
    empty attribute name, then one extra NUL ending the header list; one
    offset table per part (``chunkCount`` int64 entries); every chunk is
    prefixed with its part number (int32) before the regular scanline
    (y, size, payload) or tile (dx, dy, lx, ly, size, payload) framing."""
    mv = memoryview(data)
    pos = 8
    headers: list[dict] = []
    while True:
        if mv[pos] == 0:  # empty header: end of the header list
            pos += 1
            break
        attrs, pos = _parse_attrs(path, data, pos)
        headers.append(attrs)

    tables = []
    for attrs in headers:
        (cc,) = struct.unpack("<i", attrs["chunkCount"][1])
        if cc < 0 or pos + 8 * cc > len(data):
            raise ExrError(f"{path}: corrupt chunkCount")
        tables.append(struct.unpack_from(f"<{cc}q", data, pos))
        pos += 8 * cc

    def part_type(attrs) -> str:
        return attrs["type"][1].split(b"\0")[0].decode("latin-1")

    if part is None:
        sel = next(
            (
                i
                for i, a in enumerate(headers)
                if part_type(a) in ("scanlineimage", "tiledimage")
            ),
            None,
        )
        if sel is None:
            raise ExrError(
                f"{path}: multi-part file has no scanline/tiled image part "
                "(deep parts are not supported)"
            )
    else:
        if not 0 <= part < len(headers):
            raise ExrError(f"{path}: part {part} out of range ({len(headers)} parts)")
        sel = part
        if part_type(headers[sel]) not in ("scanlineimage", "tiledimage"):
            raise ExrError(
                f"{path}: part {part} is {part_type(headers[sel])!r} — deep "
                "parts are not supported"
            )

    attrs = headers[sel]
    channels, compression, width, height, ymin = _part_geometry(path, attrs)

    # rebuild a single-part chunk stream with the part-number prefix
    # stripped, so the scanline/tile decoders apply as-is
    if part_type(attrs) == "tiledimage":
        if "tiles" not in attrs:
            raise ExrError(f"{path}: tiled part without a 'tiles' attribute")
        txs, tys, mode = struct.unpack_from("<IIB", attrs["tiles"][1], 0)
        if mode & 0xF == 2:
            raise ExrError(f"{path}: RIPMAP tiled EXR not supported")
        # the header's chunkCount must cover the full tile grid, or the
        # decode would silently return uninitialized output rows
        round_up = (mode >> 4) == 1
        if mode & 0xF == 0:
            expected = (-(-width // txs)) * (-(-height // tys))
        else:
            expected = sum(
                (-(-_level_size(width, lv, round_up) // txs))
                * (-(-_level_size(height, lv, round_up) // tys))
                for lv in range(_mip_levels(width, height, round_up))
            )
        if len(tables[sel]) != expected:
            raise ExrError(
                f"{path}: part {sel} chunkCount {len(tables[sel])} != "
                f"expected {expected} tiles"
            )
        parts, offs, cursor = [], [], 0
        for off in tables[sel]:
            (pn,) = struct.unpack_from("<i", data, off)
            if pn != sel:
                raise ExrError(f"{path}: chunk/part number mismatch")
            (size,) = struct.unpack_from("<i", data, off + 20)
            chunk = data[off + 4 : off + 24 + size]
            offs.append(cursor)
            parts.append(chunk)
            cursor += len(chunk)
        return _decode_tiles(
            path, b"".join(parts), offs, txs, tys, channels, compression,
            width, height,
        )

    expected = -(-height // _COMPRESSION_LINES[compression])
    if len(tables[sel]) != expected:
        raise ExrError(
            f"{path}: part {sel} chunkCount {len(tables[sel])} != "
            f"expected {expected} scanline chunks"
        )
    parts = []
    for off in tables[sel]:
        (pn,) = struct.unpack_from("<i", data, off)
        if pn != sel:
            raise ExrError(f"{path}: chunk/part number mismatch")
        (size,) = struct.unpack_from("<i", data, off + 8)
        parts.append(data[off + 4 : off + 12 + size])
    return _decode_scanlines(
        path, b"".join(parts), 0, len(tables[sel]), channels, compression,
        width, height, ymin,
    )


def read_part(path: str, part: int) -> np.ndarray:
    """Read one image part of a multi-part EXR by index (``read`` returns
    the first image part); single-part files accept only part 0."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ExrError(f"{path}: not an EXR file")
    if not version & 0x1000:
        if part != 0:
            raise ExrError(f"{path}: single-part file has only part 0")
        return _guarded_decode(path, lambda: _read_bytes(path, data))
    return _guarded_decode(path, lambda: _read_multipart(path, data, part=part))


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + atype.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def _compress_payload(
    raw: bytes, comp: int, ptype: int, names, width: int, nrows: int
) -> bytes:
    """Compress one chunk/tile of scanline-interleaved raw bytes; falls back
    to storing raw when the compressor does not shrink (the reader treats
    payload >= raw size as uncompressed)."""
    if comp == 0:
        return raw
    if comp == 1:
        z = _rle_compress(_predict_interleave(np.frombuffer(raw, np.uint8)))
    elif comp == 4:
        from reni_tpu_torch.data import piz

        z = piz.compress(raw, [ptype] * len(names), width, nrows)
    elif comp == 5:
        z = _pxr24_compress(
            raw, [(n, ptype, 1, 1) for n in names], width, nrows
        )
    elif comp in (6, 7):
        from reni_tpu_torch.data import b44

        z = b44.compress(raw, [ptype] * len(names), width, nrows, comp == 7)
    elif comp in (8, 9):
        from reni_tpu_torch.data import dwa

        z = dwa.compress(raw, [(n, ptype) for n in names], width, nrows)
    else:
        z = zlib.compress(_predict_interleave(np.frombuffer(raw, np.uint8)))
    return z if len(z) < len(raw) else raw


# writer-side compression name -> id (read side: _COMPRESSION_NAMES)
_COMP_IDS = {
    "NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3, "PIZ": 4, "PXR24": 5,
    "B44": 6, "B44A": 7, "DWAA": 8, "DWAB": 9,
}


def _prep_image(img, fn_name: str):
    """(img, channel names) for the writers: grayscale -> Y, RGB stored
    name-sorted (B, G, R)."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    nch = img.shape[-1]
    if nch == 1:
        return img, ["Y"]
    if nch == 3:
        return img[..., ::-1], ["B", "G", "R"]
    raise ExrError(f"{fn_name} supports 1 or 3 channels")


def _common_header_attrs(ch_names, ptype, comp, width, height) -> bytes:
    """The attribute block every (part) header shares."""
    chan_entries = b""
    for n in ch_names:
        chan_entries += n.encode() + b"\0" + struct.pack("<i4xii", ptype, 1, 1)
    chan_entries += b"\0"
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    return (
        _attr("channels", "chlist", chan_entries)
        + _attr("compression", "compression", bytes([comp]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\0")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    )


def _raw_rows(img, dt) -> bytes:
    """(rows, W, C) -> scanline-interleaved raw bytes: per row, each
    channel's run."""
    return np.ascontiguousarray(np.transpose(img, (0, 2, 1)).astype(dt)).tobytes()


def _encode_scanline_chunks(img, ch_names, ptype, comp):
    """(H, W, C) image -> [(row0, compressed payload)] scanline chunks."""
    height, width = img.shape[:2]
    dt = np.dtype(_PIXEL_DTYPES[ptype]).newbyteorder("<")
    lines_per_chunk = _COMPRESSION_LINES[comp]
    chunks = []
    for c in range(-(-height // lines_per_chunk)):
        row0 = c * lines_per_chunk
        nrows = min(lines_per_chunk, height - row0)
        raw = _raw_rows(img[row0 : row0 + nrows], dt)
        payload = _compress_payload(raw, comp, ptype, ch_names, width, nrows)
        chunks.append((row0, payload))
    return chunks


def write(path: str, img: np.ndarray, *, pixel_type: str = "half", compression: str = "ZIP"):
    """Write (H, W, 3|1) float array as a scanline EXR (RGB or Y).
    Compressions: NONE, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB."""
    img, names = _prep_image(img, "write")
    height, width = img.shape[:2]
    ptype = 1 if pixel_type == "half" else 2
    comp = _COMP_IDS[compression]

    header = struct.pack("<ii", _MAGIC, 2)
    header += _common_header_attrs(names, ptype, comp, width, height)
    header += b"\0"

    chunks = _encode_scanline_chunks(img, names, ptype, comp)
    n_chunks = len(chunks)

    offset_table_pos = len(header)
    data_pos = offset_table_pos + 8 * n_chunks
    offsets = []
    body = b""
    for row0, payload in chunks:
        offsets.append(data_pos + len(body))
        body += struct.pack("<ii", row0, len(payload)) + payload

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        f.write(body)


def write_multipart(
    path: str,
    imgs,
    *,
    pixel_type: str = "half",
    compressions=None,
    names=None,
):
    """Write several (H, W, 3|1) float arrays as a multi-part scanline EXR
    (version bit 0x1000), one image part each. ``compressions`` is a single
    compression name or a per-part list (default ZIP); ``names`` the part
    names (default part0, part1, ...). Parts may differ in size and
    compression."""
    imgs = [np.asarray(im, dtype=np.float32) for im in imgs]
    n_parts = len(imgs)
    if n_parts == 0:
        raise ExrError("write_multipart needs at least one image")
    if compressions is None:
        compressions = ["ZIP"] * n_parts
    elif isinstance(compressions, str):
        compressions = [compressions] * n_parts
    if names is None:
        names = [f"part{i}" for i in range(n_parts)]
    if len(compressions) != n_parts or len(names) != n_parts:
        raise ExrError("write_multipart: imgs/compressions/names length mismatch")
    ptype = 1 if pixel_type == "half" else 2

    headers = b""
    part_chunks: list[list[tuple[int, bytes]]] = []
    for img, comp_name, pname in zip(imgs, compressions, names):
        img, ch_names = _prep_image(img, "write_multipart")
        height, width = img.shape[:2]
        comp = _COMP_IDS[comp_name]
        chunks = _encode_scanline_chunks(img, ch_names, ptype, comp)

        h = _common_header_attrs(ch_names, ptype, comp, width, height)
        # the multi-part required attributes
        h += _attr("name", "string", pname.encode())
        h += _attr("type", "string", b"scanlineimage")
        h += _attr("chunkCount", "int", struct.pack("<i", len(chunks)))
        h += b"\0"
        headers += h
        part_chunks.append(chunks)

    header = struct.pack("<ii", _MAGIC, 2 | 0x1000) + headers + b"\0"
    total_offsets = sum(len(c) for c in part_chunks)
    data_pos = len(header) + 8 * total_offsets
    offsets: list[int] = []
    body = b""
    for pi, chunks in enumerate(part_chunks):  # tables are per part, in order
        for row0, payload in chunks:
            offsets.append(data_pos + len(body))
            body += struct.pack("<iii", pi, row0, len(payload)) + payload
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{total_offsets}q", *offsets))
        f.write(body)


def write_tiled(
    path: str,
    img: np.ndarray,
    *,
    tile: tuple[int, int] = (64, 64),
    pixel_type: str = "half",
    compression: str = "ZIP",
):
    """Write (H, W, 3|1) float array as a single-part ONE_LEVEL tiled EXR
    (version bit 0x200). Each tile compresses like a scanline chunk of the
    tile's dimensions; edge tiles are clamped. Primarily the fixture
    generator for the tiled read path (no OpenEXR oracle in this
    environment)."""
    img, names = _prep_image(img, "write_tiled")
    height, width = img.shape[:2]
    ptype = 1 if pixel_type == "half" else 2
    dt = np.dtype(_PIXEL_DTYPES[ptype]).newbyteorder("<")
    comp = _COMP_IDS[compression]
    txs, tys = int(tile[1]), int(tile[0])  # tile=(rows, cols) -> x, y sizes

    header = struct.pack("<ii", _MAGIC, 2 | 0x200)
    header += _common_header_attrs(names, ptype, comp, width, height)
    # tiledesc: xSize, ySize, mode (ONE_LEVEL=0, ROUND_DOWN=0)
    header += _attr("tiles", "tiledesc", struct.pack("<IIB", txs, tys, 0))
    header += b"\0"

    nx, ny = -(-width // txs), -(-height // tys)
    chunks = []
    for dy in range(ny):
        for dx in range(nx):
            x0, y0 = dx * txs, dy * tys
            tw, th = min(txs, width - x0), min(tys, height - y0)
            raw = _raw_rows(img[y0 : y0 + th, x0 : x0 + tw], dt)
            payload = _compress_payload(raw, comp, ptype, names, tw, th)
            chunks.append((dx, dy, payload))

    offset_table_pos = len(header)
    data_pos = offset_table_pos + 8 * len(chunks)
    offsets = []
    body = b""
    for dx, dy, payload in chunks:
        offsets.append(data_pos + len(body))
        body += struct.pack("<5i", dx, dy, 0, 0, len(payload)) + payload

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{len(chunks)}q", *offsets))
        f.write(body)
