"""B44 / B44A compression for the in-repo EXR codec: the port's own copy
of ``reni_tpu/data/b44.py`` (numpy only).

Published format (OpenEXR ImfB44Compressor): HALF channels are cut into
4x4 pixel blocks, each packed to 14 bytes — the first value as 16 bits,
a 6-bit shift, then fifteen 6-bit modular deltas along a fixed
prediction chain — or, when every value in the block is equal (B44A's
adaptive "flat field" case), to 3 bytes. Non-HALF channels are stored
raw. The chunk stream is channel-planar in file channel order; chunks
cover 32 scanlines.

Halfs are first mapped monotonically onto uint16 (negatives bit-flipped,
positives OR 0x8000, Inf/NaN flushed to 0x8000 == decoded 0.0), so the
delta chain operates on an ordered space. Decode is bit-exact against
the system OpenEXR (tests/test_exr_oracle.py); encode emits valid
streams (lossy by design, like the reference encoder) whose decode is
identical through OpenEXR and this module.

Reference counterpart: the reference reads any EXR through OpenEXR
(src/data/datasets.py:80); B44 is the format's
fixed-rate playback compression.
"""

from __future__ import annotations

import numpy as np

# The fifteen (destination, predecessor, code-index) links of the block's
# prediction chain, in unpack order (ImfB44Compressor unpack14): first the
# left column downward, then each row left->right.
_CHAIN = (
    (4, 0, 0), (8, 4, 1), (12, 8, 2),
    (1, 0, 3), (5, 4, 4), (9, 8, 5), (13, 12, 6),
    (2, 1, 7), (6, 5, 8), (10, 9, 9), (14, 13, 10),
    (3, 2, 11), (7, 6, 12), (11, 10, 13), (15, 14, 14),
)


def _to_ordered(h: np.ndarray) -> np.ndarray:
    """half bits -> monotonic uint16 (Inf/NaN -> 0x8000, i.e. zero)."""
    h = h.astype(np.uint16)
    t = np.where(h & 0x8000, ~h, h | 0x8000).astype(np.uint16)
    return np.where((h & 0x7C00) == 0x7C00, np.uint16(0x8000), t)


def _from_ordered(t: np.ndarray) -> np.ndarray:
    """Inverse of `_to_ordered` on its image."""
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & 0x7FFF, ~t).astype(np.uint16)


def _unpack14(b: np.ndarray) -> np.ndarray:
    """(n, 14) uint8 blocks -> (n, 16) uint16 half bits (modular uint16
    arithmetic, matching the reference's unsigned short overflow)."""
    b = b.astype(np.uint32)
    s = np.zeros((b.shape[0], 16), dtype=np.uint32)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    shift = b[:, 2] >> 2
    bias = np.uint32(0x20) << shift
    r = np.empty((b.shape[0], 15), dtype=np.uint32)
    r[:, 0] = ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F
    r[:, 1] = ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F
    r[:, 2] = b[:, 4] & 0x3F
    r[:, 3] = b[:, 5] >> 2
    r[:, 4] = ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F
    r[:, 5] = ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F
    r[:, 6] = b[:, 7] & 0x3F
    r[:, 7] = b[:, 8] >> 2
    r[:, 8] = ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F
    r[:, 9] = ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F
    r[:, 10] = b[:, 10] & 0x3F
    r[:, 11] = b[:, 11] >> 2
    r[:, 12] = ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F
    r[:, 13] = ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F
    r[:, 14] = b[:, 13] & 0x3F
    for dst, pred, k in _CHAIN:
        s[:, dst] = (s[:, pred] + (r[:, k] << shift) - bias) & 0xFFFF
    return _from_ordered(s.astype(np.uint16))


def _shift_and_round(x: np.ndarray, shift: int) -> np.ndarray:
    """x / 2**shift, round to nearest with ties to even (the reference's
    shiftAndRound, shared with PXR24's mantissa rounding)."""
    x = x << 1
    a = (1 << shift) - 1
    shift += 1
    b = (x >> shift) & 1
    return (x + a + b) >> shift


def _pack_channel(plane: np.ndarray, flat_fields: bool) -> bytes:
    """(nrows, width) uint16 half bits -> packed B44[A] block stream.

    Per block, every value is quantized INDEPENDENTLY against the block
    max — ``recon[i] = tMax - round((tMax - t[i]) / 2**shift) << shift`` —
    and only the differences of those quantized offsets travel the 6-bit
    prediction chain, so quantization error does not accumulate along it
    (the reference encoder's scheme; error-feedback chains measure ~15x
    worse RMSE on HDR data)."""
    nrows, width = plane.shape
    bh, bw = -(-nrows // 4), -(-width // 4)
    # Pad to 4-multiples by edge replication (the reference pads partial
    # blocks from the last valid row/column).
    padded = np.pad(plane, ((0, bh * 4 - nrows), (0, bw * 4 - width)), mode="edge")
    t = _to_ordered(padded)
    blocks = (
        t.reshape(bh, 4, bw, 4).transpose(0, 2, 1, 3).reshape(-1, 16).astype(np.int64)
    )
    n = blocks.shape[0]
    tmax = blocks.max(axis=1)

    # Smallest shift whose chained 6-bit codes are all representable; a
    # shift of 12 always is (offsets quantize to <= 16, so codes stay in
    # [0x20 - 16, 0x20 + 16]).
    shift = np.full(n, 12, dtype=np.int64)
    codes = np.zeros((n, 15), dtype=np.int64)
    d_sel = np.zeros((n, 16), dtype=np.int64)
    undecided = np.ones(n, dtype=bool)
    for s in range(13):
        if not undecided.any():
            break
        d = _shift_and_round(tmax[:, None] - blocks, s)
        r = np.empty((n, 15), dtype=np.int64)
        for dst, pred, k in _CHAIN:
            r[:, k] = d[:, pred] - d[:, dst] + 0x20
        ok = undecided & ((r >= 0) & (r <= 0x3F)).all(axis=1)
        shift[ok] = s
        codes[ok] = r[ok]
        d_sel[ok] = d[ok]
        undecided &= ~ok
    s0 = (tmax - (d_sel[:, 0] << shift)) & 0xFFFF

    b = np.zeros((n, 14), dtype=np.int64)
    b[:, 0] = s0 >> 8
    b[:, 1] = s0 & 0xFF
    b[:, 2] = (shift << 2) | (codes[:, 0] >> 4)
    b[:, 3] = ((codes[:, 0] << 4) | (codes[:, 1] >> 2)) & 0xFF
    b[:, 4] = ((codes[:, 1] << 6) | codes[:, 2]) & 0xFF
    b[:, 5] = (codes[:, 3] << 2) | (codes[:, 4] >> 4)
    b[:, 6] = ((codes[:, 4] << 4) | (codes[:, 5] >> 2)) & 0xFF
    b[:, 7] = ((codes[:, 5] << 6) | codes[:, 6]) & 0xFF
    b[:, 8] = (codes[:, 7] << 2) | (codes[:, 8] >> 4)
    b[:, 9] = ((codes[:, 8] << 4) | (codes[:, 9] >> 2)) & 0xFF
    b[:, 10] = ((codes[:, 9] << 6) | codes[:, 10]) & 0xFF
    b[:, 11] = (codes[:, 11] << 2) | (codes[:, 12] >> 4)
    b[:, 12] = ((codes[:, 12] << 4) | (codes[:, 13] >> 2)) & 0xFF
    b[:, 13] = ((codes[:, 13] << 6) | codes[:, 14]) & 0xFF
    b = b.astype(np.uint8)

    flat = (blocks == blocks[:, :1]).all(axis=1) if flat_fields else np.zeros(n, bool)
    if not flat.any():
        return b.tobytes()
    sizes = np.where(flat, 3, 14)
    offs = np.concatenate(([0], np.cumsum(sizes)))
    out = np.empty(offs[-1], dtype=np.uint8)
    full_idx = np.flatnonzero(~flat)
    out[(offs[full_idx][:, None] + np.arange(14)).ravel()] = b[full_idx].ravel()
    flat_idx = np.flatnonzero(flat)
    t0 = blocks[flat_idx, 0]
    out[offs[flat_idx]] = t0 >> 8
    out[offs[flat_idx] + 1] = t0 & 0xFF
    out[offs[flat_idx] + 2] = 0xFC
    return out.tobytes()


def _unpack_channel(payload: memoryview, pos: int, nrows: int, width: int):
    """Decode one channel's block stream -> ((nrows, width) uint16, new pos)."""
    bh, bw = -(-nrows // 4), -(-width // 4)
    nblocks = bh * bw
    # Block sizes are data-dependent (3 or 14 bytes); walk the stream once
    # to find offsets, then unpack all 14-byte blocks vectorized.
    offsets = np.empty(nblocks, dtype=np.int64)
    sizes = np.empty(nblocks, dtype=np.int64)
    p = pos
    data = payload
    for i in range(nblocks):
        offsets[i] = p
        if data[p + 2] >= 13 << 2:
            sizes[i] = 3
            p += 3
        else:
            sizes[i] = 14
            p += 14
    vals = np.empty((nblocks, 16), dtype=np.uint16)
    full = sizes == 14
    if full.any():
        idx = offsets[full]
        raw = np.frombuffer(data, dtype=np.uint8, count=p - pos, offset=pos)
        gather = (idx[:, None] - pos) + np.arange(14)[None, :]
        vals[full] = _unpack14(raw[gather])
    flat = ~full
    if flat.any():
        raw = np.frombuffer(data, dtype=np.uint8, count=p - pos, offset=pos)
        idx = offsets[flat] - pos
        s0 = (raw[idx].astype(np.uint16) << 8) | raw[idx + 1]
        vals[flat] = _from_ordered(s0)[:, None]
    plane = (
        vals.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)
    )
    return plane[:nrows, :width], p


def decompress(payload: bytes, ptypes, width: int, nrows: int) -> bytes:
    """B44[A] chunk payload -> scanline-interleaved raw little-endian bytes
    (per row, each channel's run in file channel order)."""
    mv = memoryview(payload)
    pos = 0
    planes = []
    for pt in ptypes:
        if pt == 1:  # HALF: packed blocks
            plane, pos = _unpack_channel(mv, pos, nrows, width)
            planes.append(plane.astype("<u2"))
        else:  # UINT / FLOAT: stored raw, plane order
            n = nrows * width * 4
            planes.append(
                np.frombuffer(mv[pos : pos + n], dtype=np.uint8).reshape(nrows, -1)
            )
            pos += n
    rows = []
    for r in range(nrows):
        for plane in planes:
            rows.append(plane[r].tobytes())
    return b"".join(rows)


def compress(raw: bytes, ptypes, width: int, nrows: int, flat_fields: bool) -> bytes:
    """Scanline-interleaved raw bytes -> B44 (flat_fields=False) or B44A
    chunk payload."""
    sizes = [2 if pt == 1 else 4 for pt in ptypes]
    row_bytes = width * sum(sizes)
    assert len(raw) == nrows * row_bytes
    out = []
    off0 = 0
    for pt, sz in zip(ptypes, sizes):
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(nrows, row_bytes)
        plane = np.empty((nrows, width * sz), dtype=np.uint8)
        plane[:] = arr[:, off0 : off0 + width * sz]
        off0 += width * sz
        if pt == 1:
            halves = plane.reshape(nrows, width, 2).view("<u2")[..., 0]
            out.append(_pack_channel(halves, flat_fields))
        else:
            out.append(plane.tobytes())
    return b"".join(out)
