"""DWA (DWAA/DWAB) codec — OpenEXR compression ids 8/9. The port's own
copy of ``reni_tpu/data/dwa.py`` (numpy and zlib only).

DWA is the format's JPEG-like lossy scheme: channels are classified by
name into LOSSY_DCT (R/G/B/Y/BY/RY — 8x8 DCT of a perceptual
nonlinearity, with an optional RGB->Y/BY/RY decorrelation), RLE (alpha)
and UNKNOWN (everything else, stored losslessly). The quantized DCT
coefficients are run-length tokenized and entropy-coded with the same
Huffman coder PIZ uses (data/piz.py).

Implemented from the published format's observable behavior — chunk
headers, channel-classification rules, section layouts and the exact
float32 inverse-DCT/color-space arithmetic — and pinned bit-for-bit
against the SYSTEM libOpenEXR in tests/test_exr_oracle.py (every decoded
sample equals OpenEXR's own decode). Reference counterpart: the
reference decodes arbitrary EXRs through native OpenEXR
(src/data/datasets.py:80, environment.yml `openexr`).

Compressed-chunk layout (version 2):

  11 x uint64 LE header: version, unknownUncompressedSize,
    unknownCompressedSize, acCompressedSize, dcCompressedSize,
    rleCompressedSize, rleUncompressedSize, rleRawSize,
    totalAcUncompressedCount, totalDcUncompressedCount, acCompression
  channel rules: uint16 total size, then per rule a NUL-terminated
    suffix + 2 bytes: ((cscIdx+1)<<4 | scheme<<2 | flags, pixelType)
  sections, in order: UNKNOWN (zlib of the raw planes), AC (Huffman or
    deflate of uint16 tokens), DC (zlib + the EXR byte
    predictor/deinterleave), RLE (zlib, then EXR RLE; per channel the
    plane is split into little-endian byte planes)

AC token stream, per block in raster order and per channel within a CSC
set: plain values are half bits of the zig-zag AC coefficients; 0xff00
ends the block (remaining coefficients zero); 0xffNN skips NN zeros.
DC values live in the DC section, one half per block, stored per channel
contiguously. Decode of a DCT channel: tokens -> zig-zag block -> 8x8
inverse DCT (float32 butterfly below) -> [inverse Rec.709 CSC for
R/G/B sets] -> round to half -> toLinear lookup.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["DwaError", "decompress", "compress"]


class DwaError(ValueError):
    pass


_UNKNOWN, _LOSSY_DCT, _RLE = 0, 1, 2
_STATIC_HUFFMAN, _DEFLATE = 0, 1

_PIXEL_SIZE = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT

# ---------------------------------------------------------------------------
# The DWA nonlinearity: gamma 2.2 below 1.0 with a log extension above,
# applied to half bits through 65536-entry lookup tables. Regenerated
# from the closed form; verified bit-identical to the tables baked into
# libOpenEXR for every finite half (inf/NaN map to 0 there, as here).
# ---------------------------------------------------------------------------

_TABLES: tuple[np.ndarray, np.ndarray] | None = None


def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(toLinear, toNonlinear) uint16[65536] half-bit lookup tables."""
    global _TABLES
    if _TABLES is None:
        bits = np.arange(65536, dtype=np.uint16)
        h = bits.view(np.float16).astype(np.float32)
        sign = np.sign(h)
        a = np.abs(h)
        with np.errstate(all="ignore"):
            lin = np.where(
                a <= 1.0,
                sign * np.power(a, np.float32(2.2), dtype=np.float32),
                sign * np.exp(np.float32(2.2) * (a - np.float32(1.0)), dtype=np.float32),
            )
            non = np.where(
                a <= 1.0,
                sign * np.power(a, np.float32(1.0 / 2.2), dtype=np.float32),
                sign * (np.log(a, dtype=np.float32) / np.float32(2.2) + np.float32(1.0)),
            )
            # the exp extension overflows half range for large inputs;
            # those lanes round to inf and the special-mask below never
            # exposes them (only finite halfs index past it)
            to_linear = lin.astype(np.float16).view(np.uint16).copy()
            to_nonlinear = non.astype(np.float16).view(np.uint16).copy()
        special = ((bits >> 10) & 0x1F) == 0x1F  # inf/NaN of either sign
        to_linear[special] = 0
        to_nonlinear[special] = 0
        _TABLES = (to_linear, to_nonlinear)
    return _TABLES


# ---------------------------------------------------------------------------
# 8x8 DCT butterflies (float32). The decoder replicates, operation for
# operation, the hand-written AVX inverse-DCT the system libOpenEXR
# dispatches to at runtime — a matrix-multiply formulation with pairwise
# summation trees whose rounding differs from the scalar butterfly by
# ulps — including its own constant set (hex-pinned below; the AVX
# constants sit 1-3 ulps from the scalar path's cosf(3.14159f...)
# values). Transcribed from the library's disassembly and pinned
# bit-for-bit against its decode in tests/test_exr_oracle.py.
# ---------------------------------------------------------------------------

# Scalar-path constants 0.5*cosf(k*3.14159f/16): used by the forward DCT
# (encode), where no bit-level contract with the library exists.
_DCT_CONSTS = np.array(
    [0x3EB504FB, 0x3EFB14BF, 0x3EEC8361, 0x3ED4DB36, 0x3E8E39E5, 0x3E43EF33, 0x3DC7C60B],
    dtype="<u4",
).view("<f4")

# AVX-path constants (a, b, d, e, g, c, f) as baked into the library's
# .rodata vectors.
_AVX_CONSTS = np.array(
    [0x3EB504FA, 0x3EFB14C1, 0x3ED4DB34, 0x3E8E39E7, 0x3DC7C60E, 0x3EEC8360, 0x3E43EF36],
    dtype="<u4",
).view("<f4")


def _idct8x8(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) float32 coefficient blocks -> spatial blocks.

    Row pass: per row x, even part E[j] = (x0*M0[j] + x2*M1[j]) +
    (x4*M2[j] + x6*M3[j]) and odd part O[j] likewise over x1,x3,x5,x7;
    out[0:4] = E + O, out[4:8] = reversed(E - O). Column pass: explicit
    association trees over the row vectors (see inline comments). Both
    passes' groupings follow the library's AVX instruction stream
    exactly; float32 arithmetic with round-to-nearest-even throughout.
    """
    a, b, d, e, g, c, f = _AVX_CONSTS
    x = [blocks[..., i] for i in range(8)]

    # --- row pass: matrix multiply with pairwise sums ---
    # even matrix rows: [a,a,a,a], [c,f,-f,-c], [a,-a,-a,a], [f,-c,c,-f]
    # odd matrix rows:  [b,d,e,g], [d,-g,-b,-e], [e,-b,g,d], [g,-e,d,-b]
    m0 = (a, a, a, a)
    m1 = (c, f, -f, -c)
    m2 = (a, -a, -a, a)
    m3 = (f, -c, c, -f)
    m4 = (b, d, e, g)
    m5 = (d, -g, -b, -e)
    m6 = (e, -b, g, d)
    m7 = (g, -e, d, -b)
    cols = [None] * 8
    for j in range(4):
        ev = (x[0] * m0[j] + x[2] * m1[j]) + (x[4] * m2[j] + x[6] * m3[j])
        od = (x[1] * m4[j] + x[3] * m5[j]) + (x[5] * m6[j] + x[7] * m7[j])
        cols[j] = ev + od
        cols[7 - j] = ev - od
    rows_t = np.stack(cols, axis=-1)

    # --- column pass: explicit association trees over row vectors ---
    r = [rows_t[..., i, :] for i in range(8)]
    beta0 = (b * r[1] + d * r[3]) + (e * r[5] + g * r[7])
    beta1 = (d * r[1] - (g * r[3] + b * r[5])) - e * r[7]
    beta2 = ((e * r[1] - b * r[3]) + g * r[5]) + d * r[7]
    beta3 = (g * r[1] + d * r[5]) - (e * r[3] + b * r[7])
    ar0 = a * r[0]
    ar4 = a * r[4]
    t0p = ar0 + ar4  # NOT a*(r0+r4): the AVX path multiplies first
    t0m = ar0 - ar4
    theta1 = c * r[2] + f * r[6]
    theta2 = f * r[2] - c * r[6]
    gamma0 = t0p + theta1
    gamma3 = t0p - theta1
    gamma1 = t0m + theta2
    gamma2 = t0m - theta2
    return np.stack(
        [
            gamma0 + beta0,
            gamma1 + beta1,
            gamma2 + beta2,
            gamma3 + beta3,
            gamma3 - beta3,
            gamma2 - beta2,
            gamma1 - beta1,
            gamma0 - beta0,
        ],
        axis=-2,
    )


def _dct_pass(x: np.ndarray) -> np.ndarray:
    """Forward counterpart of ``_idct_pass`` (the transpose of the same
    orthogonal butterfly), for the encoder."""
    a, b, c, d, e, f, g = _DCT_CONSTS
    r = [x[..., i] for i in range(8)]
    s07 = r[0] + r[7]
    s16 = r[1] + r[6]
    s25 = r[2] + r[5]
    s34 = r[3] + r[4]
    d07 = r[0] - r[7]
    d16 = r[1] - r[6]
    d25 = r[2] - r[5]
    d34 = r[3] - r[4]
    return np.stack(
        [
            a * (s07 + s34 + s16 + s25),
            b * d07 + d * d16 + e * d25 + g * d34,
            c * (s07 - s34) + f * (s16 - s25),
            d * d07 - g * d16 - b * d25 - e * d34,
            a * (s07 + s34 - s16 - s25),
            e * d07 - b * d16 + g * d25 + d * d34,
            f * (s07 - s34) - c * (s16 - s25),
            g * d07 - e * d16 + d * d25 - b * d34,
        ],
        axis=-1,
    )


def _dct8x8(blocks: np.ndarray) -> np.ndarray:
    rows = _dct_pass(blocks)
    return _dct_pass(rows.swapaxes(-1, -2)).swapaxes(-1, -2)


# Rec.709 RGB <-> Y/BY/RY decorrelation (float32 literals of the
# published implementation).
_CSC_F = np.float32
_FWD = (
    (_CSC_F(0.2126), _CSC_F(0.7152), _CSC_F(0.0722)),
    (_CSC_F(-0.1146), _CSC_F(-0.3854), _CSC_F(0.5)),
    (_CSC_F(0.5), _CSC_F(-0.4542), _CSC_F(-0.0458)),
)
_INV_RY = _CSC_F(1.5747)
_INV_BY1 = _CSC_F(0.1873)
_INV_RY1 = _CSC_F(0.4682)
_INV_BY2 = _CSC_F(1.8556)


def _csc_inverse(y: np.ndarray, by: np.ndarray, ry: np.ndarray):
    r = y + _INV_RY * ry
    g = y - _INV_BY1 * by - _INV_RY1 * ry
    b = y + _INV_BY2 * by
    return r, g, b


def _csc_forward(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    y = _FWD[0][0] * r + _FWD[0][1] * g + _FWD[0][2] * b
    by = _FWD[1][0] * r + _FWD[1][1] * g + _FWD[1][2] * b
    ry = _FWD[2][0] * r + _FWD[2][1] * g + _FWD[2][2] * b
    return y, by, ry


def _zigzag_to_flat() -> np.ndarray:
    """zig-zag position p -> row-major flat index (the JPEG order)."""
    out = np.empty(64, dtype=np.int64)
    p = 0
    for s in range(15):
        lo, hi = max(0, s - 7), min(7, s)
        diag = [(s - i, i) for i in range(lo, hi + 1)]  # (row, col)
        # even diagonals run (s,0) -> (0,s); odd ones the reverse
        if s % 2 == 1:
            diag = diag[::-1]
        for row, col in diag:
            out[p] = row * 8 + col
            p += 1
    return out


_ZIG_TO_FLAT = _zigzag_to_flat()


# ---------------------------------------------------------------------------
# Channel classification
# ---------------------------------------------------------------------------


def _parse_rules(payload: bytes, pos: int):
    """Rules block at ``pos`` -> (rules, end_pos); each rule is
    (suffix, cscIdx, scheme, case_insensitive, pixel_type)."""
    (total,) = struct.unpack_from("<H", payload, pos)
    if total < 2:
        raise DwaError("DWA: corrupt channel-rule block")
    end = pos + total
    rp = pos + 2
    rules = []
    while rp < end:
        ne = payload.index(b"\0", rp, end)
        suffix = payload[rp:ne].decode("latin-1")
        rp = ne + 1
        if rp + 2 > end:
            raise DwaError("DWA: truncated channel rule")
        b1, b2 = payload[rp], payload[rp + 1]
        rp += 2
        rules.append((suffix, ((b1 >> 4) & 0xF) - 1, (b1 >> 2) & 3, bool(b1 & 1), b2))
    return rules, end


def _ascii_lower(s: str) -> str:
    """ASCII-only lowercase — the published implementation's
    case-insensitive rule match goes through C-locale ``tolower``, which
    (unlike ``str.lower``) leaves non-ASCII bytes untouched; the native
    decoder mirrors this exactly."""
    return "".join(
        chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in s
    )


def _classify(channels, rules):
    """channels: [(name, pixel_type)] in file order -> per-channel
    (scheme, cscIdx) and the ordered LOSSY_DCT channel sets.

    Returns (schemes, sets) where sets is a list of lists of channel
    indices: complete R/G/B groups (by prefix) first — the published
    encoder emits CSC sets before lone DCT channels — then single DCT
    channels in file order."""
    info = []
    for name, ptype in channels:
        suffix = name.rsplit(".", 1)[-1]
        scheme, csc = _UNKNOWN, -1
        for rsuffix, rcsc, rscheme, rci, rtype in rules:
            if rtype != ptype:
                continue
            if (rci and _ascii_lower(suffix) == _ascii_lower(rsuffix)) or suffix == rsuffix:
                scheme, csc = rscheme, rcsc
                break
        info.append((scheme, csc))

    groups: dict[str, dict[int, int]] = {}
    group_order: list[str] = []
    for i, ((scheme, csc), (name, _)) in enumerate(zip(info, channels)):
        if scheme == _LOSSY_DCT and csc >= 0:
            suffix = name.rsplit(".", 1)[-1]
            prefix = name[: len(name) - len(suffix)]
            if prefix not in groups:
                groups[prefix] = {}
                group_order.append(prefix)
            groups[prefix][csc] = i

    sets: list[list[int]] = []
    in_set: set[int] = set()
    for prefix in group_order:
        g = groups[prefix]
        if set(g) == {0, 1, 2}:
            sets.append([g[0], g[1], g[2]])
            in_set.update(g.values())
    for i, (scheme, _) in enumerate(info):
        if scheme == _LOSSY_DCT and i not in in_set:
            sets.append([i])
    return [s for s, _ in info], sets


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _unrle_ac(tokens: list[int], n_blocks: int) -> np.ndarray:
    """AC token stream -> (n_blocks, 64) half-bit blocks (zig-zag order,
    position 0 left for the DC value). Consumes exactly the tokens the
    encoder emitted for these blocks."""
    out = np.zeros((n_blocks, 64), dtype=np.uint16)
    ti = 0
    for bi in range(n_blocks):
        row = out[bi]
        pos = 1
        while pos < 64:
            if ti >= len(tokens):
                raise DwaError("DWA: AC token stream underrun")
            t = tokens[ti]
            ti += 1
            if t >= 0xFF00:
                if t == 0xFF00:
                    break
                pos += t - 0xFF00
            else:
                row[pos] = t
                pos += 1
    if ti != len(tokens):
        raise DwaError("DWA: AC token stream overrun")
    return out


def decompress(payload: bytes, channels, width: int, nrows: int) -> bytes:
    """One DWA chunk/tile -> scanline-interleaved raw bytes (per row,
    each channel's run in file order). ``channels`` is [(name,
    pixel_type)] in file order."""
    if len(payload) < 88:
        raise DwaError("DWA: truncated header")
    (
        version,
        unk_usize,
        unk_csize,
        ac_csize,
        dc_csize,
        rle_csize,
        rle_usize,
        rle_raw_size,
        ac_count,
        dc_count,
        ac_compression,
    ) = struct.unpack_from("<11Q", payload, 0)
    if version < 2:
        # v0/v1 files carry no channel rules; classify with the default
        # ruleset the published encoder ships.
        rules = _DEFAULT_RULES
        pos = 88
    else:
        rules, pos = _parse_rules(payload, 88)

    sections = []
    for size in (unk_csize, ac_csize, dc_csize, rle_csize):
        sections.append(payload[pos : pos + size])
        pos += size
    unknown_c, ac_c, dc_c, rle_c = sections

    schemes, sets = _classify(channels, rules)

    # --- section decode ---------------------------------------------------
    if ac_count:
        if ac_compression == _STATIC_HUFFMAN:
            from reni_tpu_torch.data import piz

            tokens_arr = piz.huf_uncompress(bytes(ac_c), int(ac_count))
        elif ac_compression == _DEFLATE:
            raw = zlib.decompress(ac_c)
            if len(raw) != 2 * ac_count:
                raise DwaError("DWA: deflate AC size mismatch")
            tokens_arr = np.frombuffer(raw, dtype="<u2")
        else:
            raise DwaError(f"DWA: unknown AC compression {ac_compression}")
        tokens = [int(t) for t in tokens_arr]
    else:
        tokens = []

    if dc_count:
        from reni_tpu_torch.data.exr import _unpredict_deinterleave

        dc_raw = _unpredict_deinterleave(zlib.decompress(dc_c))
        dc_vals = np.frombuffer(dc_raw.tobytes(), dtype="<u2")
        if len(dc_vals) != dc_count:
            raise DwaError("DWA: DC count mismatch")
    else:
        dc_vals = np.zeros(0, dtype="<u2")

    if rle_csize:
        from reni_tpu_torch.data.exr import _rle_uncompress

        rle_stream = zlib.decompress(rle_c)
        if len(rle_stream) != rle_usize:
            raise DwaError("DWA: RLE stream size mismatch")
        rle_raw = bytes(_rle_uncompress(rle_stream))
        if len(rle_raw) != rle_raw_size:
            raise DwaError("DWA: RLE raw size mismatch")
    else:
        rle_raw = b""

    unknown_raw = zlib.decompress(unknown_c) if unk_csize else b""
    if len(unknown_raw) != unk_usize:
        raise DwaError("DWA: unknown-section size mismatch")

    # --- LOSSY_DCT channel sets -------------------------------------------
    to_linear, _ = _tables()
    nbx = -(-width // 8)
    nby = -(-nrows // 8)
    nblocks = nbx * nby
    planes: dict[int, np.ndarray] = {}  # channel index -> (nrows, width) u16/u32 plane

    ti = 0  # token cursor
    di = 0  # dc cursor
    for chan_set in sets:
        nch = len(chan_set)
        # AC: per block, per channel within the set.
        want = _count_set_tokens(tokens, ti, nblocks * nch)
        coefs = _unrle_ac(tokens[ti : ti + want], nblocks * nch)
        ti += want
        # DC: per channel contiguous over blocks.
        grid = coefs.reshape(nblocks, nch, 64)
        for c in range(nch):
            grid[:, c, 0] = dc_vals[di : di + nblocks]
            di += nblocks
        floats = (
            np.ascontiguousarray(coefs).view(np.float16).astype(np.float32)
        )
        mats = np.empty_like(floats)
        mats[:, _ZIG_TO_FLAT] = floats
        spatial = _idct8x8(mats.reshape(nblocks * nch, 8, 8)).reshape(
            nblocks, nch, 8, 8
        )
        if nch == 3:
            r, g, b = _csc_inverse(
                spatial[:, 0], spatial[:, 1], spatial[:, 2]
            )
            spatial = np.stack([r, g, b], axis=1)
        half_bits = spatial.astype(np.float16).view(np.uint16)
        for c, ci in enumerate(chan_set):
            blocks = half_bits[:, c]  # (nblocks, 8, 8)
            plane = (
                blocks.reshape(nby, nbx, 8, 8)
                .swapaxes(1, 2)
                .reshape(nby * 8, nbx * 8)[:nrows, :width]
            )
            planes[ci] = to_linear[plane]

    if di != len(dc_vals):
        raise DwaError("DWA: DC stream not fully consumed")
    if ti != len(tokens):
        raise DwaError("DWA: AC stream not fully consumed")

    # --- RLE channels: per channel, little-endian byte planes -------------
    rp = 0
    for i, ((name, ptype), scheme) in enumerate(zip(channels, schemes)):
        if scheme != _RLE:
            continue
        esz = _PIXEL_SIZE[ptype]
        n = nrows * width
        chunk = np.frombuffer(rle_raw, dtype=np.uint8, count=esz * n, offset=rp)
        rp += esz * n
        sample_bytes = chunk.reshape(esz, n).T  # byte planes -> per-sample
        planes[i] = np.ascontiguousarray(sample_bytes).reshape(nrows, width * esz)

    # --- UNKNOWN channels: raw planes ------------------------------------
    up = 0
    for i, ((name, ptype), scheme) in enumerate(zip(channels, schemes)):
        if scheme != _UNKNOWN:
            continue
        esz = _PIXEL_SIZE[ptype]
        n = nrows * width * esz
        planes[i] = np.frombuffer(
            unknown_raw, dtype=np.uint8, count=n, offset=up
        ).reshape(nrows, width * esz)
        up += n

    # --- assemble scanline-interleaved output -----------------------------
    row_parts = []
    for i, (name, ptype) in enumerate(channels):
        plane = planes[i]
        esz = _PIXEL_SIZE[ptype]
        if plane.dtype == np.uint16:  # DCT half plane
            if ptype == 2:  # FLOAT channel: widen the lossy half
                plane = (
                    plane.view(np.float16).astype("<f4").view(np.uint8)
                ).reshape(nrows, width * 4)
            else:
                plane = plane.astype("<u2").view(np.uint8).reshape(nrows, width * 2)
        row_parts.append(plane)
    return np.concatenate(row_parts, axis=1).tobytes()


def _count_set_tokens(tokens: list[int], start: int, n_blocks: int) -> int:
    """Number of tokens the next ``n_blocks`` blocks consume (the AC
    stream is shared across channel sets, so each set must take exactly
    its own run)."""
    ti = start
    for _ in range(n_blocks):
        pos = 1
        while pos < 64:
            if ti >= len(tokens):
                raise DwaError("DWA: AC token stream underrun")
            t = tokens[ti]
            ti += 1
            if t >= 0xFF00:
                if t == 0xFF00:
                    break
                pos += t - 0xFF00
            else:
                pos += 1
    return ti - start


# The published encoder's default classification, used only for
# pre-version-2 chunks (which carry no rules): R/G/B as a CSC triple,
# Y/BY/RY lone DCT, A run-length, for both half and float.
_DEFAULT_RULES = (
    [("R", 0, _LOSSY_DCT, False, t) for t in (1, 2)]
    + [("G", 1, _LOSSY_DCT, False, t) for t in (1, 2)]
    + [("B", 2, _LOSSY_DCT, False, t) for t in (1, 2)]
    + [(s, -1, _LOSSY_DCT, False, t) for s in ("Y", "BY", "RY") for t in (1, 2)]
    + [("A", -1, _RLE, False, t) for t in (0, 1, 2)]
)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _rle_ac(block: np.ndarray) -> list[int]:
    """Zig-zag half-bit block (64,) -> AC token list (positions 1..63)."""
    out: list[int] = []
    pos = 1
    while pos < 64:
        if block[pos]:
            out.append(int(block[pos]))
            pos += 1
            continue
        run = pos
        while run < 64 and not block[run]:
            run += 1
        if run == 64:
            out.append(0xFF00)
            return out
        out.append(0xFF00 + (run - pos))
        pos = run
    return out


def _quantize(coef_bits: np.ndarray, error: np.ndarray) -> np.ndarray:
    """Replace each half with the cheapest-to-code half within
    ``error`` of it: among candidates obtained by zeroing low mantissa
    bits, pick the one with the most trailing zeros whose value stays
    within the allowed absolute error (the published encoder's
    acceptable-error quantization, computed directly instead of through
    its precomputed closest-data tables)."""
    vals = coef_bits.view(np.float16).astype(np.float32)
    best = coef_bits.copy()
    ok_zero = np.abs(vals) <= error
    best[ok_zero] = 0
    for nbits in range(15, 0, -1):
        mask = np.uint16((0xFFFF << nbits) & 0xFFFF)
        cand = coef_bits & mask
        cand_vals = cand.view(np.float16).astype(np.float32)
        ok = (np.abs(cand_vals - vals) <= error) & (best == coef_bits)
        best[ok] = cand[ok]
    return best


def compress(
    raw: bytes,
    channels,
    width: int,
    nrows: int,
    *,
    level: float = 45.0,
) -> bytes:
    """Scanline-interleaved raw bytes -> one DWA chunk payload.

    ``level`` is the dwaCompressionLevel knob (base quantization error =
    level * 1e-5 on the luminance channel, doubled for chroma — small
    values are near-lossless)."""
    channels = list(channels)
    rules_used: list[tuple] = []
    for name, ptype in channels:
        suffix = name.rsplit(".", 1)[-1]
        for rule in _DEFAULT_RULES:
            if rule[4] == ptype and rule[0] == suffix:
                if rule not in rules_used:
                    rules_used.append(rule)
                break
    schemes, sets = _classify(channels, _DEFAULT_RULES)

    # Split the interleaved rows back into per-channel planes.
    eszs = [_PIXEL_SIZE[pt] for _, pt in channels]
    row_bytes = width * sum(eszs)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(nrows, row_bytes)
    planes = []
    off = 0
    for esz in eszs:
        planes.append(arr[:, off : off + width * esz])
        off += width * esz

    _, to_nonlinear = _tables()
    nbx = -(-width // 8)
    nby = -(-nrows // 8)
    nblocks = nbx * nby

    def dct_plane(idx: int) -> np.ndarray:
        """Channel plane -> (nblocks, 8, 8) float32 nonlinear blocks
        (edge blocks padded by replicating the last row/column, which
        keeps the DCT energy compact)."""
        name, ptype = channels[idx]
        if ptype == 1:
            halfs = planes[idx].reshape(nrows, width, 2).view("<u2")[..., 0]
        else:  # FLOAT: through half, as the published encoder does
            f = planes[idx].reshape(nrows, width, 4).view("<f4")[..., 0]
            halfs = f.astype(np.float16).view(np.uint16)
        nl = to_nonlinear[halfs].view(np.float16).astype(np.float32)
        padded = np.empty((nby * 8, nbx * 8), dtype=np.float32)
        padded[:nrows, :width] = nl
        padded[nrows:, :width] = nl[-1:, :]
        padded[:, width:] = padded[:, width - 1 : width]
        return (
            padded.reshape(nby, 8, nbx, 8).swapaxes(1, 2).reshape(nblocks, 8, 8)
        )

    ac_tokens: list[int] = []
    dc_parts: list[np.ndarray] = []
    for chan_set in sets:
        nch = len(chan_set)
        blocks = np.stack([dct_plane(ci) for ci in chan_set], axis=1)
        if nch == 3:
            y, by, ry = _csc_forward(blocks[:, 0], blocks[:, 1], blocks[:, 2])
            blocks = np.stack([y, by, ry], axis=1)
        coefs = _dct8x8(blocks.reshape(nblocks * nch, 8, 8)).reshape(
            nblocks * nch, 64
        )
        # gather into zig-zag order: z[p] = mat.flat[ZIG_TO_FLAT[p]]
        zig = coefs[:, _ZIG_TO_FLAT]
        bits = zig.astype(np.float16).view(np.uint16)
        if level > 0:
            err = np.float32(level / 100000.0)
            errs = np.full((1, nch, 1), err, dtype=np.float32)
            if nch == 3:
                errs[0, 1:, 0] *= 2  # chroma tolerates twice the error
            q = _quantize(
                bits.reshape(nblocks, nch, 64).reshape(-1),
                np.broadcast_to(errs, (nblocks, nch, 64)).reshape(-1).astype(np.float32),
            )
            bits = q.reshape(nblocks * nch, 64)
        grid = bits.reshape(nblocks, nch, 64)
        for c in range(nch):
            dc_parts.append(grid[:, c, 0].copy())
        for b in range(nblocks):
            for c in range(nch):
                ac_tokens.extend(_rle_ac(grid[b, c]))

    # --- sections ---------------------------------------------------------
    from reni_tpu_torch.data import piz
    from reni_tpu_torch.data.exr import _predict_interleave, _rle_compress

    if ac_tokens:
        ac_payload = piz.huf_compress(np.asarray(ac_tokens, dtype=np.uint16))
    else:
        ac_payload = b""
    if dc_parts:
        dc_all = np.concatenate(dc_parts).astype("<u2")
        dc_payload = zlib.compress(
            _predict_interleave(np.frombuffer(dc_all.tobytes(), dtype=np.uint8))
        )
        dc_count = len(dc_all)
    else:
        dc_payload = b""
        dc_count = 0

    rle_parts = []
    for i, scheme in enumerate(schemes):
        if scheme != _RLE:
            continue
        esz = eszs[i]
        sample_bytes = planes[i].reshape(nrows * width, esz)
        rle_parts.append(np.ascontiguousarray(sample_bytes.T).reshape(-1))
    if rle_parts:
        rle_raw = np.concatenate(rle_parts).tobytes()
        rle_stream = bytes(_rle_compress(rle_raw))
        rle_payload = zlib.compress(rle_stream)
    else:
        rle_raw = b""
        rle_stream = b""
        rle_payload = b""

    unknown_parts = [
        planes[i].tobytes() for i, s in enumerate(schemes) if s == _UNKNOWN
    ]
    unknown_raw = b"".join(unknown_parts)
    unknown_payload = zlib.compress(unknown_raw) if unknown_raw else b""

    rules_blob = b""
    for suffix, csc, scheme, ci, ptype in rules_used:
        b1 = (((csc + 1) & 0xF) << 4) | ((scheme & 3) << 2) | (1 if ci else 0)
        rules_blob += suffix.encode("latin-1") + b"\0" + bytes([b1, ptype])
    rules_block = struct.pack("<H", len(rules_blob) + 2) + rules_blob

    header = struct.pack(
        "<11Q",
        2,
        len(unknown_raw),
        len(unknown_payload),
        len(ac_payload),
        len(dc_payload),
        len(rle_payload),
        len(rle_stream),
        len(rle_raw),
        len(ac_tokens),
        dc_count,
        _STATIC_HUFFMAN,
    )
    return (
        header + rules_block + unknown_payload + ac_payload + dc_payload + rle_payload
    )
