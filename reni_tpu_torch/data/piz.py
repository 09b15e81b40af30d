"""PIZ codec (OpenEXR compression id 4): Huffman-coded 2D Haar wavelet.
The port's own copy of ``reni_tpu/data/piz.py`` (numpy only; the port
imports nothing of the JAX package).

PIZ is the default compression of many HDRI tools, so real captured
datasets routinely arrive PIZ-compressed (the reference decodes them
through native OpenEXR — reference: src/data/datasets.py:80,
environment.yml `openexr`). This is a from-scratch implementation of the
published format (openexr.com file-layout docs + the OpenEXR 2.x
`ImfPizCompressor/ImfHuf/ImfWav` algorithms), NumPy-vectorised where the
lattice structure allows; the native C++ decoder in ``data/csrc/exr_decode.cpp``
is the production decode path and this module is its parity oracle (and
the encoder used by ``exr.write``).

A PIZ chunk payload (32 scanlines) is:

    u16 minNonZero, u16 maxNonZero            # bitmap byte range
    bitmap[minNonZero..maxNonZero]            # bit i set => value i occurs
    u32 length                                # Huffman stream byte length
    huffman stream:
        u32 im, u32 iM, u32 tableLength, u32 nBits, u32 reserved
        packed code-length table (6-bit entries, zero-run codes)
        bit stream (MSB-first), symbol iM = run-length escape

Pipeline: ushort data -> forward LUT (compact the occurring values) ->
per-channel 2D wavelet (``wav2``; 16-bit mod arithmetic when more than
2^14 distinct values) -> Huffman. Decode inverts in reverse order.
"""

from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3  # 8192
HUF_ENCSIZE = USHORT_RANGE + 1  # one extra slot: the run-length symbol
HUF_DECBITS = 14
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN  # 261


class PizError(ValueError):
    pass


# ---------------------------------------------------------------------------
# bitmap / LUT  (ImfPizCompressor.cpp bitmapFromData & friends)
# ---------------------------------------------------------------------------


def bitmap_from_data(data: np.ndarray):
    """(bitmap, min_nonzero, max_nonzero): bit i marks that ushort value i
    occurs. Value 0 is never marked (assumed always present)."""
    bits = np.zeros(USHORT_RANGE, dtype=bool)
    bits[data] = True
    bits[0] = False
    bitmap = np.packbits(bits.reshape(-1, 8)[:, ::-1], axis=1, bitorder="big")
    bitmap = bitmap.reshape(-1)  # LSB-first within each byte
    nz = np.nonzero(bitmap)[0]
    if nz.size == 0:
        return bitmap, BITMAP_SIZE - 1, 0
    return bitmap, int(nz[0]), int(nz[-1])


def forward_lut_from_bitmap(bitmap: np.ndarray):
    """(lut, max_value): lut[v] = compact index of occurring value v."""
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True  # zero is always representable
    lut = np.zeros(USHORT_RANGE, dtype=np.uint16)
    occ = np.nonzero(bits)[0]
    lut[occ] = np.arange(occ.size, dtype=np.uint16)
    return lut, occ.size - 1


def reverse_lut_from_bitmap(bitmap: np.ndarray):
    """(lut, max_value): lut[k] = k-th occurring ushort value."""
    bits = np.unpackbits(bitmap, bitorder="little").astype(bool)
    bits[0] = True
    occ = np.nonzero(bits)[0].astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, dtype=np.uint16)
    lut[: occ.size] = occ
    return lut, occ.size - 1


# ---------------------------------------------------------------------------
# 2D wavelet  (ImfWav.cpp wav2Encode / wav2Decode)
# ---------------------------------------------------------------------------

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wenc14(a, b):
    a16 = a.astype(np.int16).astype(np.int32)
    b16 = b.astype(np.int16).astype(np.int32)
    m = ((a16 + b16) >> 1).astype(np.int16)
    d = (a16 - b16).astype(np.int16)
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (a.astype(np.int32) - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def wav2_encode(a: np.ndarray, max_value: int) -> None:
    """In-place 2D wavelet transform of a (ny, nx) uint16 lattice view."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = a.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        rows = np.arange(0, max(ny - p2, 0) + 1, p2)
        cols = np.arange(0, max(nx - p2, 0) + 1, p2)
        if rows.size and cols.size:
            r, c = np.ix_(rows, cols)
            i00, i01 = enc(a[r, c], a[r, c + p])
            i10, i11 = enc(a[r + p, c], a[r + p, c + p])
            a[r, c], a[r + p, c] = enc(i00, i10)
            a[r, c + p], a[r + p, c + p] = enc(i01, i11)
        if nx & p and rows.size:
            jc = cols.size * p2
            i00, a[rows + p, jc] = enc(a[rows, jc], a[rows + p, jc])
            a[rows, jc] = i00
        if ny & p and cols.size:
            ir = rows.size * p2
            i00, a[ir, cols + p] = enc(a[ir, cols], a[ir, cols + p])
            a[ir, cols] = i00
        p, p2 = p2, p2 << 1


def wav2_decode(a: np.ndarray, max_value: int) -> None:
    """Inverse of ``wav2_encode`` (in place)."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2, p = p, p >> 1
    while p >= 1:
        rows = np.arange(0, max(ny - p2, 0) + 1, p2)
        cols = np.arange(0, max(nx - p2, 0) + 1, p2)
        if rows.size and cols.size:
            r, c = np.ix_(rows, cols)
            i00, i10 = dec(a[r, c], a[r + p, c])
            i01, i11 = dec(a[r, c + p], a[r + p, c + p])
            a[r, c], a[r, c + p] = dec(i00, i01)
            a[r + p, c], a[r + p, c + p] = dec(i10, i11)
        if nx & p and rows.size:
            jc = cols.size * p2
            i00, a[rows + p, jc] = dec(a[rows, jc], a[rows + p, jc])
            a[rows, jc] = i00
        if ny & p and cols.size:
            ir = rows.size * p2
            i00, a[ir, cols + p] = dec(a[ir, cols], a[ir, cols + p])
            a[ir, cols] = i00
        p2, p = p, p >> 1


# ---------------------------------------------------------------------------
# Huffman coding  (ImfHuf.cpp)
# ---------------------------------------------------------------------------


class _BitWriter:
    __slots__ = ("buf", "c", "lc")

    def __init__(self):
        self.buf = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, value: int) -> None:
        self.c = (self.c << nbits) | (value & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.buf.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def flush(self) -> int:
        """Pad to a byte boundary; returns total bits written pre-padding."""
        nbits = len(self.buf) * 8 + self.lc
        if self.lc:
            self.buf.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = self.lc = 0
        return nbits


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data, pos: int = 0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def read(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        return (self.c >> self.lc) & ((1 << nbits) - 1)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """OpenEXR's canonical code assignment (hufCanonicalCodeTable): returns
    per-symbol codes; a symbol's packed entry is (code << 6) | length."""
    n = np.bincount(lengths, minlength=59).astype(object)
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros(lengths.size, dtype=object)
    for i in np.nonzero(lengths)[0]:
        l = int(lengths[i])
        codes[i] = n[l]
        n[l] += 1
    return codes


def _build_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths for the nonzero-frequency symbols.

    Any prefix code both ends agree on is valid — the table is transmitted
    as lengths and both sides derive canonical codes — so this uses a
    standard heap merge rather than OpenEXR's linked-list variant; lengths
    are capped at 58 (the packed table's limit) by flattening in the
    (astronomically unlikely) overflow case."""
    import heapq

    syms = np.nonzero(freq)[0]
    lengths = np.zeros(freq.size, dtype=np.int32)
    if syms.size == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), (int(s),)) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, g1 = heapq.heappop(heap)
        f2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, min(g1[0], g2[0]), g1 + g2))
    if lengths.max() > 58:
        flat = max(1, int(np.ceil(np.log2(syms.size))))
        lengths[:] = 0
        lengths[syms] = flat
    return lengths


def _pack_enc_table(lengths: np.ndarray, im: int, iM: int, w: _BitWriter):
    """hufPackEncTable: 6-bit code lengths with zero-run escapes."""
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while i < iM and zerun < LONGEST_LONG_RUN and lengths[i + 1] == 0:
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    w.write(6, LONG_ZEROCODE_RUN)
                    w.write(8, zerun - SHORTEST_LONG_RUN)
                else:
                    w.write(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        w.write(6, l)
        i += 1


def _unpack_enc_table(r: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, dtype=np.int32)
    i = im
    while i <= iM:
        l = r.read(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = r.read(8) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise PizError("corrupt huffman table (long zero run)")
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise PizError("corrupt huffman table (short zero run)")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    # unpacking stops at the byte boundary before the data stream
    r.c = 0
    r.lc = 0
    return lengths


def huf_compress(data: np.ndarray) -> bytes:
    """hufCompress: ushort array -> self-contained huffman stream."""
    if data.size == 0:
        return b""
    freq = np.bincount(data.astype(np.int64), minlength=HUF_ENCSIZE).astype(
        np.int64
    )
    im = int(np.nonzero(freq)[0][0])
    iM = int(np.nonzero(freq)[0][-1])
    # the run-length pseudo-symbol, one past the largest data symbol
    iM += 1
    freq[iM] = 1
    lengths = _build_code_lengths(freq)
    codes = _canonical_codes(lengths)

    tw = _BitWriter()
    _pack_enc_table(lengths, im, iM, tw)
    tw.flush()
    table = bytes(tw.buf)

    w = _BitWriter()
    rl_code, rl_len = int(codes[iM]), int(lengths[iM])

    def send(sym: int, run: int):
        sc, sl = int(codes[sym]), int(lengths[sym])
        if sl + rl_len + 8 < sl * run:
            w.write(sl, sc)
            w.write(rl_len, rl_code)
            w.write(8, run)
        else:
            for _ in range(run + 1):
                w.write(sl, sc)

    arr = data.astype(np.int64)
    s = int(arr[0])
    cs = 0
    for v in arr[1:]:
        v = int(v)
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            cs = 0
            s = v
    send(s, cs)
    n_bits = w.flush()
    stream = bytes(w.buf)
    header = struct.pack("<5I", im, iM, len(table), n_bits, 0)
    return header + table + stream


def _build_dec_table(lengths: np.ndarray, codes: np.ndarray, im: int, iM: int):
    """hufBuildDecTable: (short_len, short_lit, long_lists)."""
    short_len = np.zeros(HUF_DECSIZE, dtype=np.int32)
    short_lit = np.zeros(HUF_DECSIZE, dtype=np.int32)
    long_lists: dict[int, list[int]] = {}
    for sym in range(im, iM + 1):
        l = int(lengths[sym])
        if l == 0:
            continue
        c = int(codes[sym])
        if c >> l:
            raise PizError("corrupt huffman table (bad code)")
        if l > HUF_DECBITS:
            slot = c >> (l - HUF_DECBITS)
            if short_len[slot]:
                raise PizError("corrupt huffman table (slot clash)")
            long_lists.setdefault(slot, []).append(sym)
        else:
            base = c << (HUF_DECBITS - l)
            span = 1 << (HUF_DECBITS - l)
            if short_len[base : base + span].any() or any(
                s in long_lists for s in range(base, base + span)
            ):
                raise PizError("corrupt huffman table (slot clash)")
            short_len[base : base + span] = l
            short_lit[base : base + span] = sym
    return short_len, short_lit, long_lists


def huf_uncompress(payload: bytes, n_out: int) -> np.ndarray:
    """hufUncompress: huffman stream -> ushort array of n_out values."""
    if n_out == 0:
        return np.zeros(0, dtype=np.uint16)
    if len(payload) < 20:
        raise PizError("huffman stream too short")
    im, iM, table_len, n_bits, _ = struct.unpack_from("<5I", payload, 0)
    if im >= HUF_ENCSIZE or iM >= HUF_ENCSIZE:
        raise PizError("corrupt huffman header")
    r = _BitReader(payload, 20)
    lengths = _unpack_enc_table(r, im, iM)
    codes = _canonical_codes(lengths)
    short_len, short_lit, long_lists = _build_dec_table(lengths, codes, im, iM)

    out = np.empty(n_out, dtype=np.uint16)
    n = 0
    rlc = iM
    data = payload
    pos = r.pos
    end = pos + (n_bits + 7) // 8
    if end > len(data):
        raise PizError("huffman stream truncated")
    c = 0
    lc = 0

    def emit(sym):
        nonlocal n, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if n == 0 or n + cs > n_out:
                raise PizError("corrupt run-length data")
            out[n : n + cs] = out[n - 1]
            n += cs
        else:
            if n >= n_out:
                raise PizError("too much huffman data")
            out[n] = sym
            n += 1

    while pos < end:
        c = (c << 8) | data[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            slot = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = int(short_len[slot])
            if l:
                lc -= l
                emit(int(short_lit[slot]))
            else:
                lst = long_lists.get(slot)
                if not lst:
                    raise PizError("invalid huffman code")
                for sym in lst:
                    sl = int(lengths[sym])
                    while lc < sl and pos < end:
                        c = (c << 8) | data[pos]
                        pos += 1
                        lc += 8
                    if lc >= sl and int(codes[sym]) == (
                        (c >> (lc - sl)) & ((1 << sl) - 1)
                    ):
                        lc -= sl
                        emit(sym)
                        break
                else:
                    raise PizError("invalid huffman code (long)")
    # flush: drop padding bits, then decode what remains using left-aligned
    # lookups (ImfHuf.cpp tail loop)
    i = (8 - n_bits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        slot = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = int(short_len[slot])
        if l and l <= lc:
            lc -= l
            emit(int(short_lit[slot]))
        else:
            break
    if n != n_out:
        raise PizError(f"huffman output short: {n} != {n_out}")
    return out


# ---------------------------------------------------------------------------
# chunk-level compress / decompress  (ImfPizCompressor.cpp)
# ---------------------------------------------------------------------------


def _channel_layout(channels, width: int, nrows: int):
    """[(n_ushorts_per_row, size)] per file channel; size = 1 for HALF,
    2 for FLOAT/UINT (treated as pairs of ushorts, like the reference)."""
    layout = []
    for ptype in channels:
        size = 1 if ptype == 1 else 2
        layout.append((width * size, size))
    return layout


def compress(raw: bytes, channels, width: int, nrows: int) -> bytes:
    """Scanline-interleaved raw bytes -> PIZ chunk payload.

    raw layout (the uncompressed EXR chunk): per scanline, each channel's
    row as a contiguous run. channels: per-channel pixel type ids in file
    order (0 UINT, 1 HALF, 2 FLOAT)."""
    layout = _channel_layout(channels, width, nrows)
    total = sum(nx for nx, _ in layout) * nrows
    tmp = np.empty(total, dtype=np.uint16)
    src = np.frombuffer(raw, dtype="<u2")
    # planar gather: channel-major blocks of (nrows, nx)
    starts = np.cumsum([0] + [nx * nrows for nx, _ in layout])
    row_stride = sum(nx for nx, _ in layout)
    row_off = np.cumsum([0] + [nx for nx, _ in layout])
    for ci, (nx, _) in enumerate(layout):
        block = src.reshape(nrows, row_stride)[:, row_off[ci] : row_off[ci] + nx]
        tmp[starts[ci] : starts[ci + 1]] = block.reshape(-1)

    bitmap, mn, mx = bitmap_from_data(tmp)
    lut, max_value = forward_lut_from_bitmap(bitmap)
    tmp = lut[tmp]

    for ci, (nx, size) in enumerate(layout):
        block = tmp[starts[ci] : starts[ci + 1]].reshape(nrows, nx)
        for j in range(size):
            wav2_encode(block[:, j::size], max_value)

    huf = huf_compress(tmp)
    out = struct.pack("<HH", mn, mx)
    if mn <= mx:
        out += bitmap[mn : mx + 1].tobytes()
    out += struct.pack("<I", len(huf)) + huf
    return out


def decompress(payload: bytes, channels, width: int, nrows: int) -> bytes:
    """PIZ chunk payload -> scanline-interleaved raw bytes (inverse of
    ``compress``; same layout the NONE/ZIP paths produce)."""
    if len(payload) < 4:
        raise PizError("piz chunk too short")
    mn, mx = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, dtype=np.uint8)
    if mx >= BITMAP_SIZE:
        raise PizError("corrupt piz bitmap range")
    if mn <= mx:
        nbytes = mx - mn + 1
        bitmap[mn : mx + 1] = np.frombuffer(payload, np.uint8, nbytes, pos)
        pos += nbytes
    lut, max_value = reverse_lut_from_bitmap(bitmap)
    (length,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    if pos + length > len(payload):
        raise PizError("piz huffman stream truncated")

    layout = _channel_layout(channels, width, nrows)
    total = sum(nx for nx, _ in layout) * nrows
    tmp = huf_uncompress(payload[pos : pos + length], total)

    starts = np.cumsum([0] + [nx * nrows for nx, _ in layout])
    for ci, (nx, size) in enumerate(layout):
        block = tmp[starts[ci] : starts[ci + 1]].reshape(nrows, nx)
        for j in range(size):
            wav2_decode(block[:, j::size], max_value)

    tmp = lut[tmp]

    row_stride = sum(nx for nx, _ in layout)
    row_off = np.cumsum([0] + [nx for nx, _ in layout])
    out = np.empty((nrows, row_stride), dtype="<u2")
    for ci, (nx, _) in enumerate(layout):
        out[:, row_off[ci] : row_off[ci] + nx] = tmp[
            starts[ci] : starts[ci + 1]
        ].reshape(nrows, nx)
    return out.tobytes()
