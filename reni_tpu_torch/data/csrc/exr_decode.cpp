// Native scanline-EXR chunk decoder for reni_tpu_torch.data.exr: the port's
// own copy of the JAX package's native/exr_decode.cpp.
//
// The Python module parses the (tiny) header and hands the chunk region to
// this library, which does the hot work: payload decompression (zlib
// inflate / RLE / PIZ), the EXR ZIP pre-filter inversion (delta-decode +
// half de-interleave, ImfZip.cpp uncompress path), HALF/FLOAT/UINT ->
// float32 conversion, and the scatter from channel-planar scanlines into
// an interleaved (H, W, C) float buffer. Chunks are independent, so they
// decode on a small thread pool; the ctypes call releases the GIL, so the
// Python-side ThreadPoolExecutor over files also scales (the pure-Python
// decoder is GIL-bound).
//
// PIZ (Huffman-coded 2D Haar wavelet, the default compression of many HDRI
// tools) is implemented from the published format — see
// reni_tpu_torch/data/piz.py for the commented reference implementation this is
// a port of; tests pin the two bit-identical.
//
// Replaces the native OpenEXR/imageio dependency of the reference
// (reference: src/data/datasets.py:80, environment.yml `openexr`).
//
// Build (data/exr.py does it at first use, into
// build/reni_tpu_torch/exr_decode-<hash>.so):
//   g++ -O3 -shared -fPIC -ffp-contract=off exr_decode.cpp -o exr_decode.so -lz
// (-ffp-contract=off is load-bearing: the DWA inverse-DCT must round
// exactly like the numpy float32 ops it is pinned against — FMA
// contraction on targets that have it would silently break the
// bit-exact native == Python == libOpenEXR contract.)

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// 65536-entry half->float table, built once (branch-free inner loops).
float g_half_table[65536];
std::atomic<bool> g_half_ready{false};

float half_bits_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {  // subnormal half (mant * 2^-24) -> normal float
      int e = 0;
      uint32_t m = mant;
      while (!(m & 0x400)) {
        m <<= 1;
        ++e;
      }
      m &= 0x3FF;
      // e shifts normalise the top set bit to 2^10: value = mant * 2^-24
      // = (1 + m/1024) * 2^(-14 - e), so the float exponent is 113 - e
      bits = sign | (static_cast<uint32_t>(127 - 14 - e) << 23) | (m << 13);
    }
  } else if (exp == 31) {  // inf / nan
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

void ensure_half_table() {
  if (g_half_ready.load(std::memory_order_acquire)) return;
  for (int i = 0; i < 65536; ++i)
    g_half_table[i] = half_bits_to_float(static_cast<uint16_t>(i));
  g_half_ready.store(true, std::memory_order_release);
}

// Invert the EXR ZIP pre-filter (ImfZip.cpp): delta-decode then
// de-interleave the two halves (out[0::2] = t[:half], out[1::2] = t[half:]).
void unpredict_deinterleave(const uint8_t* in, size_t n, uint8_t* out,
                            uint8_t* scratch) {
  if (n == 0) return;
  uint8_t prev = in[0];
  scratch[0] = prev;
  for (size_t i = 1; i < n; ++i) {
    prev = static_cast<uint8_t>(prev + in[i] - 128);
    scratch[i] = prev;
  }
  size_t half = (n + 1) / 2;
  const uint8_t* a = scratch;
  const uint8_t* b = scratch + half;
  size_t na = half, nb = n - half;
  for (size_t i = 0; i < nb; ++i) {
    out[2 * i] = a[i];
    out[2 * i + 1] = b[i];
  }
  if (na > nb) out[2 * nb] = a[nb];  // odd byte count
}

// OpenEXR RLE (ImfRle.cpp rleUncompress): signed count byte — negative n
// copies -n literal bytes, non-negative n repeats the next byte n+1 times.
bool rle_uncompress(const uint8_t* in, size_t n, uint8_t* out,
                    size_t out_size) {
  size_t i = 0, o = 0;
  while (i < n) {
    uint8_t b = in[i++];
    if (b > 127) {  // negative signed char: literal run
      size_t count = 256 - static_cast<size_t>(b);
      if (i + count > n || o + count > out_size) return false;
      std::memcpy(out + o, in + i, count);
      i += count;
      o += count;
    } else {
      size_t count = static_cast<size_t>(b) + 1;
      if (i >= n || o + count > out_size) return false;
      std::memset(out + o, in[i++], count);
      o += count;
    }
  }
  return o == out_size;
}

// ---------------------------------------------------------------------------
// PIZ decode (port of reni_tpu_torch/data/piz.py; original algorithm from the
// published OpenEXR ImfPizCompressor/ImfHuf/ImfWav format docs)
// ---------------------------------------------------------------------------

constexpr int USHORT_RANGE = 1 << 16;
constexpr int PIZ_BITMAP_SIZE = USHORT_RANGE >> 3;
constexpr int HUF_ENCSIZE = USHORT_RANGE + 1;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;
constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

struct PizCtx {
  std::vector<uint16_t> tmp;              // planar ushort buffer
  std::vector<uint16_t> lut;              // reverse LUT (65536)
  std::vector<uint8_t> bitmap;            // 8192
  std::vector<int32_t> lengths;           // code lengths (HUF_ENCSIZE)
  std::vector<uint64_t> codes;            // canonical codes (HUF_ENCSIZE)
  std::vector<int32_t> slen, slit;        // short-code table (HUF_DECSIZE)
  std::vector<std::vector<int>> longl;    // long-code lists per slot
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t c = 0;
  int lc = 0;
  bool ok = true;

  int read(int nbits) {
    while (lc < nbits) {
      if (p >= end) {
        ok = false;
        return 0;
      }
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= nbits;
    return static_cast<int>((c >> lc) & ((1u << nbits) - 1));
  }
};

uint16_t reverse_lut_from_bitmap(const uint8_t* bitmap, uint16_t* lut) {
  int k = 0;
  for (int i = 0; i < USHORT_RANGE; ++i) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = i;
  }
  int n = k - 1;
  while (k < USHORT_RANGE) lut[k++] = 0;
  return static_cast<uint16_t>(n);
}

// hufCanonicalCodeTable: derive canonical codes from code lengths.
void canonical_codes(const int32_t* lengths, uint64_t* codes) {
  uint64_t n[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i)
    if (lengths[i] > 0 && lengths[i] <= 58) n[lengths[i]]++;
  uint64_t c = 0;
  for (int i = 58; i > 0; --i) {
    uint64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int l = lengths[i];
    codes[i] = (l > 0) ? n[l]++ : 0;
  }
}

bool unpack_enc_table(BitReader& r, int im, int iM, int32_t* lengths) {
  std::memset(lengths, 0, sizeof(int32_t) * HUF_ENCSIZE);
  int i = im;
  while (i <= iM) {
    int l = r.read(6);
    if (!r.ok) return false;
    if (l == LONG_ZEROCODE_RUN) {
      int zerun = r.read(8) + SHORTEST_LONG_RUN;
      if (!r.ok || i + zerun > iM + 1) return false;
      i += zerun;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      int zerun = l - SHORT_ZEROCODE_RUN + 2;
      if (i + zerun > iM + 1) return false;
      i += zerun;
    } else {
      lengths[i++] = l;
    }
  }
  r.c = 0;  // the data stream starts at the next byte boundary
  r.lc = 0;
  return true;
}

bool build_dec_table(PizCtx& ctx, int im, int iM) {
  ctx.slen.assign(HUF_DECSIZE, 0);
  ctx.slit.assign(HUF_DECSIZE, 0);
  ctx.longl.assign(HUF_DECSIZE, {});
  for (int sym = im; sym <= iM; ++sym) {
    int l = ctx.lengths[sym];
    if (l == 0) continue;
    uint64_t c = ctx.codes[sym];
    if (c >> l) return false;
    if (l > HUF_DECBITS) {
      int slot = static_cast<int>(c >> (l - HUF_DECBITS));
      if (ctx.slen[slot]) return false;
      ctx.longl[slot].push_back(sym);
    } else {
      int base = static_cast<int>(c << (HUF_DECBITS - l));
      int span = 1 << (HUF_DECBITS - l);
      for (int s = base; s < base + span; ++s) {
        if (ctx.slen[s] || !ctx.longl[s].empty()) return false;
        ctx.slen[s] = l;
        ctx.slit[s] = sym;
      }
    }
  }
  return true;
}

bool huf_uncompress(PizCtx& ctx, const uint8_t* in, size_t n_in, uint16_t* out,
                    size_t n_out) {
  if (n_out == 0) return true;
  if (n_in < 20) return false;
  uint32_t im, iM, table_len, n_bits;
  std::memcpy(&im, in, 4);
  std::memcpy(&iM, in + 4, 4);
  std::memcpy(&table_len, in + 8, 4);
  std::memcpy(&n_bits, in + 12, 4);
  (void)table_len;
  if (im >= HUF_ENCSIZE || iM >= HUF_ENCSIZE) return false;
  BitReader r{in + 20, in + n_in};
  ctx.lengths.resize(HUF_ENCSIZE);
  ctx.codes.resize(HUF_ENCSIZE);
  if (!unpack_enc_table(r, im, iM, ctx.lengths.data())) return false;
  canonical_codes(ctx.lengths.data(), ctx.codes.data());
  if (!build_dec_table(ctx, im, iM)) return false;

  const uint8_t* p = r.p;
  const uint8_t* end = p + (n_bits + 7) / 8;
  if (end > in + n_in) return false;
  uint64_t c = 0;
  int lc = 0;
  size_t n = 0;
  const int rlc = iM;

  auto emit = [&](int sym) -> bool {
    if (sym == rlc) {
      if (lc < 8) {
        if (p >= end) return false;
        c = (c << 8) | *p++;
        lc += 8;
      }
      lc -= 8;
      int cs = static_cast<int>((c >> lc) & 0xFF);
      if (n == 0 || n + cs > n_out) return false;
      uint16_t s = out[n - 1];
      for (int k = 0; k < cs; ++k) out[n++] = s;
    } else {
      if (n >= n_out) return false;
      out[n++] = static_cast<uint16_t>(sym);
    }
    return true;
  };

  while (p < end) {
    c = (c << 8) | *p++;
    lc += 8;
    while (lc >= HUF_DECBITS) {
      int slot = static_cast<int>((c >> (lc - HUF_DECBITS)) & HUF_DECMASK);
      int l = ctx.slen[slot];
      if (l) {
        lc -= l;
        if (!emit(ctx.slit[slot])) return false;
      } else {
        const std::vector<int>& lst = ctx.longl[slot];
        if (lst.empty()) return false;
        bool found = false;
        for (int sym : lst) {
          int sl = ctx.lengths[sym];
          while (lc < sl && p < end) {
            c = (c << 8) | *p++;
            lc += 8;
          }
          if (lc >= sl &&
              ctx.codes[sym] == ((c >> (lc - sl)) & ((1ull << sl) - 1))) {
            lc -= sl;
            if (!emit(sym)) return false;
            found = true;
            break;
          }
        }
        if (!found) return false;
      }
    }
  }
  // drop the byte-padding bits, then decode the left-aligned tail
  int pad = (8 - static_cast<int>(n_bits)) & 7;
  c >>= pad;
  lc -= pad;
  while (lc > 0) {
    int slot = static_cast<int>((c << (HUF_DECBITS - lc)) & HUF_DECMASK);
    int l = ctx.slen[slot];
    if (l && l <= lc) {
      lc -= l;
      if (!emit(ctx.slit[slot])) return false;
    } else {
      break;
    }
  }
  return n == n_out;
}

// ImfWav.cpp wdec14/wdec16 + wav2Decode (strided lattice, scalar port).
inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = static_cast<int16_t>(l);
  int16_t hs = static_cast<int16_t>(h);
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = static_cast<int16_t>(ai);
  int16_t bs = static_cast<int16_t>(ai - hi);
  a = static_cast<uint16_t>(as);
  b = static_cast<uint16_t>(bs);
}

constexpr int W16_A_OFFSET = 1 << 15;
constexpr int W16_MOD_MASK = (1 << 16) - 1;

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l;
  int d = h;
  int bb = (m - (d >> 1)) & W16_MOD_MASK;
  int aa = (d + bb - W16_A_OFFSET) & W16_MOD_MASK;
  b = static_cast<uint16_t>(bb);
  a = static_cast<uint16_t>(aa);
}

void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = mx < (1 << 14);
  int n = (nx > ny) ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + static_cast<ptrdiff_t>(oy) * (ny - p2);
    int oy1 = oy * p, oy2 = oy * p2;
    int ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;
    uint16_t* px = py;
    for (; py <= ey; py += oy2) {
      px = py;
      uint16_t* ex = py + static_cast<ptrdiff_t>(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14)
          wdec14(*px, *p10, i00, *p10);
        else
          wdec16(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      px = py;
      uint16_t* ex = py + static_cast<ptrdiff_t>(ox) * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14)
          wdec14(*px, *p01, i00, *p01);
        else
          wdec16(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// Decode one PIZ chunk payload into scanline-interleaved raw bytes (the
// same layout the NONE/ZIP paths hand to the channel scatter).
bool piz_uncompress(PizCtx& ctx, const uint8_t* payload, size_t size,
                    int n_channels, const int32_t* ch_ptypes, int width,
                    int nrows, uint8_t* raw_out) {
  if (size < 4) return false;
  uint16_t mn, mx;
  std::memcpy(&mn, payload, 2);
  std::memcpy(&mx, payload + 2, 2);
  size_t pos = 4;
  if (mx >= PIZ_BITMAP_SIZE) return false;
  ctx.bitmap.assign(PIZ_BITMAP_SIZE, 0);
  if (mn <= mx) {
    size_t nb = static_cast<size_t>(mx) - mn + 1;
    if (pos + nb > size) return false;
    std::memcpy(ctx.bitmap.data() + mn, payload + pos, nb);
    pos += nb;
  }
  ctx.lut.resize(USHORT_RANGE);
  uint16_t max_value = reverse_lut_from_bitmap(ctx.bitmap.data(),
                                               ctx.lut.data());
  if (pos + 4 > size) return false;
  uint32_t length;
  std::memcpy(&length, payload + pos, 4);
  pos += 4;
  if (pos + length > size) return false;

  // channel layout: size 1 for HALF, 2 for FLOAT/UINT (ushort pairs)
  size_t total = 0;
  for (int ci = 0; ci < n_channels; ++ci)
    total += static_cast<size_t>(width) * (ch_ptypes[ci] == 1 ? 1 : 2) * nrows;
  ctx.tmp.resize(total);
  if (!huf_uncompress(ctx, payload + pos, length, ctx.tmp.data(), total))
    return false;

  size_t start = 0;
  for (int ci = 0; ci < n_channels; ++ci) {
    int csize = ch_ptypes[ci] == 1 ? 1 : 2;
    int nx = width;  // pixels per row
    for (int j = 0; j < csize; ++j)
      wav2_decode(ctx.tmp.data() + start + j, nx, csize, nrows, nx * csize,
                  max_value);
    start += static_cast<size_t>(nx) * csize * nrows;
  }
  for (size_t i = 0; i < total; ++i) ctx.tmp[i] = ctx.lut[ctx.tmp[i]];

  // planar -> scanline-interleaved (per row, channels in file order)
  size_t row_ushorts = 0;
  for (int ci = 0; ci < n_channels; ++ci)
    row_ushorts += static_cast<size_t>(width) * (ch_ptypes[ci] == 1 ? 1 : 2);
  uint16_t* out16 = reinterpret_cast<uint16_t*>(raw_out);
  size_t ch_start = 0;
  size_t col = 0;
  for (int ci = 0; ci < n_channels; ++ci) {
    size_t nx = static_cast<size_t>(width) * (ch_ptypes[ci] == 1 ? 1 : 2);
    for (int r = 0; r < nrows; ++r)
      std::memcpy(out16 + static_cast<size_t>(r) * row_ushorts + col,
                  ctx.tmp.data() + ch_start + static_cast<size_t>(r) * nx,
                  nx * 2);
    ch_start += nx * nrows;
    col += nx;
  }
  return true;
}

// PXR24 (ImfPxr24Compressor): per-row MSB-first byte planes of horizontal
// value deltas (HALF 16-bit lossless, FLOAT rounded to 24 bits, UINT 32),
// whole chunk deflated. Reconstructs the standard scanline-interleaved raw
// layout (FLOAT values as f24 bits << 8).
bool pxr24_uncompress(const uint8_t* payload, size_t size, int n_channels,
                      const int32_t* ch_ptypes, int width, int nrows,
                      std::vector<uint8_t>& inflate_buf, uint8_t* raw_out) {
  size_t tmp_size = 0;
  for (int ci = 0; ci < n_channels; ++ci) {
    int nb = ch_ptypes[ci] == 1 ? 2 : (ch_ptypes[ci] == 2 ? 3 : 4);
    tmp_size += static_cast<size_t>(width) * nb;
  }
  tmp_size *= nrows;
  inflate_buf.resize(tmp_size);
  uLongf dest_len = tmp_size;
  if (uncompress(inflate_buf.data(), &dest_len, payload,
                 static_cast<uLong>(size)) != Z_OK ||
      dest_len != tmp_size)
    return false;

  const uint8_t* p = inflate_buf.data();
  uint8_t* out = raw_out;
  for (int r = 0; r < nrows; ++r) {
    for (int ci = 0; ci < n_channels; ++ci) {
      int pt = ch_ptypes[ci];
      if (pt == 1) {  // HALF: 2 planes
        const uint8_t* p0 = p;
        const uint8_t* p1 = p + width;
        p += 2 * static_cast<size_t>(width);
        uint16_t prev = 0;
        for (int x = 0; x < width; ++x) {
          uint16_t diff = static_cast<uint16_t>((p0[x] << 8) | p1[x]);
          prev = static_cast<uint16_t>(prev + diff);
          std::memcpy(out + 2 * static_cast<size_t>(x), &prev, 2);
        }
        out += 2 * static_cast<size_t>(width);
      } else if (pt == 2) {  // FLOAT: 3 planes of f24 deltas
        const uint8_t* p0 = p;
        const uint8_t* p1 = p + width;
        const uint8_t* p2 = p + 2 * static_cast<size_t>(width);
        p += 3 * static_cast<size_t>(width);
        uint32_t prev = 0;
        for (int x = 0; x < width; ++x) {
          uint32_t diff = (static_cast<uint32_t>(p0[x]) << 16) |
                          (static_cast<uint32_t>(p1[x]) << 8) | p2[x];
          prev = (prev + diff) & 0xFFFFFFu;
          uint32_t v = prev << 8;
          std::memcpy(out + 4 * static_cast<size_t>(x), &v, 4);
        }
        out += 4 * static_cast<size_t>(width);
      } else {  // UINT: 4 planes
        const uint8_t* p0 = p;
        const uint8_t* p1 = p + width;
        const uint8_t* p2 = p + 2 * static_cast<size_t>(width);
        const uint8_t* p3 = p + 3 * static_cast<size_t>(width);
        p += 4 * static_cast<size_t>(width);
        uint32_t prev = 0;
        for (int x = 0; x < width; ++x) {
          uint32_t diff = (static_cast<uint32_t>(p0[x]) << 24) |
                          (static_cast<uint32_t>(p1[x]) << 16) |
                          (static_cast<uint32_t>(p2[x]) << 8) | p3[x];
          prev += diff;
          std::memcpy(out + 4 * static_cast<size_t>(x), &prev, 4);
        }
        out += 4 * static_cast<size_t>(width);
      }
    }
  }
  return true;
}

// ---- B44 / B44A (compression ids 6/7) -------------------------------------
//
// HALF channels as 4x4 blocks packed to 14 bytes (16-bit first value,
// 6-bit shift, fifteen 6-bit modular deltas over a fixed prediction
// chain) or 3 bytes for B44A's flat blocks; non-HALF channels raw.
// Reference implementation with the chain/bit layout commented:
// reni_tpu_torch/data/b44.py (the two are pinned bit-identical).

inline uint16_t b44_from_ordered(uint32_t t) {
  return (t & 0x8000) ? static_cast<uint16_t>(t & 0x7FFF)
                      : static_cast<uint16_t>(~t);
}

void b44_unpack14(const uint8_t* b, uint16_t* s) {
  uint32_t v[16];
  v[0] = (static_cast<uint32_t>(b[0]) << 8) | b[1];
  const uint32_t shift = b[2] >> 2;
  const uint32_t bias = 0x20u << shift;
  auto link = [&](int dst, int pred, uint32_t code) {
    v[dst] = (v[pred] + (code << shift) - bias) & 0xFFFF;
  };
  link(4, 0, ((b[2] << 4) | (b[3] >> 4)) & 0x3F);
  link(8, 4, ((b[3] << 2) | (b[4] >> 6)) & 0x3F);
  link(12, 8, b[4] & 0x3F);
  link(1, 0, b[5] >> 2);
  link(5, 4, ((b[5] << 4) | (b[6] >> 4)) & 0x3F);
  link(9, 8, ((b[6] << 2) | (b[7] >> 6)) & 0x3F);
  link(13, 12, b[7] & 0x3F);
  link(2, 1, b[8] >> 2);
  link(6, 5, ((b[8] << 4) | (b[9] >> 4)) & 0x3F);
  link(10, 9, ((b[9] << 2) | (b[10] >> 6)) & 0x3F);
  link(14, 13, b[10] & 0x3F);
  link(3, 2, b[11] >> 2);
  link(7, 6, ((b[11] << 4) | (b[12] >> 4)) & 0x3F);
  link(11, 10, ((b[12] << 2) | (b[13] >> 6)) & 0x3F);
  link(15, 14, b[13] & 0x3F);
  for (int i = 0; i < 16; ++i) s[i] = b44_from_ordered(v[i]);
}

bool b44_uncompress(const uint8_t* payload, size_t size, int n_channels,
                    const int32_t* ptypes, int width, int nrows,
                    uint8_t* out /* scanline-interleaved */) {
  std::vector<size_t> ch_off(n_channels);
  size_t row_bytes = 0;
  for (int c = 0; c < n_channels; ++c) {
    ch_off[c] = row_bytes;
    row_bytes += static_cast<size_t>(width) * (ptypes[c] == 1 ? 2 : 4);
  }
  size_t pos = 0;
  for (int c = 0; c < n_channels; ++c) {
    if (ptypes[c] != 1) {  // UINT / FLOAT: raw plane copy
      size_t n = static_cast<size_t>(nrows) * width * 4;
      if (pos + n > size) return false;
      for (int r = 0; r < nrows; ++r)
        std::memcpy(out + static_cast<size_t>(r) * row_bytes + ch_off[c],
                    payload + pos + static_cast<size_t>(r) * width * 4,
                    static_cast<size_t>(width) * 4);
      pos += n;
      continue;
    }
    const int bh = (nrows + 3) / 4, bw = (width + 3) / 4;
    for (int by = 0; by < bh; ++by) {
      for (int bx = 0; bx < bw; ++bx) {
        uint16_t s[16];
        if (pos + 3 > size) return false;
        if (payload[pos + 2] >= (13 << 2)) {  // flat 3-byte block (B44A)
          uint16_t v = b44_from_ordered(
              (static_cast<uint32_t>(payload[pos]) << 8) | payload[pos + 1]);
          for (int i = 0; i < 16; ++i) s[i] = v;
          pos += 3;
        } else {
          if (pos + 14 > size) return false;
          b44_unpack14(payload + pos, s);
          pos += 14;
        }
        const int ny = nrows - by * 4 < 4 ? nrows - by * 4 : 4;
        const int nx = width - bx * 4 < 4 ? width - bx * 4 : 4;
        for (int i = 0; i < ny; ++i) {
          uint8_t* dst = out + static_cast<size_t>(by * 4 + i) * row_bytes +
                         ch_off[c] + static_cast<size_t>(bx) * 4 * 2;
          std::memcpy(dst, &s[i * 4], static_cast<size_t>(nx) * 2);
        }
      }
    }
  }
  return pos <= size;
}

size_t itemsize(int ptype) { return ptype == 1 ? 2 : 4; }

// ---- DWA / DWAA / DWAB (compression ids 8/9) -------------------------------
//
// JPEG-style lossy scheme: channels classified by NAME into LOSSY_DCT
// (8x8 DCT of a perceptual nonlinearity, optional RGB->Y/BY/RY
// decorrelation), RLE (alpha) and UNKNOWN (lossless). AC coefficients are
// run-length tokenized and entropy-coded with the PIZ Huffman coder above.
// Port of reni_tpu_torch/data/dwa.py (the commented reference implementation);
// the two are pinned bit-identical, and dwa.py itself is pinned
// bit-for-bit against the system libOpenEXR in tests/test_exr_oracle.py.
// The toLinear half-bit lookup table is passed in from Python so both
// decoders index the SAME table (avoids libm powf/np.power ulp drift).

// float32 -> half bits, IEEE round-to-nearest-even (matches numpy's
// float32->float16 cast for every finite input; DWA maps all inf/NaN
// halves to 0 through the toLinear table, so payload details are moot).
uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  x &= 0x7FFFFFFFu;
  if (x >= 0x7F800000u) {  // inf / nan
    uint32_t m = x & 0x7FFFFFu;
    return static_cast<uint16_t>(sign | 0x7C00u |
                                 (m ? (0x200u | (m >> 13)) : 0));
  }
  if (x >= 0x38800000u) {  // normal half range (may round up to inf)
    uint32_t r = x + 0xFFFu + ((x >> 13) & 1u);
    r = (r - 0x38000000u) >> 13;
    if (r >= 0x7C00u) return static_cast<uint16_t>(sign | 0x7C00u);
    return static_cast<uint16_t>(sign | r);
  }
  if (x < 0x33000000u) return static_cast<uint16_t>(sign);  // < 2^-25 -> 0
  // subnormal half: value in [2^-25, 2^-14)
  int e = static_cast<int>(x >> 23);
  uint32_t m = (x & 0x7FFFFFu) | 0x800000u;
  int shift = 126 - e;  // 14..24
  uint32_t q = m >> shift;
  uint32_t rem = m & ((1u << shift) - 1u);
  uint32_t halfway = 1u << (shift - 1);
  if (rem > halfway || (rem == halfway && (q & 1u))) ++q;
  return static_cast<uint16_t>(sign | q);
}

// The AVX inverse-DCT constant set baked into libOpenEXR's .rodata
// (dwa.py _AVX_CONSTS; 1-3 ulps from the scalar cosf values). Order:
// a, b, d, e, g, c, f.
constexpr uint32_t kDwaAvxBits[7] = {0x3EB504FA, 0x3EFB14C1, 0x3ED4DB34,
                                     0x3E8E39E7, 0x3DC7C60E, 0x3EEC8360,
                                     0x3E43EF36};

inline float bits_to_float(uint32_t b) {
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}

// In-place 8x8 inverse DCT replicating dwa.py::_idct8x8 — the library's
// AVX matrix-multiply formulation with its pairwise-summation trees —
// operation for operation in float32 (this file builds without FMA
// contraction: baseline x86-64 has no FMA and -ffp-contract=off is passed,
// so every multiply/add rounds exactly like the numpy float32 ops).
void dwa_idct8x8(float* m) {
  const float ka = bits_to_float(kDwaAvxBits[0]);
  const float kb = bits_to_float(kDwaAvxBits[1]);
  const float kd = bits_to_float(kDwaAvxBits[2]);
  const float ke = bits_to_float(kDwaAvxBits[3]);
  const float kg = bits_to_float(kDwaAvxBits[4]);
  const float kc = bits_to_float(kDwaAvxBits[5]);
  const float kf = bits_to_float(kDwaAvxBits[6]);

  // row pass: even rows [a,a,a,a],[c,f,-f,-c],[a,-a,-a,a],[f,-c,c,-f];
  // odd rows [b,d,e,g],[d,-g,-b,-e],[e,-b,g,d],[g,-e,d,-b]
  const float m1j[4] = {kc, kf, -kf, -kc};
  const float m2j[4] = {ka, -ka, -ka, ka};
  const float m3j[4] = {kf, -kc, kc, -kf};
  const float m4j[4] = {kb, kd, ke, kg};
  const float m5j[4] = {kd, -kg, -kb, -ke};
  const float m6j[4] = {ke, -kb, kg, kd};
  const float m7j[4] = {kg, -ke, kd, -kb};
  float tmp[64];
  for (int r = 0; r < 8; ++r) {
    const float* x = m + r * 8;
    float* o = tmp + r * 8;
    for (int j = 0; j < 4; ++j) {
      float ev = (x[0] * ka + x[2] * m1j[j]) + (x[4] * m2j[j] + x[6] * m3j[j]);
      float od =
          (x[1] * m4j[j] + x[3] * m5j[j]) + (x[5] * m6j[j] + x[7] * m7j[j]);
      o[j] = ev + od;
      o[7 - j] = ev - od;
    }
  }

  // column pass: explicit association trees over the row vectors
  for (int j = 0; j < 8; ++j) {
    float r0 = tmp[0 * 8 + j], r1 = tmp[1 * 8 + j], r2 = tmp[2 * 8 + j],
          r3 = tmp[3 * 8 + j], r4 = tmp[4 * 8 + j], r5 = tmp[5 * 8 + j],
          r6 = tmp[6 * 8 + j], r7 = tmp[7 * 8 + j];
    float beta0 = (kb * r1 + kd * r3) + (ke * r5 + kg * r7);
    float beta1 = (kd * r1 - (kg * r3 + kb * r5)) - ke * r7;
    float beta2 = ((ke * r1 - kb * r3) + kg * r5) + kd * r7;
    float beta3 = (kg * r1 + kd * r5) - (ke * r3 + kb * r7);
    float ar0 = ka * r0;
    float ar4 = ka * r4;
    float t0p = ar0 + ar4;  // NOT a*(r0+r4): the AVX path multiplies first
    float t0m = ar0 - ar4;
    float theta1 = kc * r2 + kf * r6;
    float theta2 = kf * r2 - kc * r6;
    float g0 = t0p + theta1;
    float g3 = t0p - theta1;
    float g1 = t0m + theta2;
    float g2 = t0m - theta2;
    m[0 * 8 + j] = g0 + beta0;
    m[1 * 8 + j] = g1 + beta1;
    m[2 * 8 + j] = g2 + beta2;
    m[3 * 8 + j] = g3 + beta3;
    m[4 * 8 + j] = g3 - beta3;
    m[5 * 8 + j] = g2 - beta2;
    m[6 * 8 + j] = g1 - beta1;
    m[7 * 8 + j] = g0 - beta0;
  }
}

// Rec.709 inverse decorrelation (dwa.py float32 literals, same op order).
inline void dwa_csc_inverse(float y, float by, float ry, float& r, float& g,
                            float& b) {
  r = y + 1.5747f * ry;
  g = (y - 0.1873f * by) - 0.4682f * ry;
  b = y + 1.8556f * by;
}

// zig-zag position -> row-major flat index (the JPEG order; dwa.py
// _zigzag_to_flat).
const int* dwa_zig_to_flat() {
  static const auto table = [] {
    std::array<int, 64> t{};
    int p = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = s - 7 > 0 ? s - 7 : 0;
      int hi = s < 7 ? s : 7;
      if (s % 2 == 0) {
        for (int i = lo; i <= hi; ++i) t[p++] = (s - i) * 8 + i;
      } else {  // odd diagonals run the reverse direction
        for (int i = hi; i >= lo; --i) t[p++] = (s - i) * 8 + i;
      }
    }
    return t;
  }();
  return table.data();
}

constexpr int DWA_UNKNOWN = 0, DWA_LOSSY_DCT = 1, DWA_RLE = 2;

struct DwaRule {
  std::string suffix;
  int csc;
  int scheme;
  bool ci;
  int ptype;
};

// The published encoder's default classification, used only for
// pre-version-2 chunks (dwa.py _DEFAULT_RULES, same order).
const std::vector<DwaRule>& dwa_default_rules() {
  static const std::vector<DwaRule> rules = [] {
    std::vector<DwaRule> r;
    for (int t : {1, 2}) r.push_back({"R", 0, DWA_LOSSY_DCT, false, t});
    for (int t : {1, 2}) r.push_back({"G", 1, DWA_LOSSY_DCT, false, t});
    for (int t : {1, 2}) r.push_back({"B", 2, DWA_LOSSY_DCT, false, t});
    for (const char* s : {"Y", "BY", "RY"})
      for (int t : {1, 2}) r.push_back({s, -1, DWA_LOSSY_DCT, false, t});
    for (int t : {0, 1, 2}) r.push_back({"A", -1, DWA_RLE, false, t});
    return r;
  }();
  return rules;
}

// ASCII-only lowercase — the published implementation's case-insensitive
// rule match goes through C-locale tolower, leaving non-ASCII bytes
// untouched (dwa.py::_ascii_lower mirrors this).
std::string dwa_lower(const std::string& s) {
  std::string out = s;
  for (char& c : out)
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
  return out;
}

// Channel classification (dwa.py _classify): per-channel (scheme, csc)
// from the first matching rule, then the ordered LOSSY_DCT channel sets —
// complete R/G/B csc groups by name prefix first, lone DCT channels after.
void dwa_classify(const std::vector<std::string>& names, const int32_t* ptypes,
                  int n, const std::vector<DwaRule>& rules,
                  std::vector<int>& schemes, std::vector<std::vector<int>>& sets) {
  schemes.assign(n, DWA_UNKNOWN);
  std::vector<int> cscs(n, -1);
  std::vector<std::string> suffixes(n), prefixes(n);
  for (int i = 0; i < n; ++i) {
    const std::string& name = names[i];
    size_t dot = name.rfind('.');
    suffixes[i] = dot == std::string::npos ? name : name.substr(dot + 1);
    prefixes[i] = name.substr(0, name.size() - suffixes[i].size());
    for (const DwaRule& r : rules) {
      if (r.ptype != ptypes[i]) continue;
      bool match = r.ci ? dwa_lower(suffixes[i]) == dwa_lower(r.suffix)
                        : suffixes[i] == r.suffix;
      if (match) {
        schemes[i] = r.scheme;
        cscs[i] = r.csc;
        break;
      }
    }
  }

  // groups by prefix in first-appearance order; last channel wins a
  // duplicate csc slot (dict semantics of the reference implementation)
  std::vector<std::string> order;
  std::vector<std::vector<std::pair<int, int>>> groups;  // (csc, idx)
  for (int i = 0; i < n; ++i) {
    if (schemes[i] != DWA_LOSSY_DCT || cscs[i] < 0) continue;
    size_t gi = 0;
    for (; gi < order.size(); ++gi)
      if (order[gi] == prefixes[i]) break;
    if (gi == order.size()) {
      order.push_back(prefixes[i]);
      groups.emplace_back();
    }
    bool replaced = false;
    for (auto& kv : groups[gi])
      if (kv.first == cscs[i]) {
        kv.second = i;
        replaced = true;
        break;
      }
    if (!replaced) groups[gi].push_back({cscs[i], i});
  }

  sets.clear();
  std::vector<bool> in_set(n, false);
  for (size_t gi = 0; gi < order.size(); ++gi) {
    const auto& g = groups[gi];
    if (g.size() != 3) continue;
    int idx_by_csc[3] = {-1, -1, -1};
    bool complete = true;
    for (const auto& kv : g) {
      if (kv.first < 0 || kv.first > 2) {
        complete = false;
        break;
      }
      idx_by_csc[kv.first] = kv.second;
    }
    if (!complete || idx_by_csc[0] < 0 || idx_by_csc[1] < 0 ||
        idx_by_csc[2] < 0)
      continue;
    sets.push_back({idx_by_csc[0], idx_by_csc[1], idx_by_csc[2]});
    for (int ix : idx_by_csc) in_set[ix] = true;
  }
  for (int i = 0; i < n; ++i)
    if (schemes[i] == DWA_LOSSY_DCT && !in_set[i]) sets.push_back({i});
}

inline uint64_t dwa_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// One DWA chunk/tile -> scanline-interleaved raw bytes (per row, each
// channel's run in file order; DCT FLOAT channels widened from half).
// dwa.py::decompress, section order UNKNOWN / AC / DC / RLE.
bool dwa_uncompress(PizCtx& piz_ctx, const uint8_t* payload, size_t size,
                    int n_channels, const int32_t* ptypes,
                    const std::vector<std::string>& names,
                    const uint16_t* to_linear, int width, int nrows,
                    uint8_t* raw_out) {
  if (size < 88 || to_linear == nullptr ||
      static_cast<int>(names.size()) != n_channels)
    return false;
  const uint64_t version = dwa_le64(payload);
  const uint64_t unk_usize = dwa_le64(payload + 8);
  const uint64_t unk_csize = dwa_le64(payload + 16);
  const uint64_t ac_csize = dwa_le64(payload + 24);
  const uint64_t dc_csize = dwa_le64(payload + 32);
  const uint64_t rle_csize = dwa_le64(payload + 40);
  const uint64_t rle_usize = dwa_le64(payload + 48);
  const uint64_t rle_raw_size = dwa_le64(payload + 56);
  const uint64_t ac_count = dwa_le64(payload + 64);
  const uint64_t dc_count = dwa_le64(payload + 72);
  const uint64_t ac_compression = dwa_le64(payload + 80);

  std::vector<DwaRule> parsed_rules;
  const std::vector<DwaRule>* rules;
  size_t pos = 88;
  if (version < 2) {
    rules = &dwa_default_rules();
  } else {
    if (size < 90) return false;
    uint16_t total;
    std::memcpy(&total, payload + 88, 2);
    if (total < 2 || 88 + static_cast<size_t>(total) > size) return false;
    size_t end = 88 + total;
    size_t rp = 90;
    while (rp < end) {
      size_t ne = rp;
      while (ne < end && payload[ne] != 0) ++ne;
      if (ne >= end) return false;
      std::string suffix(reinterpret_cast<const char*>(payload + rp), ne - rp);
      rp = ne + 1;
      if (rp + 2 > end) return false;
      uint8_t b1 = payload[rp], b2 = payload[rp + 1];
      rp += 2;
      parsed_rules.push_back({suffix, ((b1 >> 4) & 0xF) - 1, (b1 >> 2) & 3,
                              (b1 & 1) != 0, b2});
    }
    rules = &parsed_rules;
    pos = end;
  }

  // section bounds (uint64 sizes: guard against overflowing size_t sums)
  const uint64_t remaining = size - pos;
  if (unk_csize > remaining || ac_csize > remaining - unk_csize ||
      dc_csize > remaining - unk_csize - ac_csize ||
      rle_csize > remaining - unk_csize - ac_csize - dc_csize)
    return false;
  const uint8_t* unknown_c = payload + pos;
  const uint8_t* ac_c = unknown_c + unk_csize;
  const uint8_t* dc_c = ac_c + ac_csize;
  const uint8_t* rle_c = dc_c + dc_csize;

  // sanity-bound the declared element counts by what this chunk's pixel
  // grid could possibly hold (a corrupt header must not drive allocation)
  const size_t npix = static_cast<size_t>(width) * nrows;
  const size_t nbx = (width + 7) / 8, nby = (nrows + 7) / 8;
  const size_t nblocks = nbx * nby;
  if (ac_count > 65 * nblocks * static_cast<uint64_t>(n_channels) ||
      dc_count > nblocks * static_cast<uint64_t>(n_channels) ||
      unk_usize > 4 * npix * static_cast<uint64_t>(n_channels) ||
      rle_raw_size > 4 * npix * static_cast<uint64_t>(n_channels) ||
      rle_usize > 2 * rle_raw_size + 64)
    return false;

  std::vector<int> schemes;
  std::vector<std::vector<int>> sets;
  dwa_classify(names, ptypes, n_channels, *rules, schemes, sets);

  // --- section decode ------------------------------------------------------
  std::vector<uint16_t> tokens(static_cast<size_t>(ac_count));
  if (ac_count) {
    if (ac_compression == 0) {  // STATIC_HUFFMAN (the PIZ coder)
      if (!huf_uncompress(piz_ctx, ac_c, ac_csize, tokens.data(),
                          tokens.size()))
        return false;
    } else if (ac_compression == 1) {  // DEFLATE
      uLongf dest_len = 2 * tokens.size();
      if (uncompress(reinterpret_cast<uint8_t*>(tokens.data()), &dest_len,
                     ac_c, static_cast<uLong>(ac_csize)) != Z_OK ||
          dest_len != 2 * tokens.size())
        return false;
    } else {
      return false;
    }
  }

  std::vector<uint16_t> dc(static_cast<size_t>(dc_count));
  if (dc_count) {
    const size_t dc_bytes = 2 * dc.size();
    std::vector<uint8_t> predicted(dc_bytes), scratch(dc_bytes);
    uLongf dest_len = dc_bytes;
    if (uncompress(predicted.data(), &dest_len, dc_c,
                   static_cast<uLong>(dc_csize)) != Z_OK ||
        dest_len != dc_bytes)
      return false;
    unpredict_deinterleave(predicted.data(), dc_bytes,
                           reinterpret_cast<uint8_t*>(dc.data()),
                           scratch.data());
  }

  std::vector<uint8_t> rle_raw(static_cast<size_t>(rle_raw_size));
  if (rle_csize) {
    std::vector<uint8_t> rle_stream(static_cast<size_t>(rle_usize));
    uLongf dest_len = rle_stream.size();
    if (uncompress(rle_stream.data(), &dest_len, rle_c,
                   static_cast<uLong>(rle_csize)) != Z_OK ||
        dest_len != rle_stream.size())
      return false;
    if (!rle_uncompress(rle_stream.data(), rle_stream.size(), rle_raw.data(),
                        rle_raw.size()))
      return false;
  } else if (rle_raw_size) {
    return false;
  }

  std::vector<uint8_t> unknown_raw(static_cast<size_t>(unk_usize));
  if (unk_csize) {
    uLongf dest_len = unknown_raw.size();
    if (uncompress(unknown_raw.data(), &dest_len, unknown_c,
                   static_cast<uLong>(unk_csize)) != Z_OK ||
        dest_len != unknown_raw.size())
      return false;
  } else if (unk_usize) {
    return false;
  }

  // --- LOSSY_DCT channel sets ----------------------------------------------
  const int* zig = dwa_zig_to_flat();
  std::vector<std::vector<uint16_t>> planes(n_channels);  // post-toLinear
  size_t ti = 0, di = 0;
  for (const auto& chan_set : sets) {
    const int nch = static_cast<int>(chan_set.size());
    for (int ci : chan_set) {
      if (ptypes[ci] == 0) return false;  // UINT cannot carry a DCT plane
      planes[ci].assign(npix, 0);
    }
    if (di + static_cast<size_t>(nch) * nblocks > dc.size()) return false;
    float spatial[3][64];
    for (size_t b = 0; b < nblocks; ++b) {
      for (int c = 0; c < nch; ++c) {
        uint16_t zz[64] = {0};
        int zp = 1;
        while (zp < 64) {
          if (ti >= tokens.size()) return false;  // AC stream underrun
          uint16_t t = tokens[ti++];
          if (t >= 0xFF00) {
            if (t == 0xFF00) break;
            zp += t - 0xFF00;
          } else {
            zz[zp++] = t;
          }
        }
        zz[0] = dc[di + static_cast<size_t>(c) * nblocks + b];
        float* mblk = spatial[c];
        for (int p2 = 0; p2 < 64; ++p2) mblk[zig[p2]] = g_half_table[zz[p2]];
        dwa_idct8x8(mblk);
      }
      if (nch == 3) {
        for (int p2 = 0; p2 < 64; ++p2) {
          float r, g, bl;
          dwa_csc_inverse(spatial[0][p2], spatial[1][p2], spatial[2][p2], r, g,
                          bl);
          spatial[0][p2] = r;
          spatial[1][p2] = g;
          spatial[2][p2] = bl;
        }
      }
      const size_t by = b / nbx, bx = b % nbx;
      const int ny = static_cast<int>(nrows - by * 8) < 8
                         ? static_cast<int>(nrows - by * 8)
                         : 8;
      const int nx = static_cast<int>(width - bx * 8) < 8
                         ? static_cast<int>(width - bx * 8)
                         : 8;
      for (int c = 0; c < nch; ++c) {
        uint16_t* pl = planes[chan_set[c]].data();
        for (int i = 0; i < ny; ++i)
          for (int j = 0; j < nx; ++j)
            pl[(by * 8 + i) * width + bx * 8 + j] =
                to_linear[f32_to_f16(spatial[c][i * 8 + j])];
      }
    }
    di += static_cast<size_t>(nch) * nblocks;
  }
  if (di != dc.size()) return false;  // DC stream not fully consumed
  if (ti != tokens.size()) return false;  // AC stream not fully consumed

  // --- assemble scanline-interleaved output --------------------------------
  std::vector<size_t> ch_off(n_channels);
  size_t row_bytes = 0;
  for (int c = 0; c < n_channels; ++c) {
    ch_off[c] = row_bytes;
    row_bytes += static_cast<size_t>(width) * itemsize(ptypes[c]);
  }

  size_t rp = 0, up = 0;
  for (int c = 0; c < n_channels; ++c) {
    const size_t esz = itemsize(ptypes[c]);
    if (schemes[c] == DWA_LOSSY_DCT) {
      const uint16_t* pl = planes[c].data();
      if (ptypes[c] == 1) {  // HALF
        for (int r = 0; r < nrows; ++r)
          std::memcpy(raw_out + static_cast<size_t>(r) * row_bytes + ch_off[c],
                      pl + static_cast<size_t>(r) * width,
                      static_cast<size_t>(width) * 2);
      } else {  // FLOAT: widen the lossy half
        for (int r = 0; r < nrows; ++r) {
          uint8_t* dst = raw_out + static_cast<size_t>(r) * row_bytes +
                         ch_off[c];
          for (int x = 0; x < width; ++x) {
            float v = g_half_table[pl[static_cast<size_t>(r) * width + x]];
            std::memcpy(dst + 4 * static_cast<size_t>(x), &v, 4);
          }
        }
      }
    } else if (schemes[c] == DWA_RLE) {
      // per channel: little-endian byte planes over the whole chunk
      if (rp + esz * npix > rle_raw.size()) return false;
      for (int r = 0; r < nrows; ++r) {
        uint8_t* dst = raw_out + static_cast<size_t>(r) * row_bytes + ch_off[c];
        for (int x = 0; x < width; ++x) {
          const size_t sample = static_cast<size_t>(r) * width + x;
          for (size_t j = 0; j < esz; ++j)
            dst[static_cast<size_t>(x) * esz + j] =
                rle_raw[rp + j * npix + sample];
        }
      }
      rp += esz * npix;
    } else {  // UNKNOWN: raw plane
      if (up + esz * npix > unknown_raw.size()) return false;
      for (int r = 0; r < nrows; ++r)
        std::memcpy(raw_out + static_cast<size_t>(r) * row_bytes + ch_off[c],
                    unknown_raw.data() + up + static_cast<size_t>(r) * width * esz,
                    static_cast<size_t>(width) * esz);
      up += esz * npix;
    }
  }
  return true;
}

struct ChunkInfo {
  int y;
  const uint8_t* payload;
  size_t size;
};

struct DecodeJob {
  const std::vector<ChunkInfo>* chunks;
  int lines_per_chunk;
  int compression;  // 0 NONE, 1 RLE, 2 ZIPS, 3 ZIP, 4 PIZ, 5 PXR24,
                    // 6/7 B44[A], 8/9 DWA[A/B]
  int width;
  int height;
  int ymin;
  int n_file_channels;
  const int32_t* ch_ptypes;  // 0 UINT, 1 HALF, 2 FLOAT (file channel order)
  const int32_t* ch_out;     // output channel index or -1 (file channel order)
  int out_channels;
  float* out;  // (height, width, out_channels), interleaved
  const std::vector<std::string>* ch_names;  // file order (DWA classification)
  const uint16_t* dwa_to_linear;             // 65536-entry table (DWA only)
  std::atomic<int>* next;
  std::atomic<int>* err;
};

struct DecodeBuffers {
  std::vector<uint8_t> raw, scratch, inflated;
  PizCtx piz;  // reusable PIZ/Huffman buffers
};

// Decompress one chunk/tile payload of `cw` x `nrows` pixels into the
// scanline-interleaved raw layout; sets *src to the decoded bytes (the
// payload itself when stored raw). Returns 0 or the error code.
int decompress_payload(DecodeBuffers& bufs, const uint8_t* payload,
                       size_t size, int compression, int n_file_channels,
                       const int32_t* ch_ptypes,
                       const std::vector<std::string>& names,
                       const uint16_t* dwa_to_linear, int cw, int nrows,
                       size_t raw_size, const uint8_t** src) {
  if (bufs.raw.size() < raw_size) {
    bufs.raw.resize(raw_size);
    bufs.scratch.resize(raw_size);
    bufs.inflated.resize(raw_size);
  }
  if (compression == 0 || size >= raw_size) {
    // uncompressed, or the writer stored the chunk raw (chunks whose
    // compressed output would not shrink)
    if (size < raw_size) return 3;
    *src = payload;
    return 0;
  }
  if (compression == 1) {  // RLE (+ the shared ZIP pre-filter)
    if (!rle_uncompress(payload, size, bufs.inflated.data(), raw_size))
      return 5;
    unpredict_deinterleave(bufs.inflated.data(), raw_size, bufs.raw.data(),
                           bufs.scratch.data());
    *src = bufs.raw.data();
    return 0;
  }
  if (compression == 4) {  // PIZ
    if (!piz_uncompress(bufs.piz, payload, size, n_file_channels, ch_ptypes,
                        cw, nrows, bufs.raw.data()))
      return 6;
    *src = bufs.raw.data();
    return 0;
  }
  if (compression == 5) {  // PXR24
    if (!pxr24_uncompress(payload, size, n_file_channels, ch_ptypes, cw,
                          nrows, bufs.inflated, bufs.raw.data()))
      return 7;
    *src = bufs.raw.data();
    return 0;
  }
  if (compression == 6 || compression == 7) {  // B44 / B44A
    if (!b44_uncompress(payload, size, n_file_channels, ch_ptypes, cw, nrows,
                        bufs.raw.data()))
      return 8;
    *src = bufs.raw.data();
    return 0;
  }
  if (compression == 8 || compression == 9) {  // DWAA / DWAB
    if (!dwa_uncompress(bufs.piz, payload, size, n_file_channels, ch_ptypes,
                        names, dwa_to_linear, cw, nrows, bufs.raw.data()))
      return 9;
    *src = bufs.raw.data();
    return 0;
  }
  // ZIPS / ZIP
  uLongf dest_len = raw_size;
  int rc = uncompress(bufs.inflated.data(), &dest_len, payload,
                      static_cast<uLong>(size));
  if (rc != Z_OK || dest_len != raw_size) return 4;
  unpredict_deinterleave(bufs.inflated.data(), raw_size, bufs.raw.data(),
                         bufs.scratch.data());
  *src = bufs.raw.data();
  return 0;
}

// Scatter decoded scanline-interleaved raw bytes (cw pixels per row) into
// the (img_height, img_width, out_channels) float output at (row0, x0).
void scatter_rows(const uint8_t* src, int cw, int nrows, int x0, int row0,
                  int img_width, int n_file_channels,
                  const int32_t* ch_ptypes, const int32_t* ch_out,
                  int out_channels, float* out) {
  const uint8_t* p = src;
  for (int r = 0; r < nrows; ++r) {
    float* out_row =
        out +
        (static_cast<size_t>(row0 + r) * img_width + x0) * out_channels;
    for (int c = 0; c < n_file_channels; ++c) {
      int ptype = ch_ptypes[c];
      int oc = ch_out[c];
      if (oc < 0) {
        p += static_cast<size_t>(cw) * itemsize(ptype);
        continue;
      }
      float* dst = out_row + oc;
      if (ptype == 1) {
        const uint16_t* hp = reinterpret_cast<const uint16_t*>(p);
        for (int x = 0; x < cw; ++x) {
          uint16_t h;
          std::memcpy(&h, hp + x, 2);
          dst[static_cast<size_t>(x) * out_channels] = g_half_table[h];
        }
        p += static_cast<size_t>(cw) * 2;
      } else if (ptype == 2) {
        for (int x = 0; x < cw; ++x) {
          float f;
          std::memcpy(&f, p + 4 * static_cast<size_t>(x), 4);
          dst[static_cast<size_t>(x) * out_channels] = f;
        }
        p += static_cast<size_t>(cw) * 4;
      } else {  // UINT
        for (int x = 0; x < cw; ++x) {
          uint32_t u;
          std::memcpy(&u, p + 4 * static_cast<size_t>(x), 4);
          dst[static_cast<size_t>(x) * out_channels] = static_cast<float>(u);
        }
        p += static_cast<size_t>(cw) * 4;
      }
    }
  }
}

void decode_worker(DecodeJob job) {
  size_t bytes_per_pixel = 0;
  for (int c = 0; c < job.n_file_channels; ++c)
    bytes_per_pixel += itemsize(job.ch_ptypes[c]);
  DecodeBuffers bufs;

  for (;;) {
    int ci = job.next->fetch_add(1);
    if (ci >= static_cast<int>(job.chunks->size())) return;
    if (job.err->load(std::memory_order_relaxed)) return;
    const ChunkInfo& ch = (*job.chunks)[ci];
    int row0 = ch.y - job.ymin;
    if (row0 < 0 || row0 >= job.height) {
      job.err->store(2);
      return;
    }
    int nrows = job.lines_per_chunk;
    if (row0 + nrows > job.height) nrows = job.height - row0;
    size_t raw_size = static_cast<size_t>(nrows) * job.width * bytes_per_pixel;

    const uint8_t* src;
    int rc = decompress_payload(bufs, ch.payload, ch.size, job.compression,
                                job.n_file_channels, job.ch_ptypes,
                                *job.ch_names, job.dwa_to_linear, job.width,
                                nrows, raw_size, &src);
    if (rc) {
      job.err->store(rc);
      return;
    }
    scatter_rows(src, job.width, nrows, 0, row0, job.width,
                 job.n_file_channels, job.ch_ptypes, job.ch_out,
                 job.out_channels, job.out);
  }
}

struct TileInfo {
  int x0, y0, tw, th;
  const uint8_t* payload;
  size_t size;
};

struct TileJob {
  const std::vector<TileInfo>* tiles;
  int compression;
  int width;   // full image
  int n_file_channels;
  const int32_t* ch_ptypes;
  const int32_t* ch_out;
  int out_channels;
  float* out;
  const std::vector<std::string>* ch_names;
  const uint16_t* dwa_to_linear;
  std::atomic<int>* next;
  std::atomic<int>* err;
};

void tile_worker(TileJob job) {
  size_t bytes_per_pixel = 0;
  for (int c = 0; c < job.n_file_channels; ++c)
    bytes_per_pixel += itemsize(job.ch_ptypes[c]);
  DecodeBuffers bufs;

  for (;;) {
    int ti = job.next->fetch_add(1);
    if (ti >= static_cast<int>(job.tiles->size())) return;
    if (job.err->load(std::memory_order_relaxed)) return;
    const TileInfo& t = (*job.tiles)[ti];
    size_t raw_size = static_cast<size_t>(t.th) * t.tw * bytes_per_pixel;

    const uint8_t* src;
    int rc = decompress_payload(bufs, t.payload, t.size, job.compression,
                                job.n_file_channels, job.ch_ptypes,
                                *job.ch_names, job.dwa_to_linear, t.tw, t.th,
                                raw_size, &src);
    if (rc) {
      job.err->store(rc);
      return;
    }
    scatter_rows(src, t.tw, t.th, t.x0, t.y0, job.width, job.n_file_channels,
                 job.ch_ptypes, job.ch_out, job.out_channels, job.out);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; 1 bad chunk framing, 2 bad y, 3 short raw chunk,
// 4 zlib failure, 5 corrupt RLE, 6 corrupt PIZ, 7 corrupt PXR24,
// 8 corrupt B44, 9 corrupt DWA, 10 missing DWA inputs.
// ch_names: the file-order channel names, NUL-separated (DWA classifies
// channels by name). dwa_to_linear: the 65536-entry toLinear half-bit
// table, passed from Python so both decoders index the same table; may be
// NULL for non-DWA compressions.
int exr_decode_chunks(const uint8_t* data, long long data_size, long long pos,
                      int n_chunks, int lines_per_chunk, int compression,
                      int width, int height, int ymin, int n_file_channels,
                      const int32_t* ch_ptypes, const int32_t* ch_out,
                      int out_channels, float* out, int n_threads,
                      const char* ch_names, const uint16_t* dwa_to_linear) {
  ensure_half_table();

  std::vector<std::string> names;
  if (compression == 8 || compression == 9) {
    if (ch_names == nullptr || dwa_to_linear == nullptr) return 10;
    const char* p_name = ch_names;
    for (int i = 0; i < n_file_channels; ++i) {
      names.emplace_back(p_name);
      p_name += names.back().size() + 1;
    }
  }

  // sequential scan of the chunk framing (y:int32, size:int32, payload)
  std::vector<ChunkInfo> chunks;
  chunks.reserve(n_chunks);
  long long p = pos;
  for (int i = 0; i < n_chunks; ++i) {
    if (p + 8 > data_size) return 1;
    int32_t y, size;
    std::memcpy(&y, data + p, 4);
    std::memcpy(&size, data + p + 4, 4);
    p += 8;
    if (size < 0 || p + size > data_size) return 1;
    chunks.push_back({y, data + p, static_cast<size_t>(size)});
    p += size;
  }

  std::atomic<int> next{0}, err{0};
  DecodeJob job{&chunks,  lines_per_chunk, compression, width,
                height,   ymin,            n_file_channels,
                ch_ptypes, ch_out,         out_channels, out,
                &names,   dwa_to_linear,   &next,        &err};

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int nt = n_threads > 0 ? n_threads : hw;
  if (nt > n_chunks) nt = n_chunks;
  if (nt <= 1) {
    decode_worker(job);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(decode_worker, job);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

// Tiled single-part images (version bit 0x200). `offsets` are the file
// offsets of ALL tile chunks (every level, as listed in the offset
// table); each tile chunk is (dx, dy, lx, ly, size:int32, payload) and
// non-level-0 tiles are skipped (redundant with the full-resolution
// plane). Same error codes as exr_decode_chunks.
int exr_decode_tiles(const uint8_t* data, long long data_size,
                     const long long* offsets, int n_offsets, int txs,
                     int tys, int compression, int width, int height,
                     int n_file_channels, const int32_t* ch_ptypes,
                     const int32_t* ch_out, int out_channels, float* out,
                     int n_threads, const char* ch_names,
                     const uint16_t* dwa_to_linear) {
  ensure_half_table();
  if (txs <= 0 || tys <= 0) return 1;

  std::vector<std::string> names;
  if (compression == 8 || compression == 9) {
    if (ch_names == nullptr || dwa_to_linear == nullptr) return 10;
    const char* p_name = ch_names;
    for (int i = 0; i < n_file_channels; ++i) {
      names.emplace_back(p_name);
      p_name += names.back().size() + 1;
    }
  }

  std::vector<TileInfo> tiles;
  tiles.reserve(n_offsets);
  for (int i = 0; i < n_offsets; ++i) {
    long long off = offsets[i];
    if (off < 0 || off + 20 > data_size) return 1;
    int32_t dx, dy, lx, ly, size;
    std::memcpy(&dx, data + off, 4);
    std::memcpy(&dy, data + off + 4, 4);
    std::memcpy(&lx, data + off + 8, 4);
    std::memcpy(&ly, data + off + 12, 4);
    std::memcpy(&size, data + off + 16, 4);
    if (size < 0 || off + 20 + size > data_size) return 1;
    if (lx || ly) continue;  // lower mip level
    long long x0 = static_cast<long long>(dx) * txs;
    long long y0 = static_cast<long long>(dy) * tys;
    if (dx < 0 || dy < 0 || x0 >= width || y0 >= height) return 2;
    int tw = txs, th = tys;
    if (x0 + tw > width) tw = static_cast<int>(width - x0);
    if (y0 + th > height) th = static_cast<int>(height - y0);
    tiles.push_back({static_cast<int>(x0), static_cast<int>(y0), tw, th,
                     data + off + 20, static_cast<size_t>(size)});
  }

  std::atomic<int> next{0}, err{0};
  TileJob job{&tiles,        compression, width,
              n_file_channels, ch_ptypes, ch_out,
              out_channels,  out,         &names,
              dwa_to_linear, &next,       &err};

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int nt = n_threads > 0 ? n_threads : hw;
  if (nt > static_cast<int>(tiles.size())) nt = static_cast<int>(tiles.size());
  if (nt <= 1) {
    tile_worker(job);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(tile_worker, job);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

}  // extern "C"
