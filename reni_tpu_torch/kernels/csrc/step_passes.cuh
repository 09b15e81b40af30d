// Layer-major train step and backward for Hopper (sm_90a): the bf16 trunk
// of the Cond-by-Concat and FiLM train steps, and of their backward given an
// output cotangent, as a short sequence of passes, each a kernel that
// streams 128-row tiles of one layer's input through that layer's weights
// with wgmma and fuses the layer's epilogue. siren_step.cu instantiates the
// Cond-by-Concat passes, film_step.cu the FiLM ones.
//
// Replaces, with the chain kernels of siren_step.cuh and siren_bwd.cuh for
// the float32 trunk and for bf16 widths that are not a multiple of 64, the
// Pallas kernels _step_kernel and _film_step_kernel (the train steps) and
// _bwd_kernel and _film_bwd_kernel (the backward) of
// reni_tpu/kernels/siren_pallas.py. What a step computes is written down in
// siren_step.cuh and what a backward computes in siren_bwd.cuh; the passes
// compute the same with the same bf16 rounding points.
//
// What bounds it on the H100. The chain kernel keeps every layer of a
// 16-row tile in shared memory and pulls every weight from L2 for each tile;
// that fragment traffic, not the 1.6 ms of tensor-core work, bound it. Here
// activations go through device memory one layer at a time, so a tile is
// 128 rows and a CTA keeps one layer's weights resident in shared memory
// (H x H bf16, 128 KB at H = 256) for all the tiles it walks. The step is
// then bound by the bytes of its scratch: about 23 KB per row at 5 x 256.
//
// The passes, with n_mm H x H products (Cond-by-Concat L, FiLM T - 1):
//   fwd_pass j (j = 0..n_mm-2): h_j (j = 0: layer 0 from d, K = 8, FMA, also
//     written to sc_h[0]) -> h_j W_j -> bias, sine -> h_{j+1} to sc_h[j+1]
//     and the kept value of layer j+1 to sc_keep[j] (Cond-by-Concat the cos
//     factor c, FiLM the pre-modulation value pre, both float32);
//   last_pass (j = n_mm-1): the last product, then on the tile's full rows
//     the final layer (N = 8), the output activation, the loss partials and
//     g, the dWf and dbf partials, dh = g Wf^T and the last layer's backward
//     epilogue from the kept value in registers (never stored): dz to
//     sc_dz[n_mm-1] and its bias (FiLM: modulation) sums;
//   bwd_pass j (j = n_mm-1..0): dz_j -> dz_j W_j^T = dh_j -> layer j's
//     backward epilogue from sc_keep[j-1] (j = 0: the kept value is formed
//     again from d): dz to sc_dz[j-1], or for j = 0 the per-image dA.
// Then dWs = h^T dz over sc_h / sc_dz by wgrad_bf16 (a wgmma split-K GEMM
// on MN-major K-slabs of the scratch) and the slot sums by reduce_slots
// (siren_chain.cuh), as for the chain kernel.
//
// The backward (gin set) runs the same passes with the cotangent last pass
// (last_pass<..., LAST_COT>): it reads the tile's output cotangent g from
// device memory in place of targets, pixel weights and the loss, and skips
// the final layer. Without weight gradients (wgrad = 0) no pass stores h_0,
// the dbs / dWf / dbf sums or any weight slot, and dWs is not formed: what
// is left are the per-image sums (dA, db0; FiLM dA0, dfreqs, dphases).
// A differentiable forward (out set) runs the fwd passes and the output
// last pass (LAST_OUT: the last product, activation and final layer to out)
// and hands its scratch to the backward, which then runs the cotangent last
// pass and the bwd passes only: the forward is not computed twice.
//
// Design:
//   - grid (chunks, images), one CTA per chunk of consecutive 128-row tiles
//     of one image, 256 threads: two warpgroups of 64 rows. A tile never
//     straddles two images; rows past P are zero-filled on load and not
//     stored, so they add exact zeros.
//   - operands in shared memory as wgmma expects them: K-major, 128-byte
//     swizzle, [H / 64][rows][64] bf16. The forward's B operand is W_j^T
//     (the wrapper passes a contiguous transposed copy), the backward's is
//     W_j as stored. Weights and tiles come in with cp.async.
//   - every H x H product is wgmma m64n64k16 (bf16 operands, float32
//     accumulators), H / 64 column blocks of one warpgroup held at once, so
//     the epilogue sees full 256-wide rows in registers (128 a thread).
//   - one CTA per SM (226 KB of shared memory at H = 256) hides latency by
//     overlap inside the CTA: once a tile's product is done, the next tile's
//     input streams in with cp.async under the epilogue; the backward loads
//     its kept values a 64-column block at a time, 16 loads in flight a
//     thread; the first layer's operands sit in shared memory rounded to
//     bf16 once.
//   - no float atomics: column sums (bias and modulation sums) stay in
//     registers across a CTA's tiles (a butterfly over each warp's row
//     groups, ColSums) and are added over the warps in order at the end;
//     per-CTA sums go to per-CTA slots. Two calls on the same inputs give
//     the same bits.
// Limits: H a multiple of 64 and one layer's weights plus a tile in shared
// memory (pass_layout; H <= 256); any depth. The device scratch (sc_h, sc_dz,
// sc_keep: about 9 KB per row at 5 x 256) is the caller's: over its
// device-memory budget, kernels/siren_step.py runs the images in groups, each
// group its full pass sequence into its own rows of the per-CTA slots.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_step.cuh"
#include "wgmma.cuh"

namespace reni_pass {

using namespace reni;
using namespace reni_wg;
using bf16 = __nv_bfloat16;

constexpr int PTHREADS = 256;  // two warpgroups
constexpr int PWARPS = PTHREADS / 32;

struct PassArgs {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias; unused by FiLM
  const bf16* ws;       // (n_mm, H, H) hidden weights: the backward's B operand
  const bf16* wst;      // (n_mm, H, H) their transposes: the forward's B operand
  const float* bs;      // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const bf16* wf;       // (H, C_PAD) final weight
  const float* bf;      // (C_PAD,)
  const float* fr;      // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;      // FiLM (B, (n_mm + 1) * H) phase shifts
  const float* tgt;     // (B, P, C_PAD) targets
  const float* sw;      // (P, C_PAD) pixel weights
  const float* bm;      // (B, C_PAD) batch mask
  const float* gin;     // (B, P, C_PAD) output cotangent of a backward; null for a step
  float* out;           // (B, P, C_PAD) the trunk's output of a forward; null otherwise
  float* part_img;      // (B, n_chunks, n_img) per-image partial sums
  float* part_w;        // (B * n_chunks, n_w) loss and small weight sums
  bf16* sc_h;           // (n_mm, B * P, H) inputs h_j of the products
  float* sc_keep;       // (n_mm - 1, B * P, H) kept values of layers 1..n_mm-1
  bf16* sc_dz;          // (n_mm, B * P, H) cotangents dz_j of the products' outputs
  int P, H, n_mm, tiles_per_cta, n_chunks, act;
  int wgrad;            // 1: weight gradients (a step always); 0: per-image sums only
  float omega0, omega_h, gscale2;
  int j;                // the product this pass runs
};

// Shared memory of one CTA of any pass (byte offsets from a 1024-aligned
// base). kernels/siren_step.py mirrors it in pass_smem_bytes.
struct PassLayout {
  size_t w, a, red, vec, dtile, aux, gtile, sums, total;
};

__host__ __device__ inline PassLayout pass_layout(int H) {
  PassLayout L;
  size_t off = 0;
  L.w = off;      // one layer's weights, (H / 64, H, 64) bf16, swizzled
  off += (size_t)H * H * 2;
  L.a = off;      // the input tile, (H / 64, TILE, 64) bf16, swizzled
  off += (size_t)TILE * H * 2;
  L.red = off;    // per-warp column sums (PWARPS, H), or a tile's g (TILE, C_PAD), float32
  off += align128((size_t)(PWARPS * H > TILE * C_PAD ? PWARPS * H : TILE * C_PAD) * 4);
  L.vec = off;    // per-column vectors of the layer: bias, frequency, phase
  off += align128((size_t)4 * H * 4);
  L.dtile = off;  // directions of the tile, (TILE, K_PAD) float32
  off += align128((size_t)TILE * K_PAD * 4);
  L.aux = off;    // the final weight (H, C_PAD) or the first-layer weight (K_PAD, H), float32
  off += align128((size_t)K_PAD * H * 4);
  L.gtile = off;  // output cotangent of the tile, (TILE, C_PAD) float32
  off += align128((size_t)TILE * C_PAD * 4);
  L.sums = off;   // the CTA's loss and dbf partials
  off += align128((size_t)2 * C_PAD * 4);
  L.total = off + 1024;  // slack to align the base to the swizzle atom
  return L;
}

// ---------------------------------------------------------------------------
// loads of the passes
// ---------------------------------------------------------------------------

// `rows` rows of a row-major bf16 matrix (pitch H) into a swizzled tile;
// rows at or past `valid` are zero-filled
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows, int valid, int H) {
  const int per_row = H / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += PTHREADS) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    const bool in = r < valid;
    cp_async16(dst + swz(r, c, rows), src + (size_t)(in ? r : 0) * H + c, in);
  }
}

__device__ __forceinline__ void load_floats(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += PTHREADS * 4) cp_async16(dst + i, src + i, true);
}

// 8 floats from 32-byte-aligned shared memory
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 x = reinterpret_cast<const float4*>(p)[0], y = reinterpret_cast<const float4*>(p)[1];
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// Column sums over the rows of every tile a CTA walks, kept in registers
// across its tiles: a thread adds its two rows of a column, a butterfly adds
// a warp's eight row groups, and lane group g = lane / 4 keeps the columns
// of its list whose index is g mod 8 (8 values a thread at H = 256).
// flush_cols adds the eight warps in order at the end. Every sum has a fixed
// order, so two calls give the same bits.
struct ColSums {
  float v[NCH * 16 / 8];
};

// s (this thread's two rows of its column idx, idx = nc * 16 + n-block * 2 + e)
__device__ __forceinline__ void col_add(ColSums& cs, int idx, float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  if ((idx & 7) == (int)(threadIdx.x % 32) / 4) cs.v[idx >> 3] += s;
}

// dst[c] = the CTA's sum of column c < H (device memory: the CTA's slot)
__device__ __forceinline__ void flush_cols(const ColSums& cs, int H, float* red, float* dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nch = H / 64;
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc) {
    if (nc >= nch) continue;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int idx = nc * 16 + q;
      if ((idx & 7) == lane / 4)
        red[warp * H + nc * 64 + (q >> 1) * 8 + (lane % 4) * 2 + (q & 1)] = cs.v[idx >> 3];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += PTHREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < PWARPS; ++w) s += red[w * H + c];
    dst[c] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the passes
// ---------------------------------------------------------------------------

struct Tile {
  int p0, valid;
  size_t row0;
};

__device__ __forceinline__ bool next_tile(const PassArgs& g, int i, Tile* t) {
  t->p0 = (cta_item(g.n_chunks) * g.tiles_per_cta + i) * TILE;
  if (i >= g.tiles_per_cta || t->p0 >= g.P) return false;
  t->valid = min(TILE, g.P - t->p0);
  t->row0 = (size_t)cta_image(g.n_chunks) * g.P + t->p0;
  return true;
}

// wait for this thread's copies and make the tile visible to wgmma and to
// every thread
__device__ __forceinline__ void tile_ready() {
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
}

// the directions of a tile rounded to bf16 (every use takes them so), zero
// past `valid`
__device__ __forceinline__ void load_dtile(const PassArgs& g, float* dt, const Tile& t) {
  const float* d = g.d + cta_image(g.n_chunks) * g.d_bstride;
  for (int i = threadIdx.x; i < TILE * K_PAD; i += PTHREADS) {
    const int r = i / K_PAD;
    dt[i] = r < t.valid ? rnd<true>(d[(size_t)(t.p0 + r) * K_PAD + i % K_PAD]) : 0.0f;
  }
}

// this image's first-layer weight (K_PAD, H) rounded to bf16, into shared memory
__device__ __forceinline__ void load_a(const PassArgs& g, float* as) {
  const float* a = g.a + (size_t)cta_image(g.n_chunks) * K_PAD * g.H;
  for (int i = threadIdx.x; i < K_PAD * g.H; i += PTHREADS) as[i] = rnd<true>(a[i]);
}

// layer 0 before its activation at column c: d a_b (K = 8, FMA) plus the
// bias (Cond-by-Concat b0_b, FiLM bs_0); `d` the row's 8 direction features
// and `a` (K_PAD, H), both rounded to bf16
__device__ __forceinline__ float layer0(const float* d, const float* a, float bias, int H, int c) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < K_PAD; ++k) acc = fmaf(d[k], a[k * H + c], acc);
  return acc + bias;
}

// h_0 of the tile into the swizzled input tile and, for rows < valid and
// with weight gradients (only dWs reads it), into sc_h[0]; a thread per
// column (conflict-free reads of `a`); `a` (K_PAD, H) rounded to bf16 unless
// ROUND_A
template <bool FILM, int SN, bool ROUND_A>
__device__ void prologue(const PassArgs& g, const float* dt, const float* a, bf16* at,
                         const Tile& t) {
  const int H = g.H, b = cta_image(g.n_chunks);
  const float* fr = FILM ? g.fr + (size_t)b * (g.n_mm + 1) * H : nullptr;
  const float* ph = FILM ? g.ph + (size_t)b * (g.n_mm + 1) * H : nullptr;
  for (int c = threadIdx.x; c < H; c += PTHREADS) {
    const float bias = FILM ? __ldg(g.bs + c) : __ldg(g.b0 + (size_t)b * H + c);
    const float f = FILM ? __ldg(fr + c) : 0.0f, p = FILM ? __ldg(ph + c) : 0.0f;
    float ac[K_PAD];
#pragma unroll
    for (int k = 0; k < K_PAD; ++k) ac[k] = ROUND_A ? rnd<true>(__ldg(a + k * H + c)) : a[k * H + c];
    for (int r = 0; r < TILE; ++r) {
      float d[K_PAD];
      load8(dt + r * K_PAD, d);
      float x = 0.0f;
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) x = fmaf(d[k], ac[k], x);
      x += bias;
      const float s = FILM ? sine<SN>(__fadd_rn(__fmul_rn(f, x), p)) : sine<SN>(g.omega0 * x);
      const bf16 v = __float2bfloat16_rn(s);
      at[swz(r, c, TILE)] = v;
      if (g.wgrad && r < t.valid) g.sc_h[(t.row0 + r) * H + c] = v;
    }
  }
}

// the product's input tile: layer 0 from d (j = 0; `a` as for prologue) or h_j
// from sc_h[j] (copies in flight: tile_ready() completes it)
template <bool FILM, int SN, bool ROUND_A>
__device__ __forceinline__ void fill_input(const PassArgs& g, float* dt, const float* a, bf16* at,
                                           const Tile& t, size_t rows) {
  if (g.j == 0) {
    load_dtile(g, dt, t);
    __syncthreads();
    prologue<FILM, SN, ROUND_A>(g, dt, a, at, t);
  } else {
    load_rows(at, g.sc_h + ((size_t)g.j * rows + t.row0) * g.H, TILE, t.valid, g.H);
  }
}

// the per-layer vectors of the layer after product j: Cond-by-Concat bs_j;
// FiLM bs_{j+1}, f_{j+1}, p_{j+1} of this image
template <bool FILM>
__device__ __forceinline__ void load_layer_vectors(const PassArgs& g, float* vec, int layer) {
  const int H = g.H;
  if constexpr (FILM) {
    const size_t img = (size_t)cta_image(g.n_chunks) * (g.n_mm + 1) * H + (size_t)layer * H;
    load_floats(vec, g.bs + (size_t)layer * H, H);
    load_floats(vec + H, g.fr + img, H);
    load_floats(vec + 2 * H, g.ph + img, H);
  } else {
    load_floats(vec, g.bs + (size_t)(layer - 1) * H, H);
  }
}

template <bool FILM, int SN>
__global__ void __launch_bounds__(PTHREADS, 1) fwd_pass(PassArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int H = g.H, j = g.j, nch = H / 64;
  const PassLayout lay = pass_layout(H);
  bf16* w = reinterpret_cast<bf16*>(smem + lay.w);
  bf16* at = reinterpret_cast<bf16*>(smem + lay.a);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  float* dt = reinterpret_cast<float*>(smem + lay.dtile);
  float* as = reinterpret_cast<float*>(smem + lay.aux);  // (K_PAD, H) for j = 0
  const size_t rows = (size_t)cta_images(g.n_chunks) * g.P;
  bf16* h_out = g.sc_h + (size_t)(j + 1) * rows * H;
  float* keep_out = g.sc_keep + (size_t)j * rows * H;

  load_rows(w, g.wst + (size_t)j * H * H, H, H, H);
  load_layer_vectors<FILM>(g, vec, j + 1);
  if (j == 0) load_a(g, as);
  cp_async_wait_all();
  __syncthreads();

  float acc[NCH][32] = {};
  Tile t, tn;
  bool have = next_tile(g, 0, &t);
  if (have) {
    fill_input<FILM, SN, false>(g, dt, as, at, t, rows);
    tile_ready();
  }
  for (int it = 0; have; ++it) {
    mma_tile(acc, at, w, H);
    __syncthreads();  // the input tile is free: the next one streams in under the epilogue
    const bool more = next_tile(g, it + 1, &tn);
    if (more && j > 0) fill_input<FILM, SN, false>(g, dt, as, at, tn, rows);
#pragma unroll
    for (int nc = 0; nc < NCH; ++nc) {
      if (nc >= nch) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = acc_row(i), c = acc_col(nc, i);
        if (r >= t.valid) continue;
        float s[2], kept[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (FILM) {
            kept[e] = acc[nc][i + e] + vec[c + e];
            s[e] = sine<SN>(__fadd_rn(__fmul_rn(vec[H + c + e], kept[e]), vec[2 * H + c + e]));
          } else {
            sine_cosine<SN>(g.omega_h * (acc[nc][i + e] + vec[c + e]), &s[e], &kept[e]);
          }
        }
        const size_t o = (t.row0 + r) * H + c;
        *reinterpret_cast<__nv_bfloat162*>(h_out + o) = __floats2bfloat162_rn(s[0], s[1]);
        *reinterpret_cast<float2*>(keep_out + o) = make_float2(kept[0], kept[1]);
      }
    }
    if (more) {
      if (j == 0) fill_input<FILM, SN, false>(g, dt, as, at, tn, rows);
      tile_ready();
    }
    t = tn;
    have = more;
  }
}

// the output activation and its derivative
__device__ __forceinline__ float activate(int act, float o, float* dact) {
  if (act == 1) {
    const float out = tanhf(o);
    *dact = __fsub_rn(1.0f, __fmul_rn(out, out));
    return out;
  }
  if (act == 2) {
    const float out = expf(o);
    *dact = out;
    return out;
  }
  *dact = 1.0f;
  return o;
}

// the output cotangent of a tile (TILE, C_PAD) float32 into `dst`, rows at
// or past `valid` zero-filled (copies in flight: tile_ready() completes it)
__device__ __forceinline__ void load_gtile(const PassArgs& g, float* dst, const Tile& t) {
  for (int i = threadIdx.x * 4; i < TILE * C_PAD; i += PTHREADS * 4) {
    const int r = i / C_PAD;
    const bool in = r < t.valid;
    cp_async16(dst + i, g.gin + (t.row0 + (in ? r : 0)) * C_PAD + i % C_PAD, in);
  }
}

enum { LAST_STEP = 0, LAST_COT = 1, LAST_OUT = 2 };

// The last pass. LAST_STEP: the last product and activation, the final
// layer, the loss and g. LAST_COT (a backward): the last product and
// activation, g read from gin; no final layer and no loss. Then in both:
// dWf and dbf (with weight gradients), dh = g Wf^T and the last layer's
// backward epilogue. LAST_OUT (a forward): the last product, activation and
// final layer, the output to out, nothing else.
template <bool FILM, int SN, int MODE>
__global__ void __launch_bounds__(PTHREADS, 1) last_pass(PassArgs g) {
  constexpr bool COT = MODE == LAST_COT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int H = g.H, j = g.j, nch = H / 64, b = cta_image(g.n_chunks), tid = threadIdx.x;
  const bool wgrad = g.wgrad != 0;
  const PassLayout lay = pass_layout(H);
  bf16* w = reinterpret_cast<bf16*>(smem + lay.w);
  bf16* at = reinterpret_cast<bf16*>(smem + lay.a);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  float* dt = reinterpret_cast<float*>(smem + lay.dtile);
  float* wf = reinterpret_cast<float*>(smem + lay.aux);  // (H, C_PAD)
  float* gt = reinterpret_cast<float*>(smem + lay.gtile);  // g rounded to bf16
  float* sums = reinterpret_cast<float*>(smem + lay.sums);
  float* mse_acc = sums;
  float* dbf_acc = sums + C_PAD;
  float* lt = dt;   // loss terms of the tile (the directions are used up by then)
  float* gf = red;  // g of the tile in float32
  const size_t rows = (size_t)cta_images(g.n_chunks) * g.P;
  bf16* dz_out = g.sc_dz + (size_t)j * rows * H;
  const float* bm = MODE == LAST_STEP ? g.bm + (size_t)b * C_PAD : nullptr;

  load_rows(w, g.wst + (size_t)j * H * H, H, H, H);
  load_layer_vectors<FILM>(g, vec, j + 1);
  for (int i = tid; i < H * C_PAD; i += PTHREADS) wf[i] = __bfloat162float(g.wf[i]);
  if (tid < 2 * C_PAD) sums[tid] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  float dwf[C_PAD] = {};  // dWf row m = tid (tid < H) of this CTA
  ColSums cs[FILM ? 3 : 1] = {};
  float acc[NCH][32] = {};
  Tile t;
  for (int it = 0; next_tile(g, it, &t); ++it) {
    if constexpr (COT) load_gtile(g, gf, t);
    fill_input<FILM, SN, true>(g, dt, g.a + (size_t)b * K_PAD * H, at, t, rows);
    tile_ready();
    mma_tile(acc, at, w, H);
    __syncthreads();  // the last activation overwrites the input tile
    // the last activation to the tile (bf16, as the final layer takes it);
    // acc keeps omega_h c (Cond-by-Concat) or pre (FiLM)
#pragma unroll
    for (int nc = 0; nc < NCH; ++nc) {
      if (nc >= nch) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_row(i), c = acc_col(nc, i);
        float s;
        if constexpr (FILM) {
          const float pre = acc[nc][i] + vec[c];
          s = sine<SN>(__fadd_rn(__fmul_rn(vec[H + c], pre), vec[2 * H + c]));
          acc[nc][i] = pre;
        } else {
          float cs_;
          sine_cosine<SN>(g.omega_h * (acc[nc][i] + vec[c]), &s, &cs_);
          acc[nc][i] = __fmul_rn(g.omega_h, cs_);
        }
        at[swz(r, c, TILE)] = __float2bfloat16_rn(s);
      }
    }
    __syncthreads();
    if constexpr (COT) {
      // the tile's g, read with the input: rounded to bf16 for the products
      for (int i = tid; i < TILE * C_PAD; i += PTHREADS) gt[i] = rnd<true>(gf[i]);
    } else {
      // final layer, activation, loss terms and the output cotangent: a pair
      // of threads per row, each over half of K, then each over 4 lanes
      const int r = tid / 2, half = tid % 2, kh = H / 2;
      float o[C_PAD] = {};
      for (int k0 = half * kh; k0 < (half + 1) * kh; k0 += 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(at + swz(r, k0, TILE));
        const bf16* hv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float wv[C_PAD];
          load8(wf + (k0 + e) * C_PAD, wv);
          const float h = get(hv[e]);
#pragma unroll
          for (int c = 0; c < C_PAD; ++c) o[c] = fmaf(h, wv[c], o[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C_PAD; ++c) o[c] += __shfl_xor_sync(0xffffffffu, o[c], 1);
#pragma unroll
      for (int q = 0; q < C_PAD / 2; ++q) {
        const int c = half * (C_PAD / 2) + q;
        if constexpr (MODE == LAST_OUT) {
          if (r < t.valid) g.out[(t.row0 + r) * C_PAD + c] = o[c] + g.bf[c];
          continue;
        }
        float dact;
        const float out = activate(g.act, o[c] + g.bf[c], &dact);
        float gv = 0.0f, loss = 0.0f;
        if (r < t.valid) {
          const float res = __fsub_rn(out, g.tgt[(t.row0 + r) * C_PAD + c]);
          const float rs = __fmul_rn(res, __fmul_rn(g.sw[(size_t)(t.p0 + r) * C_PAD + c], bm[c]));
          loss = __fmul_rn(rs, res);
          gv = __fmul_rn(g.gscale2, rs);
          if (g.act != 0) gv = __fmul_rn(gv, dact);
        }
        lt[r * C_PAD + c] = loss;
        gf[r * C_PAD + c] = gv;
        gt[r * C_PAD + c] = rnd<true>(gv);
      }
    }
    __syncthreads();
    if constexpr (MODE == LAST_OUT) continue;  // the input tile is refilled first thing
    if (wgrad) {
      // mse (the step only) and dbf partials, rows in order
      if (tid < 2 * C_PAD && (!COT || tid >= C_PAD)) {
        const float* src = tid < C_PAD ? lt : gf;
        const int c = tid % C_PAD;
        float s = 0.0f;
        for (int r = 0; r < TILE; ++r) s += src[r * C_PAD + c];
        sums[tid] += s;
      }
      if (tid < H) {  // dWf row tid: h_last^T g over the tile
        float s[C_PAD] = {};
        for (int r = 0; r < TILE; ++r) {
          const float h = get(at[swz(r, tid, TILE)]);
          float gv[C_PAD];
          load8(gt + r * C_PAD, gv);
#pragma unroll
          for (int c = 0; c < C_PAD; ++c) s[c] = fmaf(h, gv[c], s[c]);
        }
#pragma unroll
        for (int c = 0; c < C_PAD; ++c) dwf[c] += s[c];
      }
    }
    // dh = g Wf^T and the last layer's backward epilogue, a quad (rows r,
    // r + 8; columns c, c + 1) at a time
#pragma unroll
    for (int nc = 0; nc < NCH; ++nc) {
      if (nc >= nch) continue;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const int r = acc_row(i), c = acc_col(nc, i), idx = nc * 16 + (i >> 2) * 2;
        float g0[C_PAD], g1[C_PAD], w0[C_PAD], w1[C_PAD];
        load8(gt + r * C_PAD, g0);
        load8(gt + (r + 8) * C_PAD, g1);
        load8(wf + c * C_PAD, w0);
        load8(wf + (c + 1) * C_PAD, w1);
        float dh[4] = {};  // (r, c), (r, c+1), (r+8, c), (r+8, c+1): the order of acc
#pragma unroll
        for (int k = 0; k < C_PAD; ++k) {
          dh[0] = fmaf(g0[k], w0[k], dh[0]);
          dh[1] = fmaf(g0[k], w1[k], dh[1]);
          dh[2] = fmaf(g1[k], w0[k], dh[2]);
          dh[3] = fmaf(g1[k], w1[k], dh[3]);
        }
        float dz[4];
        if constexpr (FILM) {
          float dm[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cc = c + (q & 1);
            const float pre = acc[nc][i + q], f = vec[H + cc];
            dm[q] = __fmul_rn(dh[q], cosine<SN>(__fadd_rn(__fmul_rn(f, pre), vec[2 * H + cc])));
            dz[q] = __fmul_rn(dm[q], f);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            col_add(cs[0], idx + e,
                    __fmul_rn(dm[e], acc[nc][i + e]) + __fmul_rn(dm[e + 2], acc[nc][i + e + 2]));
            col_add(cs[1], idx + e, dm[e] + dm[e + 2]);
            if (wgrad) col_add(cs[2], idx + e, dz[e] + dz[e + 2]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) dz[q] = __fmul_rn(dh[q], acc[nc][i + q]);
          if (wgrad) {
#pragma unroll
            for (int e = 0; e < 2; ++e) col_add(cs[0], idx + e, dz[e] + dz[e + 2]);
          }
        }
        if (r < t.valid)
          *reinterpret_cast<__nv_bfloat162*>(dz_out + (t.row0 + r) * H + c) =
              __floats2bfloat162_rn(dz[0], dz[1]);
        if (r + 8 < t.valid)
          *reinterpret_cast<__nv_bfloat162*>(dz_out + (t.row0 + r + 8) * H + c) =
              __floats2bfloat162_rn(dz[2], dz[3]);
      }
    }
    __syncthreads();  // the tile buffers are refilled next
  }

  if constexpr (MODE == LAST_OUT) return;
  const int n_mm = g.n_mm, n_w = reni_step::weight_values(FILM, H, n_mm);
  const int layer = FILM ? j + 1 : j;  // the bias row of the last layer's dz
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + cta_item(g.n_chunks)) * n_w;
  float* dwf_out = part_w + C_PAD + (size_t)reni_step::bias_rows(FILM, n_mm) * H;
  if (wgrad) {  // the backward's mse slot stays 0
    if (tid < H) {
#pragma unroll
      for (int c = 0; c < C_PAD; ++c) dwf_out[tid * C_PAD + c] = dwf[c];
    }
    if (tid < C_PAD) {
      part_w[tid] = mse_acc[tid];
      dwf_out[H * C_PAD + tid] = dbf_acc[tid];
    }
  }
  if constexpr (FILM) {
    const int T = n_mm + 1, n_img = reni_step::image_values(true, H, n_mm);
    float* part_img = g.part_img + ((size_t)b * g.n_chunks + cta_item(g.n_chunks)) * n_img;
    flush_cols(cs[0], H, red, part_img + (K_PAD + layer) * H);
    flush_cols(cs[1], H, red, part_img + (K_PAD + T + layer) * H);
    if (wgrad) flush_cols(cs[2], H, red, part_w + C_PAD + (size_t)layer * H);
  } else if (wgrad) {
    flush_cols(cs[0], H, red, part_w + C_PAD + (size_t)layer * H);
  }
}

template <bool FILM, int SN>
__global__ void __launch_bounds__(PTHREADS, 1) bwd_pass(PassArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int H = g.H, j = g.j, nch = H / 64, b = cta_image(g.n_chunks), tid = threadIdx.x;
  // the column sums of dz: dbs (weight gradients only) or, Cond-by-Concat at
  // j = 0, the per-image db0; FiLM's dfreqs and dphases sums always run
  const bool dz_sums = g.wgrad != 0 || (!FILM && j == 0);
  const PassLayout lay = pass_layout(H);
  bf16* w = reinterpret_cast<bf16*>(smem + lay.w);
  bf16* at = reinterpret_cast<bf16*>(smem + lay.a);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  float* dt = reinterpret_cast<float*>(smem + lay.dtile);
  float* as = reinterpret_cast<float*>(smem + lay.aux);  // (K_PAD, H) for j = 0
  const size_t rows = (size_t)cta_images(g.n_chunks) * g.P;
  const float* keep = j > 0 ? g.sc_keep + (size_t)(j - 1) * rows * H : nullptr;
  bf16* dz_out = j > 0 ? g.sc_dz + (size_t)(j - 1) * rows * H : nullptr;
  const bf16* dz_in = g.sc_dz + (size_t)j * rows * H;

  load_rows(w, g.ws + (size_t)j * H * H, H, H, H);
  // vec: FiLM f_j, p_j, and for j = 0 bs_0; Cond-by-Concat for j = 0 b0_b
  if constexpr (FILM) {
    const size_t img = (size_t)b * (g.n_mm + 1) * H + (size_t)j * H;
    load_floats(vec, g.fr + img, H);
    load_floats(vec + H, g.ph + img, H);
    if (j == 0) load_floats(vec + 2 * H, g.bs, H);
  } else if (j == 0) {
    load_floats(vec + 2 * H, g.b0 + (size_t)b * H, H);
  }
  if (j == 0) load_a(g, as);
  cp_async_wait_all();
  __syncthreads();

  float da[K_PAD] = {};  // dA column tid (tid < H) of this CTA, for j = 0
  ColSums cs[FILM ? 3 : 1] = {};
  float acc[NCH][32] = {};
  Tile t, tn;
  bool have = next_tile(g, 0, &t);
  if (have) {
    if (j == 0) load_dtile(g, dt, t);
    load_rows(at, dz_in + t.row0 * H, TILE, t.valid, H);
    tile_ready();
  }
  for (int it = 0; have; ++it) {
    mma_tile(acc, at, w, H);  // acc = dh_j
    __syncthreads();          // the input tile is free
    const bool more = next_tile(g, it + 1, &tn);
    if (more && j > 0) load_rows(at, dz_in + tn.row0 * H, TILE, tn.valid, H);
#pragma unroll
    for (int nc = 0; nc < NCH; ++nc) {
      if (nc >= nch) continue;
      // the kept values of layer j (Cond-by-Concat the cos factor, FiLM the
      // pre-modulation value) of this block: loaded all at once, or (j = 0)
      // formed again from d
      float kv[32];
      if (j > 0) {
        // all 16 loads of the block issued together; a row past `valid`
        // reads row 0 (its dh is 0, so any finite value adds nothing)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = acc_row(i), rr = r < t.valid ? r : 0;
          const float2 v =
              __ldg(reinterpret_cast<const float2*>(keep + (t.row0 + rr) * H + acc_col(nc, i)));
          kv[i] = v.x;
          kv[i + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = acc_row(i), c = acc_col(nc, i);
          float d[K_PAD];
          load8(dt + r * K_PAD, d);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = layer0(d, as, vec[2 * H + c + e], H, c + e);
            if constexpr (FILM) {
              kv[i + e] = x;
            } else {
              float s;
              sine_cosine<SN>(g.omega0 * x, &s, &kv[i + e]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const int r = acc_row(i), c = acc_col(nc, i), idx = nc * 16 + (i >> 2) * 2;
        float dz[4];
        if constexpr (FILM) {
          float dm[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cc = c + (q & 1);
            const float f = vec[cc];
            dm[q] = __fmul_rn(acc[nc][i + q],
                              cosine<SN>(__fadd_rn(__fmul_rn(f, kv[i + q]), vec[H + cc])));
            dz[q] = __fmul_rn(dm[q], f);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            col_add(cs[0], idx + e,
                    __fmul_rn(dm[e], kv[i + e]) + __fmul_rn(dm[e + 2], kv[i + e + 2]));
            col_add(cs[1], idx + e, dm[e] + dm[e + 2]);
            if (dz_sums) col_add(cs[2], idx + e, dz[e] + dz[e + 2]);
          }
        } else {
          const float om = j > 0 ? g.omega_h : g.omega0;
#pragma unroll
          for (int q = 0; q < 4; ++q) dz[q] = __fmul_rn(acc[nc][i + q], __fmul_rn(om, kv[i + q]));
          if (dz_sums) {
#pragma unroll
            for (int e = 0; e < 2; ++e) col_add(cs[0], idx + e, dz[e] + dz[e + 2]);
          }
        }
        const __nv_bfloat162 v0 = __floats2bfloat162_rn(dz[0], dz[1]);
        const __nv_bfloat162 v1 = __floats2bfloat162_rn(dz[2], dz[3]);
        if (j == 0) {  // dz0 to the tile, row-major, for dA
          *reinterpret_cast<__nv_bfloat162*>(at + r * H + c) = v0;
          *reinterpret_cast<__nv_bfloat162*>(at + (r + 8) * H + c) = v1;
        } else {
          if (r < t.valid) *reinterpret_cast<__nv_bfloat162*>(dz_out + (t.row0 + r) * H + c) = v0;
          if (r + 8 < t.valid)
            *reinterpret_cast<__nv_bfloat162*>(dz_out + (t.row0 + r + 8) * H + c) = v1;
        }
      }
    }
    if (j == 0) {
      __syncthreads();  // the dz0 tile is complete
      if (tid < H) {    // dA column tid: d^T dz0 over the tile
        float sa[K_PAD] = {};
        for (int r = 0; r < TILE; ++r) {
          const float q = get(at[r * H + tid]);
          float dv[K_PAD];
          load8(dt + r * K_PAD, dv);
#pragma unroll
          for (int k = 0; k < K_PAD; ++k) sa[k] = fmaf(dv[k], q, sa[k]);
        }
#pragma unroll
        for (int k = 0; k < K_PAD; ++k) da[k] += sa[k];
      }
      if (more) {
        __syncthreads();  // the tile and the directions are refilled
        load_dtile(g, dt, tn);
        load_rows(at, dz_in + tn.row0 * H, TILE, tn.valid, H);
      }
    }
    if (more) tile_ready();
    t = tn;
    have = more;
  }

  const int n_mm = g.n_mm, n_img = reni_step::image_values(FILM, H, n_mm);
  const int n_w = reni_step::weight_values(FILM, H, n_mm);
  float* part_img = g.part_img + ((size_t)b * g.n_chunks + cta_item(g.n_chunks)) * n_img;
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + cta_item(g.n_chunks)) * n_w;
  if constexpr (FILM) {
    const int T = n_mm + 1;
    flush_cols(cs[0], H, red, part_img + (K_PAD + j) * H);
    flush_cols(cs[1], H, red, part_img + (K_PAD + T + j) * H);
    if (dz_sums) flush_cols(cs[2], H, red, part_w + C_PAD + (size_t)j * H);
  } else if (dz_sums) {
    flush_cols(cs[0], H, red, j > 0 ? part_w + C_PAD + (size_t)(j - 1) * H : part_img + K_PAD * H);
  }
  if (j == 0 && tid < H)
#pragma unroll
    for (int k = 0; k < K_PAD; ++k) part_img[k * H + tid] = da[k];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using PassFn = void (*)(PassArgs);

// pass k of 2 n_mm with the sine mode SN: products 0..n_mm-2 forward,
// n_mm-1 the last pass (of the given mode), then the backward from product
// n_mm-1 down to 0
template <bool FILM, int SN>
PassFn pass_kernel(int k, int n_mm, int last, int* j) {
  if (k < n_mm - 1) {
    *j = k;
    return fwd_pass<FILM, SN>;
  }
  if (k == n_mm - 1) {
    *j = k;
    if (last == LAST_COT) return last_pass<FILM, SN, LAST_COT>;
    if (last == LAST_OUT) return last_pass<FILM, SN, LAST_OUT>;
    return last_pass<FILM, SN, LAST_STEP>;
  }
  *j = 2 * n_mm - 1 - k;
  return bwd_pass<FILM, SN>;
}

// what follows the passes, as flags: the per-image slot sums, the weight
// slot sums, dWs = h^T dz over this call's scratch (with its split-K sum)
enum { FINISH_IMG = 1, FINISH_W = 2, FINISH_DWS = 4 };

// Passes [lo, hi) of a step, of a backward (gin set) or of a forward (out
// set) with the sine mode SN on one stream, then what `finish` asks for.
// siren_step.cu and film_step.cu instantiate SINE_EXACT and SINE_FAST, the
// anatomy probes (siren_anatomy.cu) SINE_LINEAR. Returns a cudaError_t.
template <bool FILM, int SN>
int launch_passes(PassArgs g, const reni_step::Sums& o, int batch, int lo, int hi, int finish,
                  cudaStream_t s) {
  const size_t smem = pass_layout(g.H).total;
  const int last = g.gin != nullptr ? LAST_COT : g.out != nullptr ? LAST_OUT : LAST_STEP;
  if (image_grid(g.n_chunks, batch) == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int k = lo; k < hi && k < 2 * g.n_mm; ++k) {
    const PassFn fn = pass_kernel<FILM, SN>(k, g.n_mm, last, &g.j);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<image_grid(g.n_chunks, batch), PTHREADS, smem, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (finish & FINISH_IMG) {
    err = launch_reduce(g.part_img, o.out_img, batch, g.n_chunks,
                        reni_step::image_values(FILM, g.H, g.n_mm), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (finish & FINISH_W) {
    err = launch_reduce(g.part_w, o.out_w, 1, batch * g.n_chunks,
                        reni_step::weight_values(FILM, g.H, g.n_mm), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(finish & FINISH_DWS)) return 0;
  return (int)launch_weight_grads(true, g.sc_h, g.sc_dz, o.part_dws, o.dws,
                                  (long long)batch * g.P, o.rows_per_chunk, o.n_wchunks, g.H,
                                  g.n_mm, s);
}

}  // namespace reni_pass
