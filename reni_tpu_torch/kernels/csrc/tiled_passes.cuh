// Layer-major train step and backward for the trunks the wgmma passes of
// step_passes.cuh do not take: the float32 trunk at any width that is a
// multiple of 16 up to 1,024, the bf16 trunk at widths that are a multiple of
// 64 from 320 to 1,024, and a FiLM trunk of one layer (no H x H product) at
// any width that is a multiple of 64 (bf16) or 16 (float32) up to 1,024. Any
// depth. Four
// sources instantiate it, one per conditioning and dtype so that they build
// side by side (tiled_siren_bf16.cu, tiled_siren_f32.cu, tiled_film_bf16.cu,
// tiled_film_f32.cu, each through RENI_TILED_ENTRIES below);
// kernels/siren_step.py::pass_design picks this route ("tiled").
//
// Replaces, beside step_passes.cuh, the Pallas kernels _step_kernel and
// _film_step_kernel (the train steps) and _bwd_kernel and _film_bwd_kernel
// (the backward) of reni_tpu/kernels/siren_pallas.py, which keep the whole
// weight stack in VMEM and so take any depth at any width that is a multiple
// of 128. The passes, their scratch (sc_h, sc_keep, sc_dz), their per-CTA
// slots and the modes of the last pass (step, cotangent, output) are those of
// step_passes.cuh, with the same rounding points: the plain version of each
// pass is siren_step.py::step_pass_reference for both routes.
//
// What changes against step_passes.cuh, and why. There one CTA keeps one
// layer's weights (H x H bf16) and a 128-row tile in shared memory, and each
// warpgroup holds all H / 64 column blocks of its rows in registers: past
// H = 256 neither fits, and a float32 trunk has no wgmma. Here:
//   - a CTA walks its rows (the same chunks of 128-row tiles, so the slots
//     hold the same sums) 64 rows at a time, and each 64-row tile through
//     the layer's output columns 64 at a time. The block's product streams
//     both operands through shared memory in 32-deep K-slabs, two in flight
//     (cp.async): no CTA holds more than one slab of a layer, so neither the
//     width nor the depth is bounded by shared memory;
//   - the product of a block is mma.sync m16n8k16 (bf16 operands, float32
//     sums) for the bf16 trunk and float32 FFMA on the CUDA cores for the
//     float32 trunk (not TF32: it would miss the float32 bars);
//   - the block's sums go to shared memory and the epilogue reads them a
//     column a thread (64 columns, four row phases): bias, sine, the kept
//     value, FiLM modulation, dz, and each column's sums over the thread's
//     rows, added over the four phases in order into the CTA's per-column
//     accumulators (shared memory, NQ x H float32);
//   - the one sum over H, the final layer o = h Wf of the last pass, is
//     summed over the column blocks in order inside the CTA. The last pass
//     then forms g and runs the column blocks again for dh = g Wf^T and the
//     backward epilogue, forming the block's product a second time rather
//     than storing the last layer's kept value.
// No float atomics: two calls on the same inputs give the same bits. dWs is
// wgrad_bf16 / wgrad_f32 of siren_chain.cuh over the scratch, as on the
// other route.
//
// What bounds it on the H100. A simple tiled kernel first: the products run
// at a fraction of the tensor-core (bf16) or FFMA (float32) rate, and every
// 64 x 64 block reads its 64-row input tile and 64 weight rows from L2.
// kernels/siren_step.py::StepPlan.pass_cost gives each pass's bytes and
// operations; PERF.md holds the times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_passes.cuh"

namespace reni_tiled {

using namespace reni;
using reni_wg::cp_async16;
using bf16 = __nv_bfloat16;

constexpr int TT = 256;       // threads of a CTA
constexpr int BM = 64;        // rows of a tile
constexpr int BN = 64;        // output columns of a block
constexpr int BK = 32;        // depth of a K-slab
constexpr int STP = BN + 4;   // row pitch of the staged block sums (float32)
constexpr int NQ = 19;        // per-column sums: 3 bias / modulation, 8 dWf, 8 dA
constexpr int Q_DWF = 3, Q_DA = 11;
constexpr int CTA_ROWS = reni_wg::TILE;  // the slots' tile: a CTA's rows are whole 128-row tiles

template <typename T>
struct Prec;
template <>
struct Prec<float> {
  static constexpr bool BF16 = false;
  static constexpr int LDK = BK + 4;  // slab row pitch: 16-byte rows, 2-way bank conflicts at most
};
template <>
struct Prec<bf16> {
  static constexpr bool BF16 = true;
  static constexpr int LDK = BK + 8;  // 80-byte rows: the fragment loads are conflict-free
};

template <typename T>
struct TiledArgs {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias
  const T* ws;          // (n_mm, H, H) hidden weights: the backward's B operand
  const T* wst;         // (n_mm, H, H) their transposes: the forward's B operand
  const float* bs;      // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const T* wf;          // (H, C_PAD) final weight
  const float* bf;      // (C_PAD,)
  const float* fr;      // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;      // FiLM (B, (n_mm + 1) * H) phase shifts
  const float* tgt;     // (B, P, C_PAD) targets
  const float* sw;      // (P, C_PAD) pixel weights
  const float* bm;      // (B, C_PAD) batch mask
  const float* gin;     // (B, P, C_PAD) output cotangent of a backward; null for a step
  float* out;           // (B, P, C_PAD) output of a forward; null otherwise
  float* part_img;      // (B, n_chunks, n_img) per-image partial sums
  float* part_w;        // (B * n_chunks, n_w) loss and small weight sums
  T* sc_h;              // (n_mm, B * P, H) inputs h_j of the products
  float* sc_keep;       // (n_mm - 1, B * P, H) kept values of layers 1..n_mm-1
  T* sc_dz;             // (n_mm, B * P, H) cotangents dz_j of the products' outputs
  int P, H, n_mm, tiles_per_cta, n_chunks, act, wgrad;
  float omega0, omega_h, gscale2;
  int j;                // the product this pass runs; -1: the last pass of a one-layer FiLM trunk
};

// Shared memory of one CTA of any tiled pass (byte offsets from a
// 128-aligned base). kernels/siren_step.py mirrors it in tiled_smem_bytes.
struct TiledLayout {
  size_t sa, sb, st, red, acc, dt, gt, gf, lt, o, sums, total;
};

__host__ __device__ inline TiledLayout tiled_layout(int H, bool bf16) {
  const size_t es = bf16 ? 2 : 4, ldk = bf16 ? Prec<__nv_bfloat16>::LDK : Prec<float>::LDK;
  TiledLayout L;
  size_t off = 0;
  L.sa = off;    // two K-slabs of the input tile, (BM, LDK)
  off += align128(2 * BM * ldk * es);
  L.sb = off;    // two K-slabs of the block's weight rows, (BN, LDK)
  off += align128(2 * BN * ldk * es);
  L.st = off;    // the block's sums, (BM, STP) float32
  off += align128((size_t)BM * STP * 4);
  L.red = off;   // the four row phases' column sums, (4, NQ, BN)
  off += align128((size_t)4 * NQ * BN * 4);
  L.acc = off;   // the CTA's per-column sums, (NQ, H)
  off += align128((size_t)NQ * H * 4);
  L.dt = off;    // directions of the tile, (BM, K_PAD)
  off += align128((size_t)BM * K_PAD * 4);
  L.gt = off;    // the tile's g rounded for the products, (BM, C_PAD)
  off += align128((size_t)BM * C_PAD * 4);
  L.gf = off;    // g in float32
  off += align128((size_t)BM * C_PAD * 4);
  L.lt = off;    // loss terms
  off += align128((size_t)BM * C_PAD * 4);
  L.o = off;     // the final layer's sums
  off += align128((size_t)BM * C_PAD * 4);
  L.sums = off;  // the CTA's loss and dbf partials
  off += align128((size_t)2 * C_PAD * 4);
  L.total = off + 128;  // slack to align the base
  return L;
}

struct Smem {
  void* sa;
  void* sb;
  float *st, *red, *acc, *dt, *gt, *gf, *lt, *o, *sums;
};

__device__ __forceinline__ Smem smem_parts(unsigned char* raw, int H, bool bf16) {
  const uint32_t addr = reni_wg::smem_addr(raw);
  unsigned char* base = raw + ((128 - (addr & 127)) & 127);
  const TiledLayout L = tiled_layout(H, bf16);
  auto f = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  return {base + L.sa, base + L.sb, f(L.st), f(L.red), f(L.acc), f(L.dt), f(L.gt), f(L.gf),
          f(L.lt), f(L.o), f(L.sums)};
}

// The exact sine and cosine as calls: inlined at each of their sites they
// made every tiled kernel several times larger and its build minutes long.
// The fast and the linear modes stay inline.
static __device__ __noinline__ float exact_sin(float x) { return sinf(x); }
static __device__ __noinline__ float exact_cos(float x) { return cosf(x); }
static __device__ __noinline__ float2 exact_sincos(float x) {
  float2 r;
  sincosf(x, &r.x, &r.y);
  return r;
}

template <int SN>
__device__ __forceinline__ float tsin(float x) {
  if constexpr (SN == SINE_EXACT) return exact_sin(x);
  else return sine<SN>(x);
}

template <int SN>
__device__ __forceinline__ float tcos(float x) {
  if constexpr (SN == SINE_EXACT) return exact_cos(x);
  else return cosine<SN>(x);
}

template <int SN>
__device__ __forceinline__ void tsincos(float x, float* s, float* c) {
  if constexpr (SN == SINE_EXACT) {
    const float2 r = exact_sincos(x);
    *s = r.x;
    *c = r.y;
  } else {
    sine_cosine<SN>(x, s, c);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the block product: st (BM x BN) = A (rows x H) B^T, B (cols x H) row-major
// ---------------------------------------------------------------------------

// 64 rows x BK columns from k0 of a row-major matrix (pitch H) into a slab;
// rows at or past `rows` and columns at or past H are zero-filled
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* src, int rows, int k0, int H) {
  constexpr int E = 16 / (int)sizeof(T), PER = BK / E, LDK = Prec<T>::LDK;
  for (int i = threadIdx.x; i < 64 * PER; i += TT) {
    const int r = i / PER, k = (i % PER) * E;
    const bool in = r < rows && k0 + k < H;
    cp_async16(dst + r * LDK + k, in ? src + (size_t)r * H + k0 + k : src, in);
  }
}

// float32: 4 x 4 outputs a thread (rows ty + 16 i, columns tx + 16 j), FFMA
__device__ __forceinline__ void slab_mma(float (&acc)[16], const float* a, const float* b) {
  constexpr int LDK = Prec<float>::LDK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LDK + k];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = b[(tx + 16 * i) * LDK + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i * 4 + jj] = fmaf(x[i], y[jj], acc[i * 4 + jj]);
  }
}

__device__ __forceinline__ void store_acc(const float (&acc)[16], float* st, const float*) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) st[(ty + 16 * i) * STP + tx + 16 * jj] = acc[i * 4 + jj];
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d (16 x 8, float32) += a (16 x 16, row-major) b (16 x 8, column-major), bf16 operands
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: warp w owns rows (w % 4) * 16 .. +16 and columns (w / 4) * 32 .. +32,
// four m16n8k16 tiles side by side
__device__ __forceinline__ void slab_mma(float (&acc)[16], const bf16* a, const bf16* b) {
  constexpr int LDK = Prec<bf16>::LDK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* a0 = a + ((warp % 4) * 16 + g) * LDK + 2 * t;
  const bf16* b0 = b + ((warp / 4) * 32 + g) * LDK + 2 * t;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    const uint32_t af[4] = {ld32(a0 + ks), ld32(a0 + 8 * LDK + ks), ld32(a0 + ks + 8),
                            ld32(a0 + 8 * LDK + ks + 8)};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* bp = b0 + nt * 8 * LDK + ks;
      mma16816(acc + nt * 4, af, ld32(bp), ld32(bp + 8));
    }
  }
}

__device__ __forceinline__ void store_acc(const float (&acc)[16], float* st, const bf16*) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = (warp % 4) * 16 + g, c = (warp / 4) * 32 + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      st[r * STP + c + nt * 8 + e] = acc[nt * 4 + e];
      st[(r + 8) * STP + c + nt * 8 + e] = acc[nt * 4 + 2 + e];
    }
}

// st = the A tile (a_rows valid rows) times the B rows (b_rows valid), both
// of depth H, summed over K-slabs in order; ends with st visible to all
template <typename T>
__device__ void block_product(const T* A, int a_rows, const T* B, int b_rows, int H, T* sa,
                              T* sb, float* st) {
  constexpr int SLAB = 64 * Prec<T>::LDK;
  const int nk = (H + BK - 1) / BK;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  load_slab(sa, A, a_rows, 0, H);
  load_slab(sb, B, b_rows, 0, H);
  cp_async_commit();
  for (int ks = 0; ks < nk; ++ks) {
    const int cur = ks & 1;
    if (ks + 1 < nk) {
      load_slab(sa + (cur ^ 1) * SLAB, A, a_rows, (ks + 1) * BK, H);
      load_slab(sb + (cur ^ 1) * SLAB, B, b_rows, (ks + 1) * BK, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    slab_mma(acc, sa + cur * SLAB, sb + cur * SLAB);
    __syncthreads();
  }
  store_acc(acc, st, sa);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// tiles, per-column sums, layer 0
// ---------------------------------------------------------------------------

struct Rows {
  int p0, valid;
  size_t row0;
};

// the CTA's rows [begin, end) of its image: whole 128-row tiles, as the slots count them
__device__ __forceinline__ int rows_begin(int tiles_per_cta) {
  return blockIdx.x * tiles_per_cta * CTA_ROWS;
}
__device__ __forceinline__ int rows_end(int tiles_per_cta, int P) {
  return min(P, (int)(blockIdx.x + 1) * tiles_per_cta * CTA_ROWS);
}

// the directions of the tile rounded as the trunk's products take them, zero past `valid`
template <bool BF>
__device__ __forceinline__ void load_dtile(const float* d, float* dt, const Rows& t) {
  for (int i = threadIdx.x; i < BM * K_PAD; i += TT) {
    const int r = i / K_PAD;
    dt[i] = r < t.valid ? rnd<BF>(d[(size_t)(t.p0 + r) * K_PAD + i % K_PAD]) : 0.0f;
  }
}

// the first-layer weight of column c, rounded as the products take it
template <bool BF>
__device__ __forceinline__ void first_column(const float* a, int H, int c, float (&ac)[K_PAD]) {
#pragma unroll
  for (int k = 0; k < K_PAD; ++k) ac[k] = rnd<BF>(__ldg(a + (size_t)k * H + c));
}

__device__ __forceinline__ float layer0_z(const float* dt, int r, const float (&ac)[K_PAD]) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < K_PAD; ++k) x = fmaf(dt[r * K_PAD + k], ac[k], x);
  return x;
}

// h_0 of the tile's valid rows into sc_h[0], a thread per column; visible
// to the CTA's copies on return
template <typename T, bool FILM, int SN>
__device__ void write_h0(const TiledArgs<T>& g, const float* dt, const Rows& t) {
  constexpr bool BF = Prec<T>::BF16;
  const int H = g.H, b = blockIdx.y;
  for (int c = threadIdx.x; c < H; c += TT) {
    float ac[K_PAD];
    first_column<BF>(g.a + (size_t)b * K_PAD * H, H, c, ac);
    const float bias = FILM ? __ldg(g.bs + c) : __ldg(g.b0 + (size_t)b * H + c);
    const size_t img = (size_t)b * (g.n_mm + 1) * H + c;
    const float f = FILM ? __ldg(g.fr + img) : 0.0f, p = FILM ? __ldg(g.ph + img) : 0.0f;
    for (int r = 0; r < t.valid; ++r) {
      const float x = layer0_z(dt, r, ac) + bias;
      const float s = FILM ? tsin<SN>(__fadd_rn(__fmul_rn(f, x), p)) : tsin<SN>(g.omega0 * x);
      put(g.sc_h + (t.row0 + r) * H + c, s);
    }
  }
  __threadfence_block();
  __syncthreads();
}

// the four row phases' column sums `part` of the block at c0 added, phase
// by phase in order, into the CTA's per-column sums acc (NQ, H)
__device__ __forceinline__ void add_columns(const float (&part)[NQ], float* red, float* acc,
                                            int c0, int H) {
  const int c = threadIdx.x & 63, q = threadIdx.x >> 6;
#pragma unroll
  for (int i = 0; i < NQ; ++i) red[(q * NQ + i) * BN + c] = part[i];
  __syncthreads();
  for (int i = threadIdx.x; i < NQ * BN; i += TT) {
    const int qq = i / BN, cc = i % BN;
    if (c0 + cc < H)
      acc[(size_t)qq * H + c0 + cc] +=
          ((red[qq * BN + cc] + red[(NQ + qq) * BN + cc]) + red[(2 * NQ + qq) * BN + cc]) +
          red[(3 * NQ + qq) * BN + cc];
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += TT) p[i] = 0.0f;
}

// ---------------------------------------------------------------------------
// the passes
// ---------------------------------------------------------------------------

template <typename T, bool FILM, int SN>
__global__ void __launch_bounds__(TT) tiled_fwd(TiledArgs<T> g) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_parts(smem_raw, g.H, Prec<T>::BF16);
  T* sa = static_cast<T*>(sm.sa);
  T* sb = static_cast<T*>(sm.sb);
  const int H = g.H, j = g.j, b = blockIdx.y, c_own = threadIdx.x & 63, q = threadIdx.x >> 6;
  const size_t rows = (size_t)gridDim.y * g.P;
  const T* h_in = g.sc_h + (size_t)j * rows * H;
  T* h_out = g.sc_h + (size_t)(j + 1) * rows * H;
  float* keep_out = g.sc_keep + (size_t)j * rows * H;
  const float* bias = g.bs + (size_t)(FILM ? j + 1 : j) * H;
  const size_t img = ((size_t)b * (g.n_mm + 1) + j + 1) * H;
  const float* d = g.d + b * g.d_bstride;
  const int end = rows_end(g.tiles_per_cta, g.P);
  for (int p0 = rows_begin(g.tiles_per_cta); p0 < end; p0 += BM) {
    const Rows t{p0, min(BM, end - p0), (size_t)b * g.P + p0};
    if (j == 0) {
      load_dtile<Prec<T>::BF16>(d, sm.dt, t);
      __syncthreads();
      write_h0<T, FILM, SN>(g, sm.dt, t);
    }
    for (int c0 = 0; c0 < H; c0 += BN) {
      block_product(h_in + t.row0 * H, t.valid, g.wst + ((size_t)j * H + c0) * H,
                    min(BN, H - c0), H, sa, sb, sm.st);
      const int cc = c0 + c_own;
      if (cc < H) {
        const float bv = __ldg(bias + cc);
        const float f = FILM ? __ldg(g.fr + img + cc) : 0.0f;
        const float p = FILM ? __ldg(g.ph + img + cc) : 0.0f;
        for (int r = q; r < t.valid; r += 4) {
          const float x = sm.st[r * STP + c_own];
          float s, kept;
          if constexpr (FILM) {
            kept = x + bv;
            s = tsin<SN>(__fadd_rn(__fmul_rn(f, kept), p));
          } else {
            tsincos<SN>(g.omega_h * (x + bv), &s, &kept);
          }
          const size_t o = (t.row0 + r) * H + cc;
          put(h_out + o, s);
          keep_out[o] = kept;
        }
      }
      __syncthreads();
    }
  }
}

// The block's values before the layer's bias: the product h_j W_j, or for
// a one-layer FiLM trunk (j = -1) layer 0's d A (no product); ends with st
// visible to all
template <typename T>
__device__ __forceinline__ void last_block(const TiledArgs<T>& g, const Smem& sm, const T* h_in,
                                           const Rows& t, int c0) {
  constexpr bool BF = Prec<T>::BF16;
  const int H = g.H;
  if (g.j >= 0) {
    block_product(h_in + t.row0 * H, t.valid, g.wst + ((size_t)g.j * H + c0) * H,
                  min(BN, H - c0), H, static_cast<T*>(sm.sa), static_cast<T*>(sm.sb), sm.st);
    return;
  }
  const int c_own = threadIdx.x & 63, cc = c0 + c_own;
  float ac[K_PAD] = {};
  if (cc < H) first_column<BF>(g.a + (size_t)blockIdx.y * K_PAD * H, H, cc, ac);
  for (int r = threadIdx.x >> 6; r < BM; r += 4)
    sm.st[r * STP + c_own] = cc < H ? layer0_z(sm.dt, r, ac) : 0.0f;
  __syncthreads();
}

// The last pass. LAST_STEP: the last product and activation over every
// column block, the final layer summed over the blocks in order, the loss
// and g. LAST_COT (a backward): g read from gin; no final layer, no loss.
// Then in both, the column blocks again: the product formed again, dh =
// g Wf^T, the last layer's backward epilogue, dz to sc_dz[j], its column
// sums and (with weight gradients) dWf. LAST_OUT (a forward): the last
// product, activation and final layer, the output to out, nothing else.
// A one-layer FiLM trunk (n_mm = 0, j = -1) takes layer 0 from d in place
// of the product and forms dA here (there is no bwd pass).
template <typename T, bool FILM, int SN, int MODE>
__global__ void __launch_bounds__(TT) tiled_last(TiledArgs<T> g) {
  constexpr bool BF = Prec<T>::BF16, COT = MODE == reni_pass::LAST_COT;
  constexpr bool OUT = MODE == reni_pass::LAST_OUT;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_parts(smem_raw, g.H, BF);
  const int H = g.H, j = g.j, b = blockIdx.y, tid = threadIdx.x, n_mm = g.n_mm;
  const int c_own = tid & 63, q = tid >> 6;
  const bool first = j < 0, wgrad = g.wgrad != 0;
  const int layer = j + 1;  // FiLM's row of the last layer's vectors; Cond-by-Concat's bias row is j
  const size_t rows = (size_t)gridDim.y * g.P;
  const T* h_in = first ? nullptr : g.sc_h + (size_t)j * rows * H;
  T* dz_out = first ? nullptr : g.sc_dz + (size_t)j * rows * H;
  const float* bias = g.bs + (size_t)(FILM ? layer : j) * H;
  const size_t img = ((size_t)b * (n_mm + 1) + layer) * H;
  const float* d = g.d + b * g.d_bstride;
  zero(sm.acc, NQ * H);
  zero(sm.sums, 2 * C_PAD);
  __syncthreads();

  // the layer's activation and kept value at column cc from the block's value x
  auto activation = [&](float x, float bv, float f, float p, float* kept) {
    float s;
    if constexpr (FILM) {
      *kept = x + bv;
      s = tsin<SN>(__fadd_rn(__fmul_rn(f, *kept), p));
    } else {
      float cs;
      tsincos<SN>(g.omega_h * (x + bv), &s, &cs);
      *kept = __fmul_rn(g.omega_h, cs);
    }
    return s;
  };

  const int end = rows_end(g.tiles_per_cta, g.P);
  for (int p0 = rows_begin(g.tiles_per_cta); p0 < end; p0 += BM) {
    const Rows t{p0, min(BM, end - p0), (size_t)b * g.P + p0};
    if (j <= 0) {
      load_dtile<BF>(d, sm.dt, t);
      __syncthreads();
      if (j == 0) write_h0<T, FILM, SN>(g, sm.dt, t);
    }
    if constexpr (COT) {
      for (int i = tid; i < BM * C_PAD; i += TT) {
        const int r = i / C_PAD;
        const float v = r < t.valid ? g.gin[(t.row0 + r) * C_PAD + i % C_PAD] : 0.0f;
        sm.gf[i] = v;
        sm.gt[i] = rnd<BF>(v);
      }
      __syncthreads();
    } else {
      zero(sm.o, BM * C_PAD);
      for (int c0 = 0; c0 < H; c0 += BN) {
        last_block(g, sm, h_in, t, c0);
        // the activation as the final layer takes it (stored dtype), zero past H
        const int cc = c0 + c_own;
        const float bv = cc < H ? __ldg(bias + cc) : 0.0f;
        const float f = FILM && cc < H ? __ldg(g.fr + img + cc) : 0.0f;
        const float p = FILM && cc < H ? __ldg(g.ph + img + cc) : 0.0f;
        for (int r = q; r < BM; r += 4) {
          float kept;
          const float s = activation(sm.st[r * STP + c_own], bv, f, p, &kept);
          sm.st[r * STP + c_own] = cc < H ? rnd<BF>(s) : 0.0f;
        }
        __syncthreads();
        // o[r][k] += the block's columns in order
        for (int i = tid; i < BM * C_PAD; i += TT) {
          const int r = i / C_PAD, k = i % C_PAD;
          float s = 0.0f;
          for (int c = 0; c < BN && c0 + c < H; ++c)
            s = fmaf(sm.st[r * STP + c], get(g.wf[(size_t)(c0 + c) * C_PAD + k]), s);
          sm.o[i] += s;
        }
        __syncthreads();
      }
      for (int i = tid; i < BM * C_PAD; i += TT) {
        const int r = i / C_PAD, k = i % C_PAD;
        if constexpr (OUT) {
          if (r < t.valid) g.out[(t.row0 + r) * C_PAD + k] = sm.o[i] + g.bf[k];
        } else {
          float dact;
          const float out = reni_pass::activate(g.act, sm.o[i] + g.bf[k], &dact);
          float gv = 0.0f, loss = 0.0f;
          if (r < t.valid) {
            const float res = __fsub_rn(out, g.tgt[(t.row0 + r) * C_PAD + k]);
            const float rs = __fmul_rn(
                res, __fmul_rn(g.sw[(size_t)(t.p0 + r) * C_PAD + k], g.bm[(size_t)b * C_PAD + k]));
            loss = __fmul_rn(rs, res);
            gv = __fmul_rn(g.gscale2, rs);
            if (g.act != 0) gv = __fmul_rn(gv, dact);
          }
          sm.lt[i] = loss;
          sm.gf[i] = gv;
          sm.gt[i] = rnd<BF>(gv);
        }
      }
      __syncthreads();
      if constexpr (OUT) continue;
    }
    if (wgrad && tid < 2 * C_PAD && (!COT || tid >= C_PAD)) {  // mse (a step) and dbf, rows in order
      const float* src = tid < C_PAD ? sm.lt : sm.gf;
      const int k = tid % C_PAD;
      float s = 0.0f;
      for (int r = 0; r < BM; ++r) s += src[r * C_PAD + k];
      sm.sums[tid] += s;
    }
    for (int c0 = 0; c0 < H; c0 += BN) {
      last_block(g, sm, h_in, t, c0);
      float part[NQ] = {};
      const int cc = c0 + c_own;
      if (cc < H) {
        const float bv = __ldg(bias + cc);
        const float f = FILM ? __ldg(g.fr + img + cc) : 0.0f;
        const float p = FILM ? __ldg(g.ph + img + cc) : 0.0f;
        float wfc[C_PAD];
#pragma unroll
        for (int k = 0; k < C_PAD; ++k) wfc[k] = get(g.wf[(size_t)cc * C_PAD + k]);
        for (int r = q; r < t.valid; r += 4) {
          float kept;
          const float s = activation(sm.st[r * STP + c_own], bv, f, p, &kept);
          float gr[C_PAD];
          float dh = 0.0f;
#pragma unroll
          for (int k = 0; k < C_PAD; ++k) {
            gr[k] = sm.gt[r * C_PAD + k];
            dh = fmaf(gr[k], wfc[k], dh);
          }
          float dz;
          if constexpr (FILM) {
            const float dm = __fmul_rn(dh, tcos<SN>(__fadd_rn(__fmul_rn(f, kept), p)));
            dz = __fmul_rn(dm, f);
            part[0] += __fmul_rn(dm, kept);
            part[1] += dm;
            part[2] += dz;
          } else {
            dz = __fmul_rn(dh, kept);
            part[0] += dz;
          }
          if (!first) put(dz_out + (t.row0 + r) * H + cc, dz);
          if (wgrad) {
            const float sr = rnd<BF>(s);  // dWf takes the stored activation
#pragma unroll
            for (int k = 0; k < C_PAD; ++k) part[Q_DWF + k] = fmaf(sr, gr[k], part[Q_DWF + k]);
          }
          if (first) {
            const float zq = rnd<BF>(dz);
#pragma unroll
            for (int k = 0; k < K_PAD; ++k)
              part[Q_DA + k] = fmaf(sm.dt[r * K_PAD + k], zq, part[Q_DA + k]);
          }
        }
      }
      add_columns(part, sm.red, sm.acc, c0, H);
    }
  }

  if constexpr (OUT) return;
  const int n_w = reni_step::weight_values(FILM, H, n_mm);
  const int n_img = reni_step::image_values(FILM, H, n_mm);
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + blockIdx.x) * n_w;
  float* part_img = g.part_img + ((size_t)b * g.n_chunks + blockIdx.x) * n_img;
  float* dwf_out = part_w + C_PAD + (size_t)reni_step::bias_rows(FILM, n_mm) * H;
  if (wgrad && tid < C_PAD) {  // the backward's mse slot stays 0
    part_w[tid] = sm.sums[tid];
    dwf_out[H * C_PAD + tid] = sm.sums[C_PAD + tid];
  }
  const int T_ = n_mm + 1;
  for (int c = tid; c < H; c += TT) {
    if (wgrad) {
#pragma unroll
      for (int k = 0; k < C_PAD; ++k) dwf_out[(size_t)c * C_PAD + k] = sm.acc[(size_t)(Q_DWF + k) * H + c];
    }
    if constexpr (FILM) {
      part_img[(size_t)(K_PAD + layer) * H + c] = sm.acc[c];
      part_img[(size_t)(K_PAD + T_ + layer) * H + c] = sm.acc[(size_t)H + c];
      if (wgrad) part_w[C_PAD + (size_t)layer * H + c] = sm.acc[(size_t)2 * H + c];
      if (first) {
#pragma unroll
        for (int k = 0; k < K_PAD; ++k) part_img[(size_t)k * H + c] = sm.acc[(size_t)(Q_DA + k) * H + c];
      }
    } else if (wgrad) {
      part_w[C_PAD + (size_t)j * H + c] = sm.acc[c];
    }
  }
}

template <typename T, bool FILM, int SN>
__global__ void __launch_bounds__(TT) tiled_bwd(TiledArgs<T> g) {
  constexpr bool BF = Prec<T>::BF16;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_parts(smem_raw, g.H, BF);
  T* sa = static_cast<T*>(sm.sa);
  T* sb = static_cast<T*>(sm.sb);
  const int H = g.H, j = g.j, b = blockIdx.y, tid = threadIdx.x;
  const int c_own = tid & 63, q = tid >> 6;
  // the column sums of dz: dbs (weight gradients only) or, Cond-by-Concat at
  // j = 0, the per-image db0; FiLM's dfreqs and dphases sums always run
  const bool dz_sums = g.wgrad != 0 || (!FILM && j == 0);
  const size_t rows = (size_t)gridDim.y * g.P;
  const float* keep = j > 0 ? g.sc_keep + (size_t)(j - 1) * rows * H : nullptr;
  T* dz_out = j > 0 ? g.sc_dz + (size_t)(j - 1) * rows * H : nullptr;
  const T* dz_in = g.sc_dz + (size_t)j * rows * H;
  const size_t img = ((size_t)b * (g.n_mm + 1) + j) * H;
  const float* d = g.d + b * g.d_bstride;
  const float om = j > 0 ? g.omega_h : g.omega0;
  zero(sm.acc, NQ * H);
  __syncthreads();

  const int end = rows_end(g.tiles_per_cta, g.P);
  for (int p0 = rows_begin(g.tiles_per_cta); p0 < end; p0 += BM) {
    const Rows t{p0, min(BM, end - p0), (size_t)b * g.P + p0};
    if (j == 0) load_dtile<BF>(d, sm.dt, t);  // visible after the product's barriers
    for (int c0 = 0; c0 < H; c0 += BN) {
      block_product(dz_in + t.row0 * H, t.valid, g.ws + ((size_t)j * H + c0) * H,
                    min(BN, H - c0), H, sa, sb, sm.st);  // st = dh_j
      float part[NQ] = {};
      const int cc = c0 + c_own;
      if (cc < H) {
        const float f = FILM ? __ldg(g.fr + img + cc) : 0.0f;
        const float p = FILM ? __ldg(g.ph + img + cc) : 0.0f;
        float ac[K_PAD] = {};
        float bias = 0.0f;
        if (j == 0) {
          first_column<BF>(g.a + (size_t)b * K_PAD * H, H, cc, ac);
          bias = FILM ? __ldg(g.bs + cc) : __ldg(g.b0 + (size_t)b * H + cc);
        }
        for (int r = q; r < t.valid; r += 4) {
          const float dh = sm.st[r * STP + c_own];
          // the kept value of layer j (Cond-by-Concat the cos factor, FiLM the
          // pre-modulation value), or (j = 0) formed again from d
          float kv;
          if (j > 0) {
            kv = keep[(t.row0 + r) * H + cc];
          } else {
            const float x = layer0_z(sm.dt, r, ac) + bias;
            if constexpr (FILM) {
              kv = x;
            } else {
              float s;
              tsincos<SN>(g.omega0 * x, &s, &kv);
            }
          }
          float dz;
          if constexpr (FILM) {
            const float dm = __fmul_rn(dh, tcos<SN>(__fadd_rn(__fmul_rn(f, kv), p)));
            dz = __fmul_rn(dm, f);
            part[0] += __fmul_rn(dm, kv);
            part[1] += dm;
            part[2] += dz;
          } else {
            dz = __fmul_rn(dh, __fmul_rn(om, kv));
            part[0] += dz;
          }
          if (j > 0) {
            put(dz_out + (t.row0 + r) * H + cc, dz);
          } else {  // dA: d^T dz0, dz0 rounded as stored
            const float zq = rnd<BF>(dz);
#pragma unroll
            for (int k = 0; k < K_PAD; ++k)
              part[Q_DA + k] = fmaf(sm.dt[r * K_PAD + k], zq, part[Q_DA + k]);
          }
        }
      }
      add_columns(part, sm.red, sm.acc, c0, H);
    }
  }

  const int n_mm = g.n_mm, T_ = n_mm + 1;
  const int n_img = reni_step::image_values(FILM, H, n_mm);
  const int n_w = reni_step::weight_values(FILM, H, n_mm);
  float* part_img = g.part_img + ((size_t)b * g.n_chunks + blockIdx.x) * n_img;
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + blockIdx.x) * n_w;
  for (int c = tid; c < H; c += TT) {
    if constexpr (FILM) {
      part_img[(size_t)(K_PAD + j) * H + c] = sm.acc[c];
      part_img[(size_t)(K_PAD + T_ + j) * H + c] = sm.acc[(size_t)H + c];
      if (dz_sums) part_w[C_PAD + (size_t)j * H + c] = sm.acc[(size_t)2 * H + c];
    } else if (dz_sums) {
      (j > 0 ? part_w + C_PAD + (size_t)(j - 1) * H : part_img + K_PAD * H)[c] = sm.acc[c];
    }
    if (j == 0) {
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) part_img[(size_t)k * H + c] = sm.acc[(size_t)(Q_DA + k) * H + c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Passes [lo, hi) of a step, a backward (gin set) or a forward (out set)
// with the sine mode SN, then what `finish` (reni_pass::FINISH_*) asks for.
// The passes: products 0..n_mm-2 forward, the last pass, then the backward
// from n_mm-1 down to 0 (2 n_mm passes); a one-layer FiLM trunk has the
// last pass alone. Returns a cudaError_t.
template <typename T, bool FILM, int SN>
int launch_tiled(TiledArgs<T> g, const reni_step::Sums& o, int batch, int lo, int hi,
                 int finish, cudaStream_t s) {
  using Fn = void (*)(TiledArgs<T>);
  const size_t smem = tiled_layout(g.H, Prec<T>::BF16).total;
  const int n_mm = g.n_mm, n_pass = n_mm > 0 ? 2 * n_mm : 1, k_last = n_mm > 0 ? n_mm - 1 : 0;
  cudaError_t err;
  for (int k = lo; k < hi && k < n_pass; ++k) {
    Fn fn;
    if (k < k_last) {
      g.j = k;
      fn = tiled_fwd<T, FILM, SN>;
    } else if (k == k_last) {
      g.j = n_mm - 1;
      fn = g.gin != nullptr   ? tiled_last<T, FILM, SN, reni_pass::LAST_COT>
           : g.out != nullptr ? tiled_last<T, FILM, SN, reni_pass::LAST_OUT>
                              : tiled_last<T, FILM, SN, reni_pass::LAST_STEP>;
    } else {
      g.j = 2 * n_mm - 1 - k;
      fn = tiled_bwd<T, FILM, SN>;
    }
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<dim3(g.n_chunks, batch), TT, smem, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (finish & reni_pass::FINISH_IMG) {
    err = launch_reduce(g.part_img, o.out_img, batch, g.n_chunks,
                        reni_step::image_values(FILM, g.H, n_mm), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (finish & reni_pass::FINISH_W) {
    err = launch_reduce(g.part_w, o.out_w, 1, batch * g.n_chunks,
                        reni_step::weight_values(FILM, g.H, n_mm), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(finish & reni_pass::FINISH_DWS)) return 0;
  return (int)launch_weight_grads(Prec<T>::BF16, g.sc_h, g.sc_dz, o.part_dws, o.dws,
                                  (long long)batch * g.P, o.rows_per_chunk, o.n_wchunks, g.H,
                                  n_mm, s);
}

template <typename T, bool FILM>
int run_tiled(const TiledArgs<T>& g, bool fast, const reni_step::Sums& o, int batch, int lo,
              int hi, int finish, cudaStream_t s) {
  return fast ? launch_tiled<T, FILM, SINE_FAST>(g, o, batch, lo, hi, finish, s)
              : launch_tiled<T, FILM, SINE_EXACT>(g, o, batch, lo, hi, finish, s);
}

}  // namespace reni_tiled

// The C interface of one source (conditioning FILM, trunk dtype T):
//   reni_tiled_passes: passes [pass_lo, pass_hi) of a step (tgt, sw, bm
//     set), a backward (gin set; wgrad = 0 for the per-image gradients
//     alone) or a forward (out set), then what `finish` asks for
//     (reni_pass::FINISH_*). n_mm H x H products (Cond-by-Concat L, FiLM
//     T - 1); b0 Cond-by-Concat only, fr and ph FiLM only; ws as stored, wst
//     its transpose per layer, wf, sc_h and sc_dz in T; sc_keep (n_mm - 1,
//     B P, H) float32. Outputs as for reni_siren_step / reni_film_step of
//     siren_step.cu / film_step.cu. Returns a cudaError_t.
//   reni_tiled_smem_bytes: shared memory of one CTA (kernels/siren_step.py
//     mirrors it in tiled_smem_bytes).
#define RENI_TILED_ENTRIES(T, FILM)                                                              \
  extern "C" {                                                                                   \
  int reni_tiled_passes(const float* d, long long d_bstride, const float* a, const float* b0,   \
                        const void* ws, const void* wst, const float* bs, const void* wf,       \
                        const float* bf, const float* fr, const float* ph, const float* tgt,    \
                        const float* sw, const float* bm, const float* gin, float* out,         \
                        float* part_img, float* out_img, float* part_w, float* out_w,           \
                        void* sc_h, float* sc_keep, void* sc_dz, float* part_dws, float* dws,   \
                        int batch, int P, int H, int n_mm, int tiles_per_cta, int n_chunks,     \
                        int rows_per_chunk, int n_wchunks, float omega0, float omega_h,         \
                        float gscale, int fast, int act, int wgrad, int pass_lo, int pass_hi,   \
                        int finish, void* stream) {                                             \
    const reni_tiled::TiledArgs<T> g{                                                            \
        d, d_bstride, a, b0, static_cast<const T*>(ws), static_cast<const T*>(wst), bs,         \
        static_cast<const T*>(wf), bf, fr, ph, tgt, sw, bm, gin, out, part_img, part_w,         \
        static_cast<T*>(sc_h), sc_keep, static_cast<T*>(sc_dz), P, H, n_mm, tiles_per_cta,      \
        n_chunks, act, wgrad, omega0, omega_h, 2.0f * gscale, 0};                               \
    const reni_step::Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};       \
    return reni_tiled::run_tiled<T, FILM>(g, fast != 0, sums, batch, pass_lo, pass_hi, finish,  \
                                          static_cast<cudaStream_t>(stream));                   \
  }                                                                                              \
  int reni_tiled_smem_bytes(int H) {                                                             \
    return (int)reni_tiled::tiled_layout(H, reni_tiled::Prec<T>::BF16).total;                   \
  }                                                                                              \
  const char* reni_tiled_error_string(int err) {                                                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                                    \
  }                                                                                              \
  }
