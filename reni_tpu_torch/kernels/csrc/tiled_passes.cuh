// Layer-major train step, backward and differentiable forward for the
// trunks the wgmma passes of step_passes.cuh do not take: the bf16 trunk at
// widths that are a multiple of 64 from 320 up, the float32 trunk at any
// width that is a multiple of 16, and a FiLM trunk of one layer (no H x H
// product) at any such width. Any depth, any width: nothing a CTA keeps
// grows with H. Four sources instantiate it, one per conditioning and dtype
// so that they build side by side (tiled_siren_bf16.cu, tiled_siren_f32.cu,
// tiled_film_bf16.cu, tiled_film_f32.cu, each through RENI_TILED_ENTRIES
// below); kernels/siren_step.py::pass_design picks this route ("tiled").
//
// Replaces, beside step_passes.cuh, the Pallas kernels _step_kernel and
// _film_step_kernel (the train steps) and _bwd_kernel and _film_bwd_kernel
// (the backward) of reni_tpu/kernels/siren_pallas.py, which keep the whole
// weight stack in VMEM and so take any depth at any width that is a multiple
// of 128. The passes, their scratch (sc_h, sc_keep, sc_dz), their per-CTA
// slots and the modes of the last pass (step, cotangent, output) are those
// of step_passes.cuh, with the same rounding points: the plain version of
// each pass is siren_step.py::step_pass_reference for both routes.
//
// The design. A CTA owns one block of output columns of one chunk of one
// image's rows (grid: (chunk, column block, image), flat on x), so every
// per-column sum belongs to the block: it goes from registers to the CTA's
// slot columns, and no CTA holds anything H wide.
//   - bf16 (tiled_product_bf16): 128 rows (two consumer warpgroups of 64) x
//     a block of 64 NB columns, NB = 4, 3, 2 or 1 by the width (block_nb),
//     a compile-time constant of the kernel: wgmma m64n(64 NB)k16 with
//     float32 accumulators in registers, no wgmma under a branch. The
//     weights come packed by the wrapper as 64-deep K-slabs already
//     swizzled (pack_slabs, as for fused_fwd.cuh); the block's part of a
//     slab is one contiguous bulk copy, issued by one producer thread into a
//     ring of mbarrier stages. Each consumer warpgroup streams its 64 rows
//     of the input into the same stages with cp.async (128-byte swizzle),
//     S - 1 slabs ahead, the next tile's first slabs under this tile's
//     epilogue.
//   - float32 (tiled_product_f32): 128 rows x 64 columns a CTA of 128
//     threads, 8 x 8 outputs a thread on the CUDA cores (FFMA, not TF32:
//     it would miss the float32 bars), 16-deep K-slabs of both operands
//     through a ring of three cp.async stages; the input rows stay
//     row-major and are read as float4 along K, the weights as float4 along
//     the columns, both conflict-free. Two CTAs share an SM, so one's
//     epilogue runs under the other's products (on an H100 5% faster at
//     5 x 512 than one 256-thread CTA of 128 x 128). wgrad_f32
//     (siren_chain.cuh) has the same 8 x 8 register tiles in one 256-thread
//     CTA of 128 x 128 (a 128 x 64 CTA pair measured no faster there on an
//     H100: it has no epilogue); its bf16 counterpart wgrad_bf16 is a wgmma
//     split-K GEMM over tensor-map K-slabs of the scratch, 128 x up to 256
//     outputs a CTA.
//   - the epilogues work on the accumulators in registers: bias, sine, the
//     kept value, FiLM modulation, dz; column sums by warp shuffles, kept in
//     registers across the CTA's tiles and added over the warps in order at
//     the end; dA (the first layer's d^T dz0) from dz0 staged in shared
//     memory, a thread per column.
//   - the last pass is split at its one sum over H, o = h Wf: its product
//     stores the last layer's pre-activation (sc_keep[j], so nothing is
//     formed twice) and each column block's partial o (sc_o); tiled_head
//     adds the partials in block order, forms the loss and g (sc_g), the
//     loss and dbf sums (or, in the output mode, the output); tiled_last_bwd
//     then forms dh = g Wf^T, dz, the column sums and dWf elementwise from
//     sc_keep and sc_g.
//   - layer 0 (K = 8) is tiled_layer0, elementwise: h_0 into sc_h[0], which
//     pass 0's product then reads like any other layer (a one-layer FiLM
//     trunk: the last layer's pre-activation and partial o in its place).
// No float atomics: two calls on the same inputs give the same bits. dWs is
// wgrad_bf16 (wgmma on MN-major K-slabs of sc_h / sc_dz) / wgrad_f32 of
// siren_chain.cuh over the scratch, as on the other route.
//
// What bounds it on the H100. Per 128 x 256 bf16 block and 64 of K a
// consumer pair issues 8 wgmma (4.2 MFLOP) on 48 KB of slabs from L2, so the
// products stay below the tensor-core rate by the L2 rate; the epilogues'
// sines and the scratch traffic (kernels/siren_step.py::StepPlan.pass_cost,
// bytes and operations of each pass) bound the rest. PERF.md holds the times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "step_passes.cuh"

namespace reni_tiled {

using namespace reni;
using namespace reni_wg;
using bf16 = __nv_bfloat16;

constexpr int ET = 256;          // threads of the elementwise kernels
constexpr int ROWS = 128;        // rows of a product tile
constexpr int CTA_ROWS = TILE;   // the slots' tile: a CTA's rows are whole 128-row tiles
constexpr int STAGES = 3;        // ring stages of both products
constexpr int BK = 64;           // depth of a bf16 K-slab (one swizzle atom)
// the float32 product: threads (two CTAs an SM), block columns, slab depth, A pitch
constexpr int FT = 128, FBN = 64, FBK = 16, FLDA = FBK + 4;
constexpr int NQ = 19;           // elementwise per-column sums: 3 bias / modulation, 8 dWf, 8 dA
constexpr int Q_DWF = 3, Q_DA = 11;
constexpr int EBM = 64;          // rows of an elementwise tile
constexpr int STP = 64 + 4;      // pitch of its staged activations
// the bf16 product: two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256, PTT = CONSUMERS + 128;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
enum { BAR_CONSUMERS = 1, BAR_WG = 2 };
enum { KIND_FWD = 0, KIND_LAST = 1, KIND_BWD = 2 };

template <typename T>
struct Prec {
  static constexpr bool BF16 = sizeof(T) == 2;
};

template <typename T>
struct TiledArgs {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias
  // the products' B operands, per layer: bf16 swizzled 64-deep K-slabs
  // ((H / 64, H, 64), pack_slabs); float32 row-major (K, N)
  const T* w_bwd;       // the backward's: bf16 slabs of W_j, float32 W_j^T
  const T* w_fwd;       // the forward's: bf16 slabs of W_j^T, float32 W_j
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
  float* sc_keep;       // (max(n_mm, 1), B * P, H) kept values of layers 1..n_mm-1, then the
                        // last layer's pre-activation
  T* sc_dz;             // (n_mm, B * P, H) cotangents dz_j of the products' outputs
  float* sc_o;          // (n_cb, B * P, C_PAD) the column blocks' partial final layer
  float* sc_g;          // (B * P, C_PAD) the output cotangent a step forms
  int batch, P, H, n_mm, tiles_per_cta, n_chunks, n_cb, act, wgrad;
  float omega0, omega_h, gscale2;
  int j;                // the product this pass runs; -1: the last pass of a one-layer FiLM trunk
};

// 64-column blocks of a bf16 product's column block: the largest of 4, 3, 2
// that divides H / 64, else 1 (kernels/siren_step.py::block_cols mirrors it)
__host__ __device__ inline int block_nb(int H) {
  const int n = H / 64;
  return n % 4 == 0 ? 4 : n % 3 == 0 ? 3 : n % 2 == 0 ? 2 : 1;
}
__host__ __device__ inline int block_cols(int H, bool bf) { return bf ? 64 * block_nb(H) : FBN; }
__host__ __device__ inline int col_blocks(int H, bool bf) {
  const int bc = block_cols(H, bf);
  return (H + bc - 1) / bc;
}

// Shared memory of a product CTA (byte offsets from a 1024-aligned base).
// kernels/siren_step.py mirrors it in tiled_smem_bytes.
struct ProductLayout {
  size_t ring, stage, a_bytes, aux, vec, blk, dt, bars, total;
};

__host__ __device__ inline ProductLayout product_layout(int bn, bool bf) {
  ProductLayout L;
  L.a_bytes = bf ? (size_t)ROWS * BK * 2 : (size_t)ROWS * FLDA * 4;  // one slab of the input rows
  L.stage = L.a_bytes + (bf ? (size_t)bn * BK * 2 : (size_t)FBK * FBN * 4);  // and of the weights
  size_t off = 0;
  L.ring = off;  // STAGES x (input slab, weight slab)
  off += STAGES * L.stage;
  L.aux = off;   // dz0 of a tile (ROWS, bn) in the trunk's dtype; the warps' column sums
  const size_t dz0 = (size_t)ROWS * bn * (bf ? 2 : 4), red = (size_t)(bf ? 8 : 8) * bn * 4;
  off += align128(dz0 > red ? dz0 : red);
  L.vec = off;   // the block's bias, frequency, phase
  off += align128((size_t)3 * bn * 4);
  L.blk = off;   // the block's first-layer weight (K_PAD, bn) or final weight (bn, C_PAD)
  off += align128((size_t)K_PAD * bn * 4);
  L.dt = off;    // directions of the tile, (ROWS, K_PAD)
  off += align128((size_t)ROWS * K_PAD * 4);
  L.bars = off;  // full and empty barrier of each stage
  off += align128((size_t)2 * STAGES * 8);
  L.total = off + 1024;  // slack to align the base to the swizzle atom
  return L;
}

// Shared memory of an elementwise CTA (tiled_layer0, tiled_head, tiled_last_bwd)
struct ElemLayout {
  size_t dt, st, red, o, g, total;
};

__host__ __device__ inline ElemLayout elem_layout() {
  ElemLayout L;
  size_t off = 0;
  L.dt = off;    // directions of the tile, (EBM, K_PAD)
  off += align128((size_t)EBM * K_PAD * 4);
  L.st = off;    // the tile's activations of a 64-column sub-block, (EBM, STP)
  off += align128((size_t)EBM * STP * 4);
  L.red = off;   // the four row phases' column sums, (4, NQ, 64); the head's (32, 2 C_PAD)
  off += align128((size_t)4 * NQ * 64 * 4);
  L.o = off;     // the tile's partial final layer, (EBM, C_PAD)
  off += align128((size_t)EBM * C_PAD * 4);
  L.g = off;     // the tile's g rounded as the products take it, (EBM, C_PAD)
  off += align128((size_t)EBM * C_PAD * 4);
  L.total = off + 128;
  return L;
}

// The largest CTA of any tiled kernel at width H (reni_tiled_smem_bytes).
__host__ __device__ inline size_t tiled_smem(int H, bool bf) {
  const size_t p = product_layout(block_cols(H, bf), bf).total, e = elem_layout().total;
  return p > e ? p : e;
}

// The exact sine and cosine as calls: inlined at each of their sites they
// made every tiled kernel several times larger and its build minutes long.
// The fast mode stays inline.
static __device__ __noinline__ float exact_sin(float x) { return sinf(x); }
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
// the per-element arithmetic of the passes (both products and the
// elementwise kernels)
// ---------------------------------------------------------------------------

// a hidden layer's activation and kept value (Cond-by-Concat the cos factor,
// FiLM the pre-modulation value) from its pre-activation x + bias
template <bool FILM, int SN>
__device__ __forceinline__ float fwd_act(float pre, float f, float p, float om, float* kept) {
  float s;
  if constexpr (FILM) {
    *kept = pre;
    s = tsin<SN>(__fadd_rn(__fmul_rn(f, pre), p));
  } else {
    tsincos<SN>(om * pre, &s, kept);
  }
  return s;
}

// the last layer's activation s and derivative factor from its stored
// pre-activation: Cond-by-Concat omega cos, FiLM cos (times dh gives dm)
template <bool FILM, int SN>
__device__ __forceinline__ float last_act(float pre, float f, float p, float om, float* dfac) {
  float s, c;
  if constexpr (FILM) {
    tsincos<SN>(__fadd_rn(__fmul_rn(f, pre), p), &s, &c);
    *dfac = c;
  } else {
    tsincos<SN>(om * pre, &s, &c);
    *dfac = __fmul_rn(om, c);
  }
  return s;
}

// one element of a layer's backward epilogue: dz from dh and the kept value
// kv (Cond-by-Concat cos factor, FiLM pre-modulation value); q[0..2] the
// column sums (FiLM dm kv, dm, dz; Cond-by-Concat dz)
template <bool FILM, int SN>
__device__ __forceinline__ float bwd_elem(float dh, float kv, float f, float p, float om,
                                          float (&q)[3]) {
  if constexpr (FILM) {
    float s, c;
    tsincos<SN>(__fadd_rn(__fmul_rn(f, kv), p), &s, &c);
    const float dm = __fmul_rn(dh, c), dz = __fmul_rn(dm, f);
    q[0] = __fmul_rn(dm, kv);
    q[1] = dm;
    q[2] = dz;
    return dz;
  } else {
    const float dz = __fmul_rn(dh, __fmul_rn(om, kv));
    q[0] = dz;
    q[1] = q[2] = 0.0f;
    return dz;
  }
}

// the kept value of layer 0 at one element, formed again from the tile's
// directions `dr` (8, rounded) and the column's rounded first-layer weight
template <bool FILM, int SN>
__device__ __forceinline__ float layer0_kept(const float* dr, const float* ac, int acs, float bias,
                                             float om0) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < K_PAD; ++k) x = fmaf(dr[k], ac[k * acs], x);
  x += bias;
  if constexpr (FILM) return x;
  float s, c;
  tsincos<SN>(om0 * x, &s, &c);
  return c;
}

// where the column sums of a backward product pass go (device memory, the
// CTA's slot at its block's first column), null where none are formed
struct SumDst {
  float* q[3];
};

template <typename T, bool FILM>
__device__ __forceinline__ SumDst bwd_sum_dst(const TiledArgs<T>& g, int b, int chunk, int c0) {
  const int H = g.H, j = g.j, n_mm = g.n_mm, T_ = n_mm + 1;
  const int n_img = reni_step::image_values(FILM, H, n_mm);
  const int n_w = reni_step::weight_values(FILM, H, n_mm);
  float* img = g.part_img + ((size_t)b * g.n_chunks + chunk) * n_img + c0;
  float* w = g.part_w + ((size_t)b * g.n_chunks + chunk) * n_w + c0;
  SumDst s{{nullptr, nullptr, nullptr}};
  if constexpr (FILM) {
    s.q[0] = img + (size_t)(K_PAD + j) * H;
    s.q[1] = img + (size_t)(K_PAD + T_ + j) * H;
    if (g.wgrad) s.q[2] = w + C_PAD + (size_t)j * H;
  } else if (j > 0) {
    if (g.wgrad) s.q[0] = w + C_PAD + (size_t)(j - 1) * H;
  } else {
    s.q[0] = img + (size_t)K_PAD * H;  // db0
  }
  return s;
}

// ---------------------------------------------------------------------------
// rows of a CTA
// ---------------------------------------------------------------------------

struct Cta {
  int b, chunk, cb, begin, end;  // image, chunk, column block, rows [begin, end) of the image
};

__device__ __forceinline__ Cta cta_of(int tiles_per_cta, int n_chunks, int n_cb, int P) {
  const int per = n_chunks * n_cb, item = cta_item(per);
  Cta c;
  c.b = cta_image(per);
  c.chunk = item / n_cb;
  c.cb = item % n_cb;
  c.begin = c.chunk * tiles_per_cta * CTA_ROWS;
  c.end = min(P, (c.chunk + 1) * tiles_per_cta * CTA_ROWS);
  return c;
}

// ---------------------------------------------------------------------------
// the bf16 product: wgmma over a ring of K-slabs
// ---------------------------------------------------------------------------

// column sums in registers (step_passes.cuh's ColSums for a block of NB x
// 64 columns): lane group lane / 4 keeps the columns idx with idx % 8 equal
// to it, summed over the warp's 16 rows of every tile
template <int NB>
struct ColSums {
  float v[NB * 2];
};

// v[e] (this thread's sum of column 8 grp + e over its rows) summed over
// the warp's eight lane groups into cs.v[grp] of lane group e: a
// transposing butterfly, each step keeping the half of the columns whose
// index bit matches the lane group's and sending the other half (7
// shuffles for 8 columns)
template <int NB>
__device__ __forceinline__ void col_add8(ColSums<NB>& cs, int grp, float (&v)[8]) {
  const int lg = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int s = 2; s >= 0; --s) {
    const int half = 1 << s;
    const bool hi = (lg >> s) & 1;
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = hi ? v[e] : v[e + half], keep = hi ? v[e + half] : v[e];
      v[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << s);
    }
  }
  cs.v[grp] += v[0];
}

// dst[c] = the CTA's sum of column c of its block (the consumers only)
template <int NB>
__device__ __forceinline__ void flush_cols(const ColSums<NB>& cs, float* red, float* dst,
                                           int width) {
  constexpr int BN = 64 * NB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int idx = 0; idx < NB * 16; ++idx)
    if ((idx & 7) == lane / 4)
      red[warp * BN + (idx >> 4) * 64 + ((idx & 15) >> 1) * 8 + (lane % 4) * 2 + (idx & 1)] =
          cs.v[idx >> 3];
  bar_sync(BAR_CONSUMERS, CONSUMERS);
  for (int c = threadIdx.x; c < width; c += CONSUMERS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < CONSUMERS / 32; ++w) s += red[w * BN + c];
    dst[c] = s;
  }
  bar_sync(BAR_CONSUMERS, CONSUMERS);
}

// this warpgroup's 64 rows of K-slab kb of the input (row-major bf16, pitch
// H) into a swizzled stage, rows at or past `valid` zero-filled; one
// cp.async group
__device__ __forceinline__ void load_a_slab(bf16* dst, const bf16* src, int valid, int H, int kb) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = t + 128 * i, r = wg * 64 + e / 8, ch = e % 8;
    const bool in = r < valid;
    cp_async16(dst + r * 64 + ((ch ^ (r & 7)) << 3),
               src + (size_t)(in ? r : 0) * H + kb * BK + ch * 8, in);
  }
}

template <typename T, bool FILM, int SN, int NB, int KIND>
__global__ void __launch_bounds__(PTT, 1) tiled_product_bf16(TiledArgs<T> g) {
  constexpr int BN = 64 * NB, NV = NB * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const ProductLayout lay = product_layout(BN, true);
  const int H = g.H, j = g.j, nk = H / BK, tid = threadIdx.x;
  const Cta cta = cta_of(g.tiles_per_cta, g.n_chunks, g.n_cb, g.P);
  const int b = cta.b, c0 = cta.cb * BN;
  const size_t rows = (size_t)g.batch * g.P;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + STAGES;
  const int n_tiles = (cta.end - cta.begin + ROWS - 1) / ROWS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bf16* wsl = (KIND == KIND_BWD ? g.w_bwd : g.w_fwd) + (size_t)j * H * H + (size_t)c0 * 64;
  if (tid >= CONSUMERS) {  // the producer: one thread issues the block's slab copies in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const uint32_t bytes = (uint32_t)BN * BK * 2;
      uint32_t m = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int kb = 0; kb < nk; ++kb, ++m) {
          const uint32_t slot = m % STAGES;
          if (m >= (uint32_t)STAGES) mbar_wait(empty + slot, ((m / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + slot, bytes);
          bulk_load(smem + lay.ring + slot * lay.stage + lay.a_bytes, wsl + (size_t)kb * H * 64,
                    bytes, full + slot);
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = tid / 128, lane = tid % 32;
  const int layer = KIND == KIND_BWD ? j : j + 1;  // the layer whose epilogue this pass runs
  const size_t imgv = ((size_t)b * (g.n_mm + 1) + layer) * H + c0;
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  float* blk = reinterpret_cast<float*>(smem + lay.blk);
  float* dt = reinterpret_cast<float*>(smem + lay.dt);
  // the block's vectors: bias (FiLM bs of the layer, Cond-by-Concat bs_j /
  // b0 at layer 0), FiLM frequency and phase; the first-layer weight rounded
  // (a backward at j = 0) or the final weight (the last pass)
  const float* bias = KIND == KIND_BWD && j == 0
                          ? (FILM ? g.bs : g.b0 + (size_t)b * H)
                          : g.bs + (size_t)(FILM ? layer : layer - 1) * H;
  for (int c = tid; c < BN; c += CONSUMERS) {
    vec[c] = bias[c0 + c];
    vec[BN + c] = FILM ? g.fr[imgv + c] : 0.0f;
    vec[2 * BN + c] = FILM ? g.ph[imgv + c] : 0.0f;
  }
  if (KIND == KIND_BWD && j == 0) {
    for (int i = tid; i < K_PAD * BN; i += CONSUMERS)
      blk[i] = rnd<true>(g.a[((size_t)b * K_PAD + i / BN) * H + c0 + i % BN]);
  } else if (KIND == KIND_LAST) {
    for (int i = tid; i < BN * C_PAD; i += CONSUMERS)
      blk[i] = get(g.wf[(size_t)(c0 + i / C_PAD) * C_PAD + i % C_PAD]);
  }
  const T* a_in = (KIND == KIND_BWD ? g.sc_dz : g.sc_h) + (size_t)j * rows * H;
  const float* d = g.d + b * g.d_bstride;
  auto stage_a = [&](int m) {
    return reinterpret_cast<bf16*>(smem + lay.ring + (m % STAGES) * lay.stage);
  };
  auto prefetch = [&](int t, uint32_t m0) {  // slabs 0 .. STAGES - 2 of tile t
    const int p0 = cta.begin + t * ROWS, valid = min(ROWS, cta.end - p0);
    const bf16* src = a_in + ((size_t)b * g.P + p0) * H;
#pragma unroll
    for (int kb = 0; kb < STAGES - 1; ++kb) {
      if (kb < nk) load_a_slab(stage_a(m0 + kb), src, valid, H, kb);
      cp_async_commit();
    }
  };

  ColSums<NB> cs[3];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < NB * 2; ++i) cs[q].v[i] = 0.0f;
  float da[K_PAD] = {};
  T* st0 = reinterpret_cast<T*>(smem + lay.aux);  // dz0 of the tile (ROWS, BN), j = 0
  float acc[NV];
  uint32_t m = 0;
  if (n_tiles > 0) prefetch(0, 0);
  bar_sync(BAR_CONSUMERS, CONSUMERS);  // the block's vectors
  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = cta.begin + t * ROWS, valid = min(ROWS, cta.end - p0);
    const size_t row0 = (size_t)b * g.P + p0;
    const bf16* src = a_in + row0 * H;
    if (KIND == KIND_BWD && j == 0) {  // the tile's directions, rounded
      for (int i = tid; i < ROWS * K_PAD; i += CONSUMERS) {
        const int r = i / K_PAD;
        dt[i] = r < valid ? rnd<true>(d[(size_t)(p0 + r) * K_PAD + i % K_PAD]) : 0.0f;
      }
    }
    // the product over the K-slabs
    for (int kb = 0; kb < nk; ++kb) {
      const uint32_t mm = m + kb, slot = mm % STAGES;
      cp_async_wait<STAGES - 2>();
      fence_async_smem();
      bar_sync(BAR_WG + wg, 128);
      mbar_wait(full + slot, (mm / STAGES) & 1);
      const bf16* sa = stage_a(mm) + wg * 64 * 64;
      const bf16* sb = reinterpret_cast<const bf16*>(smem + lay.ring + slot * lay.stage + lay.a_bytes);
      fence_regs<NV>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_bf16<BN>(acc, gmma_desc(sa + ks * 16), gmma_desc(sb + ks * 16), kb | ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kb > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs<NV>(acc);
        if (lane == 0) mbar_arrive(empty + (mm - 1) % STAGES);
      }
      // slab kb + STAGES - 1 into the stage the products of kb - 1 freed
      if (kb + STAGES - 1 < nk) load_a_slab(stage_a(mm + STAGES - 1), src, valid, H, kb + STAGES - 1);
      cp_async_commit();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<NV>(acc);
    if (lane == 0) mbar_arrive(empty + (m + nk - 1) % STAGES);
    m += nk;
    cp_async_wait<0>();
    if (t + 1 < n_tiles) prefetch(t + 1, m);  // under this tile's epilogue

    // the epilogue, from the accumulators
    if constexpr (KIND == KIND_FWD) {
      T* h_out = g.sc_h + (size_t)(j + 1) * rows * H;
      float* keep_out = g.sc_keep + (size_t)j * rows * H;
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int r = acc_row(i & 31), c = acc_col(i >> 5, i & 31);
        if (r >= valid) continue;
        float s[2], kept[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[e] = fwd_act<FILM, SN>(acc[i + e] + vec[c + e], vec[BN + c + e], vec[2 * BN + c + e],
                                   g.omega_h, &kept[e]);
        const size_t o = (row0 + r) * H + c0 + c;
        *reinterpret_cast<__nv_bfloat162*>(h_out + o) = __floats2bfloat162_rn(s[0], s[1]);
        *reinterpret_cast<float2*>(keep_out + o) = make_float2(kept[0], kept[1]);
      }
    } else if constexpr (KIND == KIND_LAST) {
      float* keep_out = g.sc_keep + (size_t)j * rows * H;
      const bool want_o = g.gin == nullptr;
      float o[2][C_PAD] = {};
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int r = acc_row(i & 31), c = acc_col(i >> 5, i & 31), half = (i >> 1) & 1;
        float pre[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) pre[e] = acc[i + e] + vec[c + e];
        if (r < valid)
          *reinterpret_cast<float2*>(keep_out + (row0 + r) * H + c0 + c) = make_float2(pre[0], pre[1]);
        if (want_o) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float dfac;
            const float s = rnd<true>(last_act<FILM, SN>(pre[e], vec[BN + c + e],
                                                          vec[2 * BN + c + e], g.omega_h, &dfac));
#pragma unroll
            for (int k = 0; k < C_PAD; ++k)
              o[half][k] = fmaf(s, blk[(c + e) * C_PAD + k], o[half][k]);
          }
        }
      }
      if (want_o) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int k = 0; k < C_PAD; ++k) {
            o[half][k] += __shfl_xor_sync(0xffffffffu, o[half][k], 1);
            o[half][k] += __shfl_xor_sync(0xffffffffu, o[half][k], 2);
          }
        const int q = lane % 4, r = acc_row(0) + (q >> 1) * 8, k0 = (q & 1) * 4;
        if (r < valid) {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = (q >> 1) ? ((q & 1) ? o[1][4 + k] : o[1][k]) : ((q & 1) ? o[0][4 + k] : o[0][k]);
          *reinterpret_cast<float4*>(g.sc_o + ((size_t)cta.cb * rows + row0 + r) * C_PAD + k0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {  // KIND_BWD
      const float* keep = j > 0 ? g.sc_keep + (size_t)(j - 1) * rows * H : nullptr;
      T* dz_out = j > 0 ? g.sc_dz + (size_t)(j - 1) * rows * H : nullptr;
      const float om = j > 0 ? g.omega_h : g.omega0;
      if (j == 0) bar_sync(BAR_CONSUMERS, CONSUMERS);  // the directions
      // 8 columns at a time (grp: elements i0 = 16 grp + 4 m, m = 0..3, of
      // rows r and r + 8, columns 8 grp + 2 m + e), their kept values
      // loaded first so that the loads are in flight together
#pragma unroll
      for (int grp = 0; grp < NB * 2; ++grp) {
        float kv[16];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int i = 16 * grp + 2 * m, r = acc_row(i & 31), c = acc_col(i >> 5, i & 31);
          if (j > 0) {
            const float2 k2 = r < valid
                                  ? *reinterpret_cast<const float2*>(keep + (row0 + r) * H + c0 + c)
                                  : make_float2(0.0f, 0.0f);
            kv[2 * m] = k2.x;
            kv[2 * m + 1] = k2.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              kv[2 * m + e] = layer0_kept<FILM, SN>(dt + r * K_PAD, blk + c + e, BN, vec[c + e], om);
          }
        }
        float qs[3][8] = {};
#pragma unroll
        for (int m = 0; m < 8; ++m) {  // i = 16 grp + 2 m: rows r (m even) and r + 8 (m odd)
          const int i = 16 * grp + 2 * m, r = acc_row(i & 31), c = acc_col(i >> 5, i & 31);
          const bool in = r < valid;
          float dz[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float q[3];
            dz[e] = bwd_elem<FILM, SN>(acc[i + e], kv[2 * m + e], vec[BN + c + e],
                                       vec[2 * BN + c + e], om, q);
            if (!in) dz[e] = q[0] = q[1] = q[2] = 0.0f;
#pragma unroll
            for (int qq = 0; qq < 3; ++qq) qs[qq][(m >> 1) * 2 + e] += q[qq];
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(dz[0], dz[1]);
          if (j > 0) {
            if (in) *reinterpret_cast<__nv_bfloat162*>(dz_out + (row0 + r) * H + c0 + c) = v;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(st0 + r * BN + c) = v;
          }
        }
        col_add8(cs[0], grp, qs[0]);
        if (FILM) {
          col_add8(cs[1], grp, qs[1]);
          col_add8(cs[2], grp, qs[2]);
        }
      }
      if (j == 0) {  // dA: d^T dz0 over the tile, a thread per column
        bar_sync(BAR_CONSUMERS, CONSUMERS);
        if (tid < BN) {
          for (int r = 0; r < ROWS; ++r) {
            const float z = get(st0[r * BN + tid]);
#pragma unroll
            for (int k = 0; k < K_PAD; ++k) da[k] = fmaf(dt[r * K_PAD + k], z, da[k]);
          }
        }
        bar_sync(BAR_CONSUMERS, CONSUMERS);
      }
    }
  }

  if constexpr (KIND == KIND_BWD) {
    float* red = reinterpret_cast<float*>(smem + lay.aux);
    const SumDst dst = bwd_sum_dst<T, FILM>(g, b, cta.chunk, c0);
    const int width = min(BN, H - c0);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (dst.q[q] != nullptr) flush_cols(cs[q], red, dst.q[q], width);
    if (j == 0 && tid < BN) {
      const int n_img = reni_step::image_values(FILM, H, g.n_mm);
      float* img = g.part_img + ((size_t)b * g.n_chunks + cta.chunk) * n_img + c0 + tid;
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) img[(size_t)k * H] = da[k];
    }
  }
}

// ---------------------------------------------------------------------------
// the float32 product: register-tiled FFMA over a ring of K-slabs
// ---------------------------------------------------------------------------

// K-slab kb of the tile: the input rows (ROWS, FBK) at pitch FLDA and the
// weight rows (FBK, FBN) of the block (columns at or past H zero-filled);
// one cp.async group
__device__ __forceinline__ void load_f32_slab(float* sa, float* sb, const float* a, int valid,
                                              const float* w, int c0, int H, int kb) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 128 rows x 4 chunks
    const int e = tid + FT * i, r = e / 4, ch = e % 4;
    const bool in = r < valid;
    cp_async16(sa + r * FLDA + ch * 4, a + (size_t)(in ? r : 0) * H + kb * FBK + ch * 4, in);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 16 rows x 16 chunks
    const int e = tid + FT * i, k = e / 16, ch = e % 16;
    const bool in = c0 + ch * 4 < H;
    cp_async16(sb + k * FBN + ch * 4, w + (size_t)(kb * FBK + k) * H + (in ? c0 + ch * 4 : 0), in);
  }
}

// acc (rows ty + 16 i, columns tx * 4 + e and 32 + tx * 4 + e) += the slab's product
__device__ __forceinline__ void f32_slab(float (&acc)[8][8], const float* sa, const float* sb) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int k4 = 0; k4 < FBK; k4 += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * FLDA + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(sb + (k4 + kk) * FBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + (k4 + kk) * FBN + 32 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(x, bv[e], acc[i][e]);
      }
    }
  }
}

__device__ __forceinline__ int f32_col(int e) { return (e >> 2) * 32 + (threadIdx.x % 8) * 4 + (e & 3); }

template <typename T, bool FILM, int SN, int KIND>
__global__ void __launch_bounds__(FT, 2) tiled_product_f32(TiledArgs<T> g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const ProductLayout lay = product_layout(FBN, false);
  const int H = g.H, j = g.j, nk = H / FBK, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 8, ty = tid / 8;
  const Cta cta = cta_of(g.tiles_per_cta, g.n_chunks, g.n_cb, g.P);
  const int b = cta.b, c0 = cta.cb * FBN, width = min(FBN, H - c0);
  const size_t rows = (size_t)g.batch * g.P;
  const int layer = KIND == KIND_BWD ? j : j + 1;
  const size_t imgv = ((size_t)b * (g.n_mm + 1) + layer) * H + c0;
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  float* blk = reinterpret_cast<float*>(smem + lay.blk);
  float* dt = reinterpret_cast<float*>(smem + lay.dt);
  const float* bias = KIND == KIND_BWD && j == 0
                          ? (FILM ? g.bs : g.b0 + (size_t)b * H)
                          : g.bs + (size_t)(FILM ? layer : layer - 1) * H;
  for (int c = tid; c < FBN; c += FT) {
    const bool in = c < width;
    vec[c] = in ? bias[c0 + c] : 0.0f;
    vec[FBN + c] = FILM && in ? g.fr[imgv + c] : 0.0f;
    vec[2 * FBN + c] = FILM && in ? g.ph[imgv + c] : 0.0f;
  }
  if (KIND == KIND_BWD && j == 0) {
    for (int i = tid; i < K_PAD * FBN; i += FT)
      blk[i] = i % FBN < width ? g.a[((size_t)b * K_PAD + i / FBN) * H + c0 + i % FBN] : 0.0f;
  } else if (KIND == KIND_LAST) {
    for (int i = tid; i < FBN * C_PAD; i += FT)
      blk[i] = i / C_PAD < width ? g.wf[(size_t)(c0 + i / C_PAD) * C_PAD + i % C_PAD] : 0.0f;
  }
  const T* a_in = (KIND == KIND_BWD ? g.sc_dz : g.sc_h) + (size_t)j * rows * H;
  const T* w = (KIND == KIND_BWD ? g.w_bwd : g.w_fwd) + (size_t)j * H * H;
  const float* d = g.d + b * g.d_bstride;
  auto sa = [&](int kb) { return reinterpret_cast<float*>(smem + lay.ring + (kb % STAGES) * lay.stage); };
  auto sb = [&](int kb) {
    return reinterpret_cast<float*>(smem + lay.ring + (kb % STAGES) * lay.stage + lay.a_bytes);
  };
  float cs[3][8] = {};
  float da[K_PAD] = {};
  T* st0 = reinterpret_cast<T*>(smem + lay.aux);
  const int n_tiles = (cta.end - cta.begin + ROWS - 1) / ROWS;
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = cta.begin + t * ROWS, valid = min(ROWS, cta.end - p0);
    const size_t row0 = (size_t)b * g.P + p0;
    const T* src = a_in + row0 * H;
    if (KIND == KIND_BWD && j == 0) {
      for (int i = tid; i < ROWS * K_PAD; i += FT) {
        const int r = i / K_PAD;
        dt[i] = r < valid ? d[(size_t)(p0 + r) * K_PAD + i % K_PAD] : 0.0f;
      }
    }
    float acc[8][8] = {};
#pragma unroll
    for (int kb = 0; kb < STAGES - 1; ++kb) {
      if (kb < nk) load_f32_slab(sa(kb), sb(kb), src, valid, w, c0, H, kb);
      cp_async_commit();
    }
    for (int kb = 0; kb < nk; ++kb) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kb + STAGES - 1 < nk)
        load_f32_slab(sa(kb + STAGES - 1), sb(kb + STAGES - 1), src, valid, w, c0, H, kb + STAGES - 1);
      cp_async_commit();
      f32_slab(acc, sa(kb), sb(kb));
    }
    cp_async_wait<0>();
    __syncthreads();  // every slab is consumed: the next tile may refill the ring

    if constexpr (KIND == KIND_FWD) {
      T* h_out = g.sc_h + (size_t)(j + 1) * rows * H;
      float* keep_out = g.sc_keep + (size_t)j * rows * H;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        if (r >= valid) continue;
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const int c = f32_col(4 * h4);
          if (c >= width) continue;
          float s[4], kept[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[e] = fwd_act<FILM, SN>(acc[i][4 * h4 + e] + vec[c + e], vec[FBN + c + e],
                                     vec[2 * FBN + c + e], g.omega_h, &kept[e]);
          const size_t o = (row0 + r) * H + c0 + c;
          *reinterpret_cast<float4*>(h_out + o) = make_float4(s[0], s[1], s[2], s[3]);
          *reinterpret_cast<float4*>(keep_out + o) = make_float4(kept[0], kept[1], kept[2], kept[3]);
        }
      }
    } else if constexpr (KIND == KIND_LAST) {
      float* keep_out = g.sc_keep + (size_t)j * rows * H;
      const bool want_o = g.gin == nullptr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        float o[C_PAD] = {};
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const int c = f32_col(4 * h4);
          float pre[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) pre[e] = acc[i][4 * h4 + e] + vec[c + e];
          if (r < valid && c < width)
            *reinterpret_cast<float4*>(keep_out + (row0 + r) * H + c0 + c) =
                make_float4(pre[0], pre[1], pre[2], pre[3]);
          if (want_o) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float dfac;
              const float s = c < width ? last_act<FILM, SN>(pre[e], vec[FBN + c + e],
                                                             vec[2 * FBN + c + e], g.omega_h, &dfac)
                                        : 0.0f;
#pragma unroll
              for (int k = 0; k < C_PAD; ++k) o[k] = fmaf(s, blk[(c + e) * C_PAD + k], o[k]);
            }
          }
        }
        if (want_o) {
#pragma unroll
          for (int k = 0; k < C_PAD; ++k)
#pragma unroll
            for (int x = 1; x < 8; x <<= 1) o[k] += __shfl_xor_sync(0xffffffffu, o[k], x);
          if (tx == 0 && r < valid) {
            float* dst = g.sc_o + ((size_t)cta.cb * rows + row0 + r) * C_PAD;
            reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
          }
        }
      }
    } else {  // KIND_BWD
      const float* keep = j > 0 ? g.sc_keep + (size_t)(j - 1) * rows * H : nullptr;
      T* dz_out = j > 0 ? g.sc_dz + (size_t)(j - 1) * rows * H : nullptr;
      const float om = j > 0 ? g.omega_h : g.omega0;
      if (j == 0) __syncthreads();  // the directions
      float part[3][8] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        const bool row_in = r < valid;
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const int c = f32_col(4 * h4);
          const bool in = row_in && c < width;
          float kv[4], dz[4];
          if (j > 0) {
            const float4 k4 = in ? *reinterpret_cast<const float4*>(keep + (row0 + r) * H + c0 + c)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            kv[0] = k4.x, kv[1] = k4.y, kv[2] = k4.z, kv[3] = k4.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              kv[e] = layer0_kept<FILM, SN>(dt + r * K_PAD, blk + c + e, FBN, vec[c + e], om);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float q[3];
            dz[e] = bwd_elem<FILM, SN>(acc[i][4 * h4 + e], kv[e], vec[FBN + c + e],
                                       vec[2 * FBN + c + e], om, q);
            if (!in) dz[e] = q[0] = q[1] = q[2] = 0.0f;
#pragma unroll
            for (int qq = 0; qq < 3; ++qq) part[qq][4 * h4 + e] += q[qq];
          }
          if (j > 0) {
            if (in) *reinterpret_cast<float4*>(dz_out + (row0 + r) * H + c0 + c) = make_float4(dz[0], dz[1], dz[2], dz[3]);
          } else {
            *reinterpret_cast<float4*>(st0 + r * FBN + c) = make_float4(dz[0], dz[1], dz[2], dz[3]);
          }
        }
      }
#pragma unroll
      for (int qq = 0; qq < 3; ++qq)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = part[qq][e] + __shfl_xor_sync(0xffffffffu, part[qq][e], 8);
          cs[qq][e] += v + __shfl_xor_sync(0xffffffffu, v, 16);
        }
      if (j == 0) {  // dA: d^T dz0 over the tile, a thread per column
        __syncthreads();
        if (tid < FBN) {
          for (int r = 0; r < ROWS; ++r) {
            const float z = st0[r * FBN + tid];
#pragma unroll
            for (int k = 0; k < K_PAD; ++k) da[k] = fmaf(dt[r * K_PAD + k], z, da[k]);
          }
        }
        __syncthreads();
      }
    }
  }

  if constexpr (KIND == KIND_BWD) {
    float* red = reinterpret_cast<float*>(smem + lay.aux);
    const SumDst dst = bwd_sum_dst<T, FILM>(g, b, cta.chunk, c0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (dst.q[q] == nullptr) continue;
      if (lane < 8)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp * FBN + f32_col(e)] = cs[q][e];
      __syncthreads();
      for (int c = tid; c < width; c += FT) {
        float s = 0.0f;
#pragma unroll
        for (int w2 = 0; w2 < FT / 32; ++w2) s += red[w2 * FBN + c];
        dst.q[q][c] = s;
      }
      __syncthreads();
    }
    if (j == 0 && tid < width) {
      const int n_img = reni_step::image_values(FILM, H, g.n_mm);
      float* img = g.part_img + ((size_t)b * g.n_chunks + cta.chunk) * n_img + c0 + tid;
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) img[(size_t)k * H] = da[k];
    }
  }
}

// ---------------------------------------------------------------------------
// the elementwise kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ float* elem_part(unsigned char* raw, size_t off) {
  const uint32_t a = smem_addr(raw);
  return reinterpret_cast<float*>(raw + ((128 - (a & 127)) & 127) + off);
}

// the directions of an elementwise tile rounded as the products take them
template <bool BF>
__device__ __forceinline__ void load_dtile(const float* d, float* dt, int p0, int valid) {
  for (int i = threadIdx.x; i < EBM * K_PAD; i += ET) {
    const int r = i / K_PAD;
    dt[i] = r < valid ? rnd<BF>(d[(size_t)(p0 + r) * K_PAD + i % K_PAD]) : 0.0f;
  }
}

// Layer 0, a thread per column and four row phases over 64-row tiles of the
// CTA's rows and the 64-column sub-blocks of its block: h_0 into sc_h[0]
// (j >= 0); for a one-layer FiLM trunk (j = -1, the last pass) the
// pre-activation into sc_keep[0] and, but for a cotangent pass, the block's
// partial final layer into sc_o.
template <typename T, bool FILM, int SN>
__global__ void __launch_bounds__(ET) tiled_layer0(TiledArgs<T> g) {
  constexpr bool BF = Prec<T>::BF16;
  extern __shared__ unsigned char smem_raw[];
  const ElemLayout L = elem_layout();
  float* dt = elem_part(smem_raw, L.dt);
  float* st = elem_part(smem_raw, L.st);
  float* oa = elem_part(smem_raw, L.o);
  const int H = g.H, bc = block_cols(H, BF), tid = threadIdx.x, c_own = tid & 63, q = tid >> 6;
  const Cta cta = cta_of(g.tiles_per_cta, g.n_chunks, g.n_cb, g.P);
  const int b = cta.b, c0 = cta.cb * bc, c1 = min(H, c0 + bc);
  const size_t rows = (size_t)g.batch * g.P;
  const bool last = g.j < 0, want_o = last && g.gin == nullptr;
  const float* d = g.d + b * g.d_bstride;
  const float* a = g.a + (size_t)b * K_PAD * H;
  const size_t img = (size_t)b * (g.n_mm + 1) * H;
  for (int p0 = cta.begin; p0 < cta.end; p0 += EBM) {
    const int valid = min(EBM, cta.end - p0);
    const size_t row0 = (size_t)b * g.P + p0;
    load_dtile<BF>(d, dt, p0, valid);
    if (want_o)
      for (int i = tid; i < EBM * C_PAD; i += ET) oa[i] = 0.0f;
    __syncthreads();
    for (int s0 = c0; s0 < c1; s0 += 64) {
      const int c = s0 + c_own;
      const bool in = c < c1;
      float ac[K_PAD];
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) ac[k] = in ? rnd<BF>(__ldg(a + (size_t)k * H + c)) : 0.0f;
      const float bias = !in ? 0.0f : FILM ? __ldg(g.bs + c) : __ldg(g.b0 + (size_t)b * H + c);
      const float f = FILM && in ? __ldg(g.fr + img + c) : 0.0f;
      const float p = FILM && in ? __ldg(g.ph + img + c) : 0.0f;
      for (int r = q; r < EBM; r += 4) {
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < K_PAD; ++k) x = fmaf(dt[r * K_PAD + k], ac[k], x);
        x += bias;
        if (!last) {
          const float s = FILM ? tsin<SN>(__fadd_rn(__fmul_rn(f, x), p)) : tsin<SN>(g.omega0 * x);
          if (in && r < valid) put(g.sc_h + (row0 + r) * H + c, s);
        } else {
          if (in && r < valid) g.sc_keep[(row0 + r) * H + c] = x;
          if (want_o) {
            float dfac;
            st[r * STP + c_own] = in ? rnd<BF>(last_act<FILM, SN>(x, f, p, g.omega0, &dfac)) : 0.0f;
          }
        }
      }
      if (want_o) {  // the sub-block's columns in order into the tile's partial final layer
        __syncthreads();
        for (int i = tid; i < EBM * C_PAD; i += ET) {
          const int r = i / C_PAD, k = i % C_PAD;
          float s = 0.0f;
          for (int cc = 0; cc < 64 && s0 + cc < c1; ++cc)
            s = fmaf(st[r * STP + cc], get(g.wf[(size_t)(s0 + cc) * C_PAD + k]), s);
          oa[i] += s;
        }
        __syncthreads();
      }
    }
    if (want_o) {
      for (int i = tid; i < valid * C_PAD; i += ET)
        g.sc_o[((size_t)cta.cb * rows + row0) * C_PAD + i] = oa[i];
    }
    __syncthreads();
  }
}

// The final layer from the column blocks' partials (summed in block order)
// for the rows of one chunk: a step forms the loss and g (into sc_g) and
// the chunk's loss and dbf sums; a forward writes the output; a backward
// with weight gradients forms the dbf sums of g (its loss slot stays 0).
template <typename T, bool FILM, int MODE>
__global__ void __launch_bounds__(ET) tiled_head(TiledArgs<T> g) {
  extern __shared__ unsigned char smem_raw[];
  const ElemLayout L = elem_layout();
  float* red = elem_part(smem_raw, L.red);  // (32, 2 C_PAD)
  const int tid = threadIdx.x, k = tid % C_PAD, rp = tid / C_PAD;  // 32 row phases
  const int b = cta_image(g.n_chunks), chunk = cta_item(g.n_chunks);
  const int begin = chunk * g.tiles_per_cta * CTA_ROWS;
  const int end = min(g.P, (chunk + 1) * g.tiles_per_cta * CTA_ROWS);
  const size_t rows = (size_t)g.batch * g.P;
  float loss_s = 0.0f, g_s = 0.0f;
  for (int p = begin + rp; p < end; p += ET / C_PAD) {
    const size_t row = (size_t)b * g.P + p;
    if constexpr (MODE == reni_pass::LAST_COT) {
      g_s += g.gin[row * C_PAD + k];
      continue;
    }
    float o = 0.0f;
    for (int cb = 0; cb < g.n_cb; ++cb) o += g.sc_o[((size_t)cb * rows + row) * C_PAD + k];
    o += g.bf[k];
    if constexpr (MODE == reni_pass::LAST_OUT) {
      g.out[row * C_PAD + k] = o;
    } else {
      float dact;
      const float out = reni_pass::activate(g.act, o, &dact);
      const float res = __fsub_rn(out, g.tgt[row * C_PAD + k]);
      const float rs = __fmul_rn(res, __fmul_rn(g.sw[(size_t)p * C_PAD + k], g.bm[(size_t)b * C_PAD + k]));
      float gv = __fmul_rn(g.gscale2, rs);
      if (g.act != 0) gv = __fmul_rn(gv, dact);
      g.sc_g[row * C_PAD + k] = gv;
      loss_s += __fmul_rn(rs, res);
      g_s += gv;
    }
  }
  if (MODE == reni_pass::LAST_OUT || !g.wgrad) return;
  red[rp * 2 * C_PAD + k] = loss_s;
  red[rp * 2 * C_PAD + C_PAD + k] = g_s;
  __syncthreads();
  if (tid < 2 * C_PAD) {  // the row phases in order
    float s = 0.0f;
    for (int i = 0; i < ET / C_PAD; ++i) s += red[i * 2 * C_PAD + tid];
    const int H = g.H, n_mm = g.n_mm;
    float* part_w = g.part_w + ((size_t)b * g.n_chunks + chunk) * reni_step::weight_values(FILM, H, n_mm);
    if (tid < C_PAD) part_w[tid] = s;  // mse
    else part_w[C_PAD + (size_t)reni_step::bias_rows(FILM, n_mm) * H + H * C_PAD + tid - C_PAD] = s;
  }
}

// The last layer's backward, elementwise over the CTA's rows and the
// 64-column sub-blocks of its block: dh = g Wf^T from g (sc_g of a step, gin
// of a backward), the activation and its derivative from the stored
// pre-activation, dz to sc_dz[j] (j >= 0), its column sums (bias /
// modulation), dWf (with weight gradients) and, for a one-layer FiLM trunk,
// dA; the four row phases' sums added in order into the CTA's slot.
template <typename T, bool FILM, int SN>
__global__ void __launch_bounds__(ET) tiled_last_bwd(TiledArgs<T> g) {
  constexpr bool BF = Prec<T>::BF16;
  extern __shared__ unsigned char smem_raw[];
  const ElemLayout L = elem_layout();
  float* dt = elem_part(smem_raw, L.dt);
  float* red = elem_part(smem_raw, L.red);
  float* gt = elem_part(smem_raw, L.g);
  const int H = g.H, bc = block_cols(H, BF), tid = threadIdx.x, c_own = tid & 63, q = tid >> 6;
  const Cta cta = cta_of(g.tiles_per_cta, g.n_chunks, g.n_cb, g.P);
  const int b = cta.b, c0 = cta.cb * bc, c1 = min(H, c0 + bc), n_mm = g.n_mm, j = g.j;
  const bool first = j < 0, wgrad = g.wgrad != 0;
  const int layer = j + 1;  // FiLM's row of the last layer's vectors; Cond-by-Concat's bias row is j
  const size_t rows = (size_t)g.batch * g.P;
  const float* keep = g.sc_keep + (size_t)(first ? 0 : j) * rows * H;
  T* dz_out = first ? nullptr : g.sc_dz + (size_t)j * rows * H;
  const float* gsrc = g.gin != nullptr ? g.gin : g.sc_g;
  const size_t img = ((size_t)b * (n_mm + 1) + layer) * H;
  const float* d = g.d + b * g.d_bstride;
  const float om = first ? g.omega0 : g.omega_h;
  const int n_w = reni_step::weight_values(FILM, H, n_mm);
  const int n_img = reni_step::image_values(FILM, H, n_mm), T_ = n_mm + 1;
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + cta.chunk) * n_w;
  float* part_img = g.part_img + ((size_t)b * g.n_chunks + cta.chunk) * n_img;
  float* dwf_out = part_w + C_PAD + (size_t)reni_step::bias_rows(FILM, n_mm) * H;
  for (int s0 = c0; s0 < c1; s0 += 64) {
    const int c = s0 + c_own;
    const bool in = c < c1;
    float part[NQ] = {};
    float wfc[C_PAD];
#pragma unroll
    for (int k = 0; k < C_PAD; ++k) wfc[k] = in ? get(g.wf[(size_t)c * C_PAD + k]) : 0.0f;
    const float f = FILM && in ? __ldg(g.fr + img + c) : 0.0f;
    const float p = FILM && in ? __ldg(g.ph + img + c) : 0.0f;
    for (int p0 = cta.begin; p0 < cta.end; p0 += EBM) {
      const int valid = min(EBM, cta.end - p0);
      const size_t row0 = (size_t)b * g.P + p0;
      __syncthreads();  // the previous tile's g and directions are read
      for (int i = tid; i < EBM * C_PAD; i += ET)
        gt[i] = i / C_PAD < valid ? rnd<BF>(gsrc[row0 * C_PAD + i]) : 0.0f;
      if (first) load_dtile<BF>(d, dt, p0, valid);
      __syncthreads();
      if (!in) continue;
      for (int r = q; r < valid; r += 4) {
        const float pre = keep[(row0 + r) * H + c];
        float dfac;
        const float s = last_act<FILM, SN>(pre, f, p, om, &dfac);
        float dh = 0.0f;
#pragma unroll
        for (int k = 0; k < C_PAD; ++k) dh = fmaf(gt[r * C_PAD + k], wfc[k], dh);
        float dz;
        if constexpr (FILM) {
          const float dm = __fmul_rn(dh, dfac);
          dz = __fmul_rn(dm, f);
          part[0] += __fmul_rn(dm, pre);
          part[1] += dm;
          part[2] += dz;
        } else {
          dz = __fmul_rn(dh, dfac);
          part[0] += dz;
        }
        if (!first) put(dz_out + (row0 + r) * H + c, dz);
        if (wgrad) {
          const float sr = rnd<BF>(s);  // dWf takes the stored activation
#pragma unroll
          for (int k = 0; k < C_PAD; ++k) part[Q_DWF + k] = fmaf(sr, gt[r * C_PAD + k], part[Q_DWF + k]);
        }
        if (first) {
          const float zq = rnd<BF>(dz);
#pragma unroll
          for (int k = 0; k < K_PAD; ++k) part[Q_DA + k] = fmaf(dt[r * K_PAD + k], zq, part[Q_DA + k]);
        }
      }
    }
    // the four row phases in order, into the slot
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NQ; ++i) red[(q * NQ + i) * 64 + c_own] = part[i];
    __syncthreads();
    for (int i = tid; i < NQ * 64; i += ET) {
      const int qq = i / 64, cc = s0 + i % 64;
      if (cc >= c1) continue;
      const float s = ((red[qq * 64 + i % 64] + red[(NQ + qq) * 64 + i % 64]) +
                       red[(2 * NQ + qq) * 64 + i % 64]) + red[(3 * NQ + qq) * 64 + i % 64];
      if (qq < Q_DWF) {
        if constexpr (FILM) {
          if (qq == 0) part_img[(size_t)(K_PAD + layer) * H + cc] = s;
          if (qq == 1) part_img[(size_t)(K_PAD + T_ + layer) * H + cc] = s;
          if (qq == 2 && wgrad) part_w[C_PAD + (size_t)layer * H + cc] = s;
        } else if (qq == 0 && wgrad) {
          part_w[C_PAD + (size_t)j * H + cc] = s;
        }
      } else if (qq < Q_DA) {
        if (wgrad) dwf_out[(size_t)cc * C_PAD + qq - Q_DWF] = s;
      } else if (first) {
        part_img[(size_t)(qq - Q_DA) * H + cc] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
using TiledFn = void (*)(TiledArgs<T>);

template <typename T>
inline cudaError_t launch_one(TiledFn<T> fn, const TiledArgs<T>& g, unsigned grid, int threads,
                              size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, threads, smem, s>>>(g);
  return cudaGetLastError();
}

// the product kernel of pass kind KIND for this width
template <typename T, bool FILM, int SN, int KIND>
inline TiledFn<T> product_kernel(int H) {
  if constexpr (Prec<T>::BF16) {
    switch (block_nb(H)) {
      case 4: return tiled_product_bf16<T, FILM, SN, 4, KIND>;
      case 3: return tiled_product_bf16<T, FILM, SN, 3, KIND>;
      case 2: return tiled_product_bf16<T, FILM, SN, 2, KIND>;
      default: return tiled_product_bf16<T, FILM, SN, 1, KIND>;
    }
  } else {
    return tiled_product_f32<T, FILM, SN, KIND>;
  }
}

template <typename T, bool FILM, int SN>
inline cudaError_t launch_product(int kind, const TiledArgs<T>& g, unsigned grid, cudaStream_t s) {
  constexpr bool BF = Prec<T>::BF16;
  const TiledFn<T> fn = kind == KIND_FWD    ? product_kernel<T, FILM, SN, KIND_FWD>(g.H)
                        : kind == KIND_LAST ? product_kernel<T, FILM, SN, KIND_LAST>(g.H)
                                            : product_kernel<T, FILM, SN, KIND_BWD>(g.H);
  return launch_one(fn, g, grid, BF ? PTT : FT, product_layout(block_cols(g.H, BF), BF).total, s);
}

// Passes [lo, hi) of a step, a backward (gin set) or a forward (out set)
// with the sine mode SN, then what `finish` (reni_pass::FINISH_*) asks for.
// The passes: products 0..n_mm-2 forward, the last pass, then the backward
// from n_mm-1 down to 0 (2 n_mm passes); a one-layer FiLM trunk has the
// last pass alone. Pass 0 starts with layer 0 (tiled_layer0); the last pass
// is its product, tiled_head and (but in the output mode) tiled_last_bwd.
// Returns a cudaError_t.
template <typename T, bool FILM, int SN>
int launch_tiled(TiledArgs<T> g, const reni_step::Sums& o, int batch, int lo, int hi,
                 int finish, cudaStream_t s) {
  constexpr bool BF = Prec<T>::BF16;
  const int n_mm = g.n_mm, n_pass = n_mm > 0 ? 2 * n_mm : 1, k_last = n_mm > 0 ? n_mm - 1 : 0;
  const int mode = g.gin != nullptr ? reni_pass::LAST_COT
                   : g.out != nullptr ? reni_pass::LAST_OUT : reni_pass::LAST_STEP;
  const unsigned grid = image_grid((long long)g.n_chunks * g.n_cb, batch);
  const unsigned hgrid = image_grid(g.n_chunks, batch);
  const size_t esmem = elem_layout().total;
  if (grid == 0 || (BF && g.H % 64) || (!BF && g.H % FBK) || g.n_cb != col_blocks(g.H, BF))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int k = lo; k < hi && k < n_pass; ++k) {
    if (k == 0 && n_mm > 0) {  // h_0 for product 0
      g.j = 0;
      err = launch_one(tiled_layer0<T, FILM, SN>, g, grid, ET, esmem, s);
      if (err != cudaSuccess) return (int)err;
    }
    if (k < k_last) {
      g.j = k;
      err = launch_product<T, FILM, SN>(KIND_FWD, g, grid, s);
    } else if (k == k_last) {
      g.j = n_mm - 1;
      err = n_mm > 0 ? launch_product<T, FILM, SN>(KIND_LAST, g, grid, s)
                     : launch_one(tiled_layer0<T, FILM, SN>, g, grid, ET, esmem, s);
      if (err != cudaSuccess) return (int)err;
      if (mode != reni_pass::LAST_COT || g.wgrad) {
        const TiledFn<T> head = mode == reni_pass::LAST_COT ? tiled_head<T, FILM, reni_pass::LAST_COT>
                                : mode == reni_pass::LAST_OUT
                                    ? tiled_head<T, FILM, reni_pass::LAST_OUT>
                                    : tiled_head<T, FILM, reni_pass::LAST_STEP>;
        err = launch_one(head, g, hgrid, ET, esmem, s);
        if (err != cudaSuccess) return (int)err;
      }
      if (mode != reni_pass::LAST_OUT)
        err = launch_one(tiled_last_bwd<T, FILM, SN>, g, grid, ET, esmem, s);
    } else {
      g.j = 2 * n_mm - 1 - k;
      err = launch_product<T, FILM, SN>(KIND_BWD, g, grid, s);
    }
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
  return (int)launch_weight_grads(BF, g.sc_h, g.sc_dz, o.part_dws, o.dws,
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
//     T - 1); b0 Cond-by-Concat only, fr and ph FiLM only; w_bwd and w_fwd
//     the products' B operands (TiledArgs), wf, sc_h and sc_dz in T;
//     sc_keep (max(n_mm, 1), B P, H), sc_o (n_cb, B P, C_PAD) and sc_g
//     (B P, C_PAD) float32. Outputs as for reni_siren_step / reni_film_step
//     of siren_step.cu / film_step.cu. Returns a cudaError_t.
//   reni_tiled_smem_bytes: shared memory of the largest CTA at width H
//     (kernels/siren_step.py mirrors it in tiled_smem_bytes).
#define RENI_TILED_ENTRIES(T, FILM)                                                              \
  extern "C" {                                                                                   \
  int reni_tiled_passes(const float* d, long long d_bstride, const float* a, const float* b0,   \
                        const void* w_bwd, const void* w_fwd, const float* bs, const void* wf,  \
                        const float* bf, const float* fr, const float* ph, const float* tgt,    \
                        const float* sw, const float* bm, const float* gin, float* out,         \
                        float* part_img, float* out_img, float* part_w, float* out_w,           \
                        void* sc_h, float* sc_keep, void* sc_dz, float* sc_o, float* sc_g,      \
                        float* part_dws, float* dws, int batch, int P, int H, int n_mm,         \
                        int tiles_per_cta, int n_chunks, int n_cb, int rows_per_chunk,          \
                        int n_wchunks, float omega0, float omega_h, float gscale, int fast,     \
                        int act, int wgrad, int pass_lo, int pass_hi, int finish,               \
                        void* stream) {                                                         \
    const reni_tiled::TiledArgs<T> g{                                                            \
        d, d_bstride, a, b0, static_cast<const T*>(w_bwd), static_cast<const T*>(w_fwd), bs,    \
        static_cast<const T*>(wf), bf, fr, ph, tgt, sw, bm, gin, out, part_img, part_w,         \
        static_cast<T*>(sc_h), sc_keep, static_cast<T*>(sc_dz), sc_o, sc_g, batch, P, H, n_mm,  \
        tiles_per_cta, n_chunks, n_cb, act, wgrad, omega0, omega_h, 2.0f * gscale, 0};          \
    const reni_step::Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};       \
    return reni_tiled::run_tiled<T, FILM>(g, fast != 0, sums, batch, pass_lo, pass_hi, finish,  \
                                          static_cast<cudaStream_t>(stream));                   \
  }                                                                                              \
  int reni_tiled_smem_bytes(int H) {                                                             \
    return (int)reni_tiled::tiled_smem(H, reni_tiled::Prec<T>::BF16);                           \
  }                                                                                              \
  const char* reni_tiled_error_string(int err) {                                                 \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                                    \
  }                                                                                              \
  }
