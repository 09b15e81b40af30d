// Fused bf16 SIREN / FiLM decoder forward for Hopper (sm_90a): a persistent,
// layer-fused wgmma kernel that keeps a tile's activations in shared memory
// across every layer and streams the hidden weights through a ring of K-slabs.
// siren_fwd.cu instantiates the shipped kernels, siren_anatomy.cu the probes.
//
// Replaces, for the bf16 trunk with H a multiple of 64 up to 256 and at least
// one H x H product (fwd_route in kernels/siren_fwd.py), the Pallas forward
// kernels of reni_tpu/kernels/siren_pallas.py:
//   - _fwd_kernel       (Cond-by-Concat trunk, entry fused_apply)
//   - _film_fwd_kernel  (FiLM trunk, entry fused_film_apply)
// The float32 trunk, other widths and a FiLM trunk of one layer keep the
// row-tile kernel of siren_fwd.cuh.
//
// What it computes is what trunk_fwd computes (siren_fwd.cuh) with the same
// rounding points: both operands of every product rounded to bf16 (round to
// nearest even) and summed in float32; bias, omega, FiLM modulation and sine
// in float32, in the order omega * (acc + bias) and fr * (acc + bs) + ph (no
// contraction); each activation rounded to bf16 once, for the next product.
// The sums of a product run over K in the same order whatever the schedule,
// and rows are independent, so the grid size and the schedule below change no
// bit of the output. Only the summation order of the products differs from
// trunk_fwd's (wgmma against wmma), and of the final layer (by column blocks).
//
// What bounds it on the H100. Per row at 5 x 256 the products are 6.6e5 FLOP
// (0.46 ms for 21 x 32,768 rows at 989 TFLOP/s); the epilogue is 1,280
// biases, sines and bf16 stores a row on the CUDA cores; device memory moves
// 48 bytes a row. The row-tile kernel it replaces read every weight from L2
// for each 64-row tile as 16x16 wmma fragments (7 GB at the serving shape)
// and was bound by that. This kernel is bound by its epilogue: the sines,
// issued by one warp a scheduler while the other warpgroup's products run,
// take more time than the products (the fwd_no_sine probe, PERF.md). The
// design:
//   - persistent CTAs, one per SM: CTA c walks the (image, 128-row tile)
//     items [c * items / grid, (c + 1) * items / grid) in order. A tile never
//     straddles two images; rows past P are computed from zero directions and
//     never stored. Two consumer warpgroups own 64 rows each; one thread of
//     a third warpgroup, the producer, issues the weight copies. ptxas
//     compiles a 384-thread CTA to 168 registers a thread, enough for the 128
//     accumulators without spills; setmaxnreg still moves registers from the
//     producer to the consumers at run time, which measured faster than
//     without it (a CTA of 256 threads with more registers and no producer,
//     the last warp to release a slot refilling it, was no faster).
//   - the tile's activations stay in shared memory across all layers, K-major
//     and 128-byte swizzled as wgmma reads them; each layer's epilogue
//     overwrites its warpgroup's rows in place (the product that read them is
//     complete), then fences them for the next product.
//   - the weights W_j^T, packed by the wrapper into 64-K-row slabs already
//     swizzled (H x 64 bf16, 32 KB at H = 256), come through a ring of
//     `stages` slabs by 1-D bulk copies completed on mbarriers: no tensor
//     map. The producer walks the same items, so layer j + 1's slabs land
//     during layer j's last slabs and epilogue. A weight byte read from L2
//     serves 128 rows: 3.5 GB (cbc) / 2.8 GB (FiLM) at the serving shape.
//   - every H x H product is wgmma m64nHk16 (one instruction per 16 of K)
//     with float32 accumulators in registers (128 a thread at H = 256); H is
//     a compile-time constant of the product (layer_product<H / 64>), so no
//     wgmma sits on a conditional path. A slab is released (one arrival per
//     consumer warp) as soon as the products that read it are complete.
//   - the K = 8 first layer is an FMA loop on bf16-rounded operands, computed
//     straight into the accumulator layout so that it shares the epilogue of
//     the other layers; the N = 8 final layer is an FMA loop over the
//     registers of the last activation, each quad of threads adding its
//     partial sums with two shuffles. Neither touches shared memory for h.
//   - per-image vectors (A_b rounded to bf16, b0_b; FiLM's fr and ph of every
//     layer) are staged in shared memory when a CTA's image changes; the
//     layer biases and Wf once per CTA.
//   - schedule SCHED_PINGPONG (the shipped one where the ring holds a whole
//     layer): the two warpgroups take turns at the tensor cores (named
//     barriers), so one warpgroup's epilogue runs under the other's
//     products. SCHED_LOCKSTEP (the probes' "serialized" variant, and the
//     shipped one where the ring is shorter than a layer): both warpgroups
//     run their products together and their epilogues together.
// Limits: H in {64, 128, 192, 256}, n_mm >= 1, the layout of fused_layout
// with at least two stages (n_mm <= 16 always fits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_common.cuh"
#include "wgmma.cuh"

namespace reni_fused {

using namespace reni;
using namespace reni_wg;

constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int FTHREADS = CONSUMERS + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65,536
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a CTA on the H100
// named barriers: 1 both warpgroups, 2 + wg one warpgroup, 4 + wg its turn
enum { BAR_CONSUMERS = 1, BAR_WG = 2, BAR_TURN = 4 };
enum { SCHED_LOCKSTEP = 0, SCHED_PINGPONG = 1 };

struct FusedArgs {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias; unused by FiLM
  const bf16* slabs;    // (n_mm, H / 64, H, 64) W_j^T in slabs, swizzled (swz)
  const float* bs;      // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const bf16* wf;       // (H, C_PAD) final weight
  const float* bf;      // (C_PAD,)
  const float* fr;      // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;      // FiLM (B, (n_mm + 1) * H) phase shifts
  float* out;           // (B, P, C_PAD)
  int batch, P, H, n_mm, stages, sched;
  float omega0, omega_h;
};

// Shared memory of a CTA (byte offsets from a 1024-aligned base);
// kernels/siren_fwd.py mirrors it in fused_layout.
struct FusedLayout {
  size_t act, ring, a, vec, wf, bars, total;
  int stages;
};

// floats of the per-layer vectors: Cond-by-Concat b0_b then bs_1..n_mm;
// FiLM bs, fr, ph of layers 0..n_mm
__host__ __device__ inline size_t vec_floats(int H, int n_mm, bool film) {
  return (size_t)(film ? 3 : 1) * (n_mm + 1) * H;
}

__host__ __device__ inline FusedLayout fused_layout_at(int H, int n_mm, bool film, int stages) {
  FusedLayout L;
  size_t off = 0;
  L.act = off;   // the tile's activations, (H / 64, TILE, 64) bf16, swizzled
  off += (size_t)TILE * H * 2;
  L.ring = off;  // `stages` weight slabs, each (H, 64) bf16, swizzled
  off += (size_t)stages * H * 64 * 2;
  L.a = off;     // this image's first-layer weight (K_PAD, H), float32 rounded to bf16
  off += align128((size_t)K_PAD * H * 4);
  L.vec = off;   // per-layer vectors, float32
  off += align128(vec_floats(H, n_mm, film) * 4);
  L.wf = off;    // the final weight (H, C_PAD) bf16
  off += align128((size_t)H * C_PAD * 2);
  L.bars = off;  // full and empty barrier of each stage
  off += align128((size_t)2 * stages * 8);
  L.total = off + 1024;  // slack to align the base to the swizzle atom
  L.stages = stages;
  return L;
}

// the layout with the deepest ring that fits (stages = 0: none fits)
__host__ __device__ inline FusedLayout fused_layout(int H, int n_mm, bool film) {
  for (int s = MAX_STAGES; s >= MIN_STAGES; --s) {
    const FusedLayout L = fused_layout_at(H, n_mm, film, s);
    if (L.total <= SMEM_LIMIT) return L;
  }
  FusedLayout none = fused_layout_at(H, n_mm, film, MIN_STAGES);
  none.stages = 0;
  return none;
}

constexpr int EPI_GROUP = 8;  // elements whose sines an epilogue interleaves

// x[i] = sine(x[i]) for a group of elements (the fast sine interleaved)
template <int SN, int N>
__device__ __forceinline__ void group_sine(float (&x)[N]) {
  if constexpr (SN == SINE_FAST) {
    fast_sin_n(x);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = sine<SN>(x[i]);
  }
}

// The pre-activations of accumulator elements i0 .. i0 + EPI_GROUP - 1 of
// block nc at layer l: omega * (acc + bias) or fr * (acc + bs) + ph.
template <bool FILM>
__device__ __forceinline__ void pre_activations(float (&x)[EPI_GROUP], const float (&acc)[NCH * 32],
                                                const float* vec, int l, int H, int T,
                                                float omega, int nc, int i0) {
  const float* bias = vec + (size_t)l * H;
  const float* fr = vec + (size_t)(T + l) * H;
  const float* ph = vec + (size_t)(2 * T + l) * H;
#pragma unroll
  for (int e = 0; e < EPI_GROUP; e += 2) {
    const int c = acc_col(nc, i0 + e);
    const float a0 = acc[nc * 32 + i0 + e], a1 = acc[nc * 32 + i0 + e + 1];
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
    if constexpr (FILM) {
      const float2 f = *reinterpret_cast<const float2*>(fr + c);
      const float2 p = *reinterpret_cast<const float2*>(ph + c);
      x[e] = __fadd_rn(__fmul_rn(f.x, a0 + b.x), p.x);
      x[e + 1] = __fadd_rn(__fmul_rn(f.y, a1 + b.y), p.y);
    } else {
      x[e] = omega * (a0 + b.x);
      x[e + 1] = omega * (a1 + b.y);
    }
  }
}

// Layer l's activation (0 = first layer) of this thread's accumulator
// elements into its rows of the activation tile, rounded to bf16.
template <bool FILM, int SN>
__device__ __forceinline__ void epilogue(float (&acc)[NCH * 32], const FusedArgs& g,
                                         const float* vec, int l, bf16* act) {
  const int nch = g.H / 64;
  const float omega = l == 0 ? g.omega0 : g.omega_h;
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc) {
    if (nc >= nch) continue;
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += EPI_GROUP) {
      float x[EPI_GROUP];
      pre_activations<FILM>(x, acc, vec, l, g.H, g.n_mm + 1, omega, nc, i0);
      group_sine<SN>(x);
#pragma unroll
      for (int e = 0; e < EPI_GROUP; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(act + swz(acc_row(i0 + e), acc_col(nc, i0 + e), TILE)) =
            __floats2bfloat162_rn(x[e], x[e + 1]);
    }
  }
}

// The last layer's activation and the final layer from registers: each
// thread sums its columns of its two rows for the 8 outputs, a quad adds its
// four partial sums, and each thread of the quad stores 4 outputs of a row.
template <bool FILM, int SN>
__device__ __forceinline__ void final_layer(float (&acc)[NCH * 32], const FusedArgs& g,
                                            const float* vec, const bf16* wf, int b, int p0,
                                            int valid) {
  const int nch = g.H / 64;
  float o[2][C_PAD] = {};
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc) {
    if (nc >= nch) continue;
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += EPI_GROUP) {
      float x[EPI_GROUP];
      pre_activations<FILM>(x, acc, vec, g.n_mm, g.H, g.n_mm + 1, g.omega_h, nc, i0);
      group_sine<SN>(x);
#pragma unroll
      for (int e = 0; e < EPI_GROUP; ++e) {
        const int i = i0 + e, c = acc_col(nc, i), half = (i >> 1) & 1;
        const float h = rnd<true>(x[e]);
        const uint4 wv = *reinterpret_cast<const uint4*>(wf + (size_t)c * C_PAD);
        const bf16* w = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
        for (int k = 0; k < C_PAD; ++k) o[half][k] = fmaf(h, get(w[k]), o[half][k]);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int k = 0; k < C_PAD; ++k) {
      o[half][k] += __shfl_xor_sync(0xffffffffu, o[half][k], 1);
      o[half][k] += __shfl_xor_sync(0xffffffffu, o[half][k], 2);
    }
  const int q = threadIdx.x % 4, r = acc_row(0) + (q >> 1) * 8, k0 = (q & 1) * 4;
  if (r >= valid) return;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = (q & 1) ? o[0][4 + k] : o[0][k], hi = (q & 1) ? o[1][4 + k] : o[1][k];
    v[k] = ((q >> 1) ? hi : lo) + g.bf[k0 + k];
  }
  *reinterpret_cast<float4*>(g.out + ((size_t)b * g.P + p0 + r) * C_PAD + k0) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// Layer 0 before its activation: acc = d a_b (K = 8, FMA over k in order)
// for this thread's elements; `as` is a_b rounded to bf16. Rows past `valid`
// see zero directions.
__device__ __forceinline__ void first_layer(float (&acc)[NCH * 32], const FusedArgs& g, int b,
                                            int p0, int valid, const float* as) {
  const int H = g.H, nch = H / 64;
  const float* d = g.d + b * g.d_bstride;
  float dv[2][K_PAD];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = acc_row(2 * half);
#pragma unroll
    for (int k = 0; k < K_PAD; ++k)
      dv[half][k] = r < valid ? rnd<true>(d[(size_t)(p0 + r) * K_PAD + k]) : 0.0f;
  }
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc) {
    if (nc >= nch) continue;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int c = acc_col(nc, i);
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // (r, c), (r, c+1), (r+8, c), (r+8, c+1)
#pragma unroll
      for (int k = 0; k < K_PAD; ++k) {
        const float2 av = *reinterpret_cast<const float2*>(as + k * H + c);
        x[0] = fmaf(dv[0][k], av.x, x[0]);
        x[1] = fmaf(dv[0][k], av.y, x[1]);
        x[2] = fmaf(dv[1][k], av.x, x[2]);
        x[3] = fmaf(dv[1][k], av.y, x[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nc * 32 + i + e] = x[e];
    }
  }
}

// acc = this warpgroup's 64 rows of the activation tile times W_j^T over
// K = H = 64 NB, the slabs of layer j taken from the ring in order (`n`
// counts the slabs this CTA has consumed). In ping-pong the other
// warpgroup's turn is given once this one has issued all its products
// (`pass_turn`).
template <int NB>
__device__ __forceinline__ void layer_product(float (&acc)[NCH * 32], const bf16* act,
                                              const bf16* ring, uint64_t* full,
                                              uint64_t* empty, uint32_t& n, int stages,
                                              bool pass_turn) {
  constexpr int H = 64 * NB;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
#pragma unroll
  for (int kb = 0; kb < NB; ++kb) {
    const uint32_t m = n + kb, slot = m % stages;
    mbar_wait(full + slot, (m / stages) & 1);
    const bf16* w = ring + (size_t)slot * H * 64;
    fence_regs<NB * 32>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_bf16<H>(acc, gmma_desc(act + kb * TILE * 64 + wg * 64 * 64 + ks * 16),
                    gmma_desc(w + ks * 16), kb | ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kb > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs<NB * 32>(acc);
      if (lane == 0) mbar_arrive(empty + (m - 1) % stages);
    }
  }
  if (pass_turn) bar_arrive(BAR_TURN + (1 - wg), CONSUMERS);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs<NB * 32>(acc);
  if (lane == 0) mbar_arrive(empty + (n + NB - 1) % stages);
  n += NB;
}

template <bool FILM, int SN>
__global__ void __launch_bounds__(FTHREADS, 1) fused_fwd(FusedArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int H = g.H, nch = H / 64, n_mm = g.n_mm, stages = g.stages, tid = threadIdx.x;
  const FusedLayout lay = fused_layout_at(H, n_mm, FILM, stages);
  bf16* act = reinterpret_cast<bf16*>(smem + lay.act);
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  float* as = reinterpret_cast<float*>(smem + lay.a);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  bf16* wf = reinterpret_cast<bf16*>(smem + lay.wf);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  const int tiles = (g.P + TILE - 1) / TILE;
  const long long items = (long long)g.batch * tiles;
  const long long lo = blockIdx.x * items / gridDim.x, hi = (blockIdx.x + 1) * items / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer: one thread issues every slab copy in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const uint32_t bytes = (uint32_t)H * 64 * 2;
      uint32_t m = 0;
      for (long long it = lo; it < hi; ++it)
        for (int j = 0; j < n_mm; ++j)
          for (int kb = 0; kb < nch; ++kb, ++m) {
            const uint32_t slot = m % stages;
            if (m >= (uint32_t)stages) mbar_wait(empty + slot, ((m / stages) & 1) ^ 1);
            mbar_expect_tx(full + slot, bytes);
            bulk_load(ring + (size_t)slot * H * 64,
                      g.slabs + ((size_t)j * nch + kb) * H * 64, bytes, full + slot);
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // the layer biases and the final weight, once per CTA
  const int T = n_mm + 1;
  if (FILM) {
    for (int i = tid; i < T * H; i += CONSUMERS) vec[i] = g.bs[i];
  } else {
    for (int i = tid; i < n_mm * H; i += CONSUMERS) vec[H + i] = g.bs[i];
  }
  for (int i = tid; i < H * C_PAD; i += CONSUMERS) wf[i] = g.wf[i];

  const int wg = tid / 128;
  const bool pingpong = g.sched == SCHED_PINGPONG;
  if (pingpong && wg == 1) bar_arrive(BAR_TURN + 0, CONSUMERS);  // warpgroup 0 goes first
  float acc[NCH * 32];
  uint32_t n = 0;
  int staged = -1;
  for (long long it = lo; it < hi; ++it) {
    const int b = (int)(it / tiles), p0 = (int)(it % tiles) * TILE;
    const int valid = min(TILE, g.P - p0);
    if (b != staged) {  // this image's vectors (both warpgroups are past the last tile)
      bar_sync(BAR_CONSUMERS, CONSUMERS);
      const float* a = g.a + (size_t)b * K_PAD * H;
      for (int i = tid; i < K_PAD * H; i += CONSUMERS) as[i] = rnd<true>(a[i]);
      if (FILM) {
        const size_t img = (size_t)b * T * H;
        for (int i = tid; i < T * H; i += CONSUMERS) {
          vec[T * H + i] = g.fr[img + i];
          vec[2 * T * H + i] = g.ph[img + i];
        }
      } else {
        for (int i = tid; i < H; i += CONSUMERS) vec[i] = g.b0[(size_t)b * H + i];
      }
      bar_sync(BAR_CONSUMERS, CONSUMERS);
      staged = b;
    }
    first_layer(acc, g, b, p0, valid, as);
    epilogue<FILM, SN>(acc, g, vec, 0, act);
    for (int j = 0; j < n_mm; ++j) {
      fence_async_smem();  // this thread's activations, visible to wgmma
      bar_sync(BAR_WG + wg, 128);
      if (pingpong) {
        bar_sync(BAR_TURN + wg, CONSUMERS);
      } else {
        bar_sync(BAR_CONSUMERS, CONSUMERS);  // both warpgroups start their products together
      }
      // warpgroup 1 gives no turn after the CTA's last product: nobody takes it
      const bool last = it == hi - 1 && j == n_mm - 1;
      const bool turn = pingpong && !(wg == 1 && last);
      switch (nch) {
        case 1: layer_product<1>(acc, act, ring, full, empty, n, stages, turn); break;
        case 2: layer_product<2>(acc, act, ring, full, empty, n, stages, turn); break;
        case 3: layer_product<3>(acc, act, ring, full, empty, n, stages, turn); break;
        default: layer_product<4>(acc, act, ring, full, empty, n, stages, turn); break;
      }
      bar_sync(BAR_WG + wg, 128);  // every product reading this warpgroup's rows is complete
      if (!pingpong) bar_sync(BAR_CONSUMERS, CONSUMERS);  // and the epilogues start together
      if (j < n_mm - 1) epilogue<FILM, SN>(acc, g, vec, j + 1, act);
    }
    final_layer<FILM, SN>(acc, g, vec, wf, b, p0, valid);
  }
}

using FusedFn = void (*)(FusedArgs);

// Persistent grid: one CTA per SM, no more than there are items.
inline int fused_grid(int batch, int P, int sms) {
  const long long items = (long long)batch * ((P + TILE - 1) / TILE);
  return (int)(items < sms ? items : sms);
}

// Launch one instantiation (FiLM or not: `film`) over `grid` CTAs, at most
// one per item; returns a cudaError_t.
inline int launch_fused(FusedFn kern, bool film, FusedArgs g, int grid, void* stream) {
  const FusedLayout L = fused_layout_at(g.H, g.n_mm, film, g.stages);
  const int nch = g.H / 64;
  grid = fused_grid(g.batch, g.P, grid);
  if (g.H % 64 || g.H < 64 || g.H > 64 * NCH || g.n_mm < 1 || grid < 1 ||
      g.stages < MIN_STAGES || g.stages > MAX_STAGES || L.total > SMEM_LIMIT ||
      (g.sched == SCHED_PINGPONG && g.stages < nch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, FTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace reni_fused
