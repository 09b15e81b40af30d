// Fused SIREN / FiLM decoder backward for Hopper (sm_90a): the kernel template
// and its launch. siren_bwd.cu instantiates the shipped kernels from it,
// siren_anatomy.cu the anatomy probes (the SINE_LINEAR stand-in, the launch
// without the reduction passes).
//
// Replaces the Pallas backward kernels of reni_tpu/kernels/siren_pallas.py:
//   - _bwd_kernel       (VJP of the Cond-by-Concat trunk, entry fused_apply)
//   - _film_bwd_kernel  (VJP of the FiLM trunk, entry fused_film_apply)
// with one templated kernel (FILM, trunk dtype, sine mode, weight-gradient
// flags) and a second pass that sums the per-image gradients.
//
// What it computes, per image b, from the forward's inputs and the output
// cotangent g (B, P, 8); all operands and results float32:
//   - the forward again (sin and cos of each pre-activation from one range
//     reduction), keeping every layer's activation and cos factor;
//   - Cond-by-Concat: dh = g @ Wf^T; for i = L-1..0:
//     dz = dh * (omega_h * c_{i+1}), dWs_i += h_i^T dz, dbs_i += sum dz,
//     dh = dz @ W_i^T; then dz0 = dh * (omega0 * c_0), dA_b += d^T dz0,
//     db0_b += sum dz0; dWf += h_L^T g, dbf += sum g;
//   - FiLM: for i = T-1..0: dmod = dh * c_i, dfreqs_b,i += sum dmod * pre_i,
//     dphases_b,i += sum dmod, dz = dmod * f_i, dbs_i += sum dz; i = 0:
//     dA0_b += d^T dz; else dWs_{i-1} += h_{i-1}^T dz, dh = dz @ W_{i-1}^T.
// With the bf16 trunk both operands of every product are rounded to bf16,
// the cotangents g and dz included, and summed in float32, as JAX's _dot
// does; the bias sums (dbs, db0, dbf, dphases, dfreqs) take the float32
// values. The order of each float32 expression is the TPU kernel's:
// omega * c before the product with dh, dz = dmod * f after the sums.
//
// What bounds it on the H100: tensor-core operations (per pixel at 5 x 256,
// 1.32e6 FLOP without and 1.97e6 with the weight gradients, against 32 B of
// cotangent read). The design:
//   - the TPU grid is sequential and accumulates gradients across grid steps;
//     CTAs run concurrently here. One CTA per (image, chunk of consecutive
//     pixel tiles); it walks its tiles in order and sums the per-image
//     gradients (dA, db0; FiLM dA0, dfreqs, dphases) in shared memory, then
//     writes them to its own slot of a (B, n_chunks, n_img) buffer. A second
//     kernel sums the slots in chunk order: the per-image gradients that
//     FIT_LATENT uses are deterministic;
//   - weight gradients are optional (WGRAD) and use no float atomics: the
//     small ones (dbs, dWf, dbf) are summed per CTA in shared memory and
//     written to the CTA's slot of a (B * n_chunks, n_w) buffer, summed in
//     slot order by reduce_slots; for dWs_i (H x H; no CTA can hold 5 x 256
//     KB of accumulators) the kernel writes each tile's h_i and dz_i to a
//     device scratch and the split-K GEMM of siren_chain.cuh forms h_i^T dz_i
//     with its partials summed in chunk order. Two calls on the same inputs
//     give the same bits;
//   - a tile is 16 pixel rows (8 with the float32 trunk): every layer's
//     activation (bf16) and cos factor (float32; FiLM keeps the
//     pre-modulation value and recomputes the cos) stay in shared memory,
//     205,696 B at 5 x 256 with bf16; without weight gradients no (B, P, H)
//     tensor reaches HBM;
//   - the H x H products are wmma 16x16x16 bf16 with float32 accumulators
//     (B fragments from global/L2); the float32 trunk runs FMA loops (no
//     TF32); the K = 8 and N = 8 products and every column reduction run as
//     FMA loops in which one thread owns one column;
//   - rows past P read a zero cotangent and zero directions, so they add
//     exact zeros to every sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "siren_chain.cuh"

namespace reni_bwd {

using namespace nvcuda;
using namespace reni;

struct Args {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias
  const void* ws;       // (n_mm, H, H) hidden weights, bf16 or float32
  const float* bs;      // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const void* wf;       // (H, C_PAD) final weight, bf16 or float32
  const float* fr;      // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;      // FiLM (B, (n_mm + 1) * H) phase shifts
  const float* g;       // (B, P, C_PAD) output cotangent
  float* part;          // (B, n_chunks, n_img) per-image partial sums
  float* part_w;        // (B * n_chunks, n_w) dbs | dWf | dbf sums; WGRAD only
  void* sc_h;           // (n_mm, B * P, H) activations, trunk dtype; WGRAD only
  void* sc_dz;          // (n_mm, B * P, H) cotangents dz; WGRAD only
  int P, H, n_mm, tiles_per_cta, n_chunks;
  float omega0, omega_h;
};

// Per-image gradient values per image: Cond-by-Concat dA (8H) | db0 (H);
// FiLM dA0 (8H) | dfreqs (T H) | dphases (T H).
__host__ __device__ inline int image_values(bool film, int H, int n_mm) {
  return film ? (K_PAD + 2 * (n_mm + 1)) * H : (K_PAD + 1) * H;
}

// Weight sums of one CTA: dbs (Cond-by-Concat n_mm H, FiLM (n_mm + 1) H) |
// dWf (8 H) | dbf (8).
__host__ __device__ inline int weight_values(bool film, int H, int n_mm) {
  return (film ? n_mm + 1 : n_mm) * H + H * C_PAD + C_PAD;
}

// Shared-memory layout of one CTA (byte offsets). kernels/siren_bwd.py
// mirrors it in bwd_smem_bytes.
struct Layout {
  size_t hs, keep, dh, dz, stage, dtile, gtile, img, wacc, total;
};

__host__ __device__ inline Layout layout(bool film, bool bf16, int H, int n_mm) {
  const size_t tm = tile_rows(bf16), act = bf16 ? 2 : 4, lda = H + ROW_PAD;
  const size_t n_act = n_mm + 1, n_bs = film ? n_act : n_mm;
  Layout L;
  size_t off = 0;
  L.hs = off;     // activations, (n_act, TM, lda), trunk dtype
  off += align128(n_act * tm * lda * act);
  L.keep = off;   // cos factors (FiLM: pre-modulation values), (n_act, TM, H)
  off += align128(n_act * tm * H * 4);
  L.dh = off;     // (TM, H) float32
  off += align128(tm * H * 4);
  L.dz = off;     // (TM, lda), trunk dtype
  off += align128(tm * lda * act);
  L.stage = off;  // per-warp 16 x 16 float32 staging (bf16 trunk)
  off += bf16 ? WARPS * 256 * 4 : 0;
  L.dtile = off;  // (TM, K_PAD)
  off += align128(tm * K_PAD * 4);
  L.gtile = off;  // (TM, C_PAD)
  off += align128(tm * C_PAD * 4);
  L.img = off;    // per-image sums of this CTA
  off += align128((size_t)image_values(film, H, n_mm) * 4);
  L.wacc = off;   // dbs | dWf | dbf sums of this CTA
  off += align128((n_bs * H + (size_t)H * C_PAD + C_PAD) * 4);
  L.total = off;
  return L;
}

// Forward activation of layer `layer` at (r, c) from its accumulator: the
// activation goes to hs (rounded for the next product), the cos factor
// (Cond-by-Concat) or the pre-modulation value (FiLM) to keep.
template <bool FILM, int SINE, int TM, typename act_t>
__device__ __forceinline__ void store_act(const Args& g, int b, int layer, int r, int c,
                                          float acc, act_t* hs, float* keep, int lda) {
  const int H = g.H;
  float s;
  if (FILM) {
    const size_t m = ((size_t)b * (g.n_mm + 1) + layer) * H + c;
    const float pre = acc + g.bs[(size_t)layer * H + c];
    s = sine<SINE>(__fadd_rn(__fmul_rn(g.fr[m], pre), g.ph[m]));
    keep[((size_t)layer * TM + r) * H + c] = pre;
  } else {
    const float x = layer == 0 ? g.omega0 * (acc + g.b0[(size_t)b * H + c])
                               : g.omega_h * (acc + g.bs[(size_t)(layer - 1) * H + c]);
    float co;
    sine_cosine<SINE>(x, &s, &co);
    keep[((size_t)layer * TM + r) * H + c] = co;
  }
  put(hs + ((size_t)layer * TM + r) * lda + c, s);
}

template <bool FILM, bool BF16, int SINE, bool WGRAD>
__global__ void __launch_bounds__(THREADS) trunk_bwd(Args g) {
  using act_t = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int TM = tile_rows(BF16);
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = g.H, lda = H + ROW_PAD, n_mm = g.n_mm, n_act = n_mm + 1;
  const Layout lay = layout(FILM, BF16, H, n_mm);
  act_t* hs = reinterpret_cast<act_t*>(smem + lay.hs);
  float* keep = reinterpret_cast<float*>(smem + lay.keep);
  float* dh = reinterpret_cast<float*>(smem + lay.dh);
  act_t* dz = reinterpret_cast<act_t*>(smem + lay.dz);
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  float* dt = reinterpret_cast<float*>(smem + lay.dtile);
  float* gt = reinterpret_cast<float*>(smem + lay.gtile);
  float* img = reinterpret_cast<float*>(smem + lay.img);
  float* wacc = reinterpret_cast<float*>(smem + lay.wacc);
  const int n_img = image_values(FILM, H, n_mm);
  const int n_bs = FILM ? n_act : n_mm;
  float* dwf_acc = wacc + (size_t)n_bs * H;
  float* dbf_acc = dwf_acc + (size_t)H * C_PAD;
  const int b = cta_image(g.n_chunks), chunk = cta_item(g.n_chunks);
  const float* d = g.d + b * g.d_bstride;
  const float* a = g.a + (size_t)b * K_PAD * H;
  const act_t* ws = static_cast<const act_t*>(g.ws);
  const act_t* wf = static_cast<const act_t*>(g.wf);
  const act_t* h_last = hs + (size_t)n_mm * TM * lda;

  for (int i = threadIdx.x; i < n_img; i += THREADS) img[i] = 0.0f;
  if constexpr (WGRAD) {
    for (int i = threadIdx.x; i < n_bs * H + H * C_PAD + C_PAD; i += THREADS) wacc[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < g.tiles_per_cta; ++t) {
    const int p0 = (chunk * g.tiles_per_cta + t) * TM;
    if (p0 >= g.P) break;  // the same for every thread of the CTA
    // this tile's h and dz of product `layer`, for the weight-gradient GEMM
    auto scratch_rows = [&](const act_t* h, const act_t* dz_tile, int layer) {
      const size_t at = (((size_t)layer * cta_images(g.n_chunks) + b) * g.P + p0) * H;
      const int valid = min(TM, g.P - p0);
      store_rows(h, static_cast<act_t*>(g.sc_h) + at, valid, H, lda);
      store_rows(dz_tile, static_cast<act_t*>(g.sc_dz) + at, valid, H, lda);
    };
    for (int i = threadIdx.x; i < TM * K_PAD; i += THREADS) {
      const int r = i / K_PAD, k = i % K_PAD, p = p0 + r;
      const bool in = p < g.P;
      dt[i] = in ? d[(size_t)p * K_PAD + k] : 0.0f;
      gt[i] = in ? g.g[((size_t)b * g.P + p) * C_PAD + k] : 0.0f;
    }
    __syncthreads();

    // forward again, keeping every layer
    for (int i = threadIdx.x; i < TM * H; i += THREADS) {
      const int r = i / H, c = i - r * H;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K_PAD; ++k)
        acc = fmaf(rnd<BF16>(dt[r * K_PAD + k]), rnd<BF16>(a[k * H + c]), acc);
      store_act<FILM, SINE, TM>(g, b, 0, r, c, acc, hs, keep, lda);
    }
    __syncthreads();
    for (int l = 1; l <= n_mm; ++l) {
      const act_t* w = ws + (size_t)(l - 1) * H * H;
      const act_t* hin = hs + (size_t)(l - 1) * TM * lda;
      auto epi = [&](int r, int c, float acc) {
        store_act<FILM, SINE, TM>(g, b, l, r, c, acc, hs, keep, lda);
      };
      if constexpr (BF16) {
        hidden_layer_bf16(hin, w, stage, H, lda, epi);
      } else {
        hidden_layer_f32<TM>(hin, w, H, lda, epi);
      }
      __syncthreads();
    }

    // final layer: dh = g @ Wf^T; dWf += h_last^T g; dbf += sum g
    for (int i = threadIdx.x; i < TM * H; i += THREADS) {
      const int r = i / H, n = i - r * H;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < C_PAD; ++c)
        s = fmaf(rnd<BF16>(gt[r * C_PAD + c]), get(wf[n * C_PAD + c]), s);
      dh[i] = s;
    }
    if constexpr (WGRAD) {
      for (int m = threadIdx.x; m < H; m += THREADS) {
#pragma unroll
        for (int c = 0; c < C_PAD; ++c) {
          float s = 0.0f;
          for (int r = 0; r < TM; ++r)
            s = fmaf(get(h_last[(size_t)r * lda + m]), rnd<BF16>(gt[r * C_PAD + c]), s);
          dwf_acc[m * C_PAD + c] += s;
        }
      }
      if (threadIdx.x < C_PAD) {
        float s = 0.0f;
        for (int r = 0; r < TM; ++r) s += gt[r * C_PAD + threadIdx.x];
        dbf_acc[threadIdx.x] += s;
      }
    }
    __syncthreads();

    if constexpr (!FILM) {
      for (int i = n_mm - 1; i >= 0; --i) {
        const float* c_next = keep + (size_t)(i + 1) * TM * H;
        for (int n = threadIdx.x; n < H; n += THREADS) {
          float sb = 0.0f;
          for (int r = 0; r < TM; ++r) {
            const float v = __fmul_rn(dh[r * H + n], __fmul_rn(g.omega_h, c_next[r * H + n]));
            put(dz + (size_t)r * lda + n, v);
            sb += v;
          }
          if constexpr (WGRAD) wacc[(size_t)i * H + n] += sb;
        }
        __syncthreads();
        if constexpr (WGRAD) scratch_rows(hs + (size_t)i * TM * lda, dz, i);
        input_grad<BF16>(dz, ws + (size_t)i * H * H, dh, H, lda);
        __syncthreads();
      }
      for (int n = threadIdx.x; n < H; n += THREADS) {
        float sb = 0.0f, sa[K_PAD];
#pragma unroll
        for (int k = 0; k < K_PAD; ++k) sa[k] = 0.0f;
        for (int r = 0; r < TM; ++r) {
          const float v = __fmul_rn(dh[r * H + n], __fmul_rn(g.omega0, keep[r * H + n]));
          sb += v;
          const float q = rnd<BF16>(v);
#pragma unroll
          for (int k = 0; k < K_PAD; ++k) sa[k] = fmaf(rnd<BF16>(dt[r * K_PAD + k]), q, sa[k]);
        }
#pragma unroll
        for (int k = 0; k < K_PAD; ++k) img[k * H + n] += sa[k];
        img[K_PAD * H + n] += sb;
      }
      __syncthreads();
    } else {
      for (int i = n_act - 1; i >= 0; --i) {
        const float* pre_i = keep + (size_t)i * TM * H;
        for (int n = threadIdx.x; n < H; n += THREADS) {
          const size_t m = ((size_t)b * n_act + i) * H + n;
          const float f = g.fr[m], p = g.ph[m];
          float s_fr = 0.0f, s_ph = 0.0f, s_bs = 0.0f, sa[K_PAD];
#pragma unroll
          for (int k = 0; k < K_PAD; ++k) sa[k] = 0.0f;
          for (int r = 0; r < TM; ++r) {
            const float pre = pre_i[r * H + n];
            const float c = cosine<SINE>(__fadd_rn(__fmul_rn(f, pre), p));
            const float dmod = __fmul_rn(dh[r * H + n], c);
            s_fr += __fmul_rn(dmod, pre);
            s_ph += dmod;
            const float v = __fmul_rn(dmod, f);
            s_bs += v;
            if (i > 0) {
              put(dz + (size_t)r * lda + n, v);
            } else {
              const float q = rnd<BF16>(v);
#pragma unroll
              for (int k = 0; k < K_PAD; ++k)
                sa[k] = fmaf(rnd<BF16>(dt[r * K_PAD + k]), q, sa[k]);
            }
          }
          img[K_PAD * H + i * H + n] += s_fr;
          img[(K_PAD + n_act) * H + i * H + n] += s_ph;
          if constexpr (WGRAD) wacc[(size_t)i * H + n] += s_bs;
          if (i == 0) {
#pragma unroll
            for (int k = 0; k < K_PAD; ++k) img[k * H + n] += sa[k];
          }
        }
        __syncthreads();
        if (i > 0) {
          if constexpr (WGRAD) scratch_rows(hs + (size_t)(i - 1) * TM * lda, dz, i - 1);
          input_grad<BF16>(dz, ws + (size_t)(i - 1) * H * H, dh, H, lda);
          __syncthreads();
        }
      }
    }
  }

  float* part = g.part + ((size_t)b * g.n_chunks + chunk) * n_img;
  for (int i = threadIdx.x; i < n_img; i += THREADS) part[i] = img[i];
  if constexpr (WGRAD) {
    const int n_w = weight_values(FILM, H, n_mm);
    float* part_w = g.part_w + ((size_t)b * g.n_chunks + chunk) * n_w;
    for (int i = threadIdx.x; i < n_w; i += THREADS) part_w[i] = wacc[i];
  }
}

using KernelFn = void (*)(Args);

// Work space and results of the weight gradients (all null without them):
// out_w receives dbs | dWf | dbf, dws the H x H gradients.
struct WeightGrads {
  float* out_w;
  float* part_dws;  // (n_wchunks, n_mm, H, H) split-K partials
  float* dws;       // (n_mm, H, H)
  int rows_per_chunk, n_wchunks;
};

// Launch one instantiation (`kern` must be one of trunk_bwd<film, bf16, ...,
// wg != nullptr>) and the passes that sum what its CTAs wrote. With
// reduce = false (the anatomy probe "no_accum") only the chain kernel runs and
// the per-CTA slots and the scratch are the result. Returns a cudaError_t.
inline int launch(KernelFn kern, bool film, const Args& g, int batch, bool bf16,
                  const WeightGrads* wg, float* out, void* stream, bool reduce = true) {
  const size_t smem = layout(film, bf16, g.H, g.n_mm).total;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = image_grid(g.n_chunks, batch);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kern<<<grid, THREADS, smem, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return (int)err;
  err = launch_reduce(g.part, out, batch, g.n_chunks, image_values(film, g.H, g.n_mm), s);
  if (err != cudaSuccess || wg == nullptr) return (int)err;
  err = launch_reduce(g.part_w, wg->out_w, 1, batch * g.n_chunks,
                      weight_values(film, g.H, g.n_mm), s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_weight_grads(bf16, g.sc_h, g.sc_dz, wg->part_dws, wg->dws,
                                  (long long)batch * g.P, wg->rows_per_chunk, wg->n_wchunks,
                                  g.H, g.n_mm, s);
}

}  // namespace reni_bwd
