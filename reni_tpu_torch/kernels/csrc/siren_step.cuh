// Fused train step for Hopper (sm_90a): forward, weighted-MSE loss and the
// whole backward of the Cond-by-Concat or the FiLM trunk. The chain kernel
// template and its launch; siren_step.cu instantiates the Cond-by-Concat
// kernels from it and film_step.cu the FiLM ones (two sources, so that they
// build side by side). Since the layer-major passes of step_passes.cuh took
// the bf16 trunk at widths that are a multiple of 64, this kernel serves the
// float32 trunk, bf16 widths that are a multiple of 16 but not of 64, and a
// FiLM trunk of one layer (kernels/siren_step.py::pass_route).
//
// Replaces the Pallas kernels _step_kernel (entry fused_step_mse) and
// _film_step_kernel (entry fused_film_step_mse) of
// reni_tpu/kernels/siren_pallas.py, the FIT_DECODER objective.
//
// What it computes, per image b and pixel tile; all operands and results
// float32:
//   - Cond-by-Concat forward with the joint sincos, keeping every layer's
//     activation h_i and cos factor c_i: h_0 = sin(omega0 (d A_b + b0_b)),
//     h_i = sin(omega_h (h_{i-1} W_{i-1} + bs_{i-1})), o = h_L Wf + bf;
//   - FiLM forward, keeping every layer's activation h_i and pre-modulation
//     value pre_i: pre_0 = d A0_b + bs_0, pre_i = h_{i-1} W_{i-1} + bs_i,
//     h_i = sin(f_{b,i} pre_i + p_{b,i}), o = h_{T-1} Wf + bf;
//   - out = act(o) (tanh, exp or none) and act'(o); r = out - tgt;
//     rs = r * (sw * bm_b); loss partials mse[lane] += sum rs * r; the output
//     cotangent g = (2 gscale) rs act'(o), gscale = 1 / (P * out_features);
//   - dWf += h_last^T g, dbf += sum g, dh = g Wf^T, then the backward chain
//     without the forward again. Cond-by-Concat, for i = L-1..0:
//     dz = dh * (omega_h c_{i+1}), dWs_i += h_i^T dz, dbs_i += sum dz,
//     dh = dz W_i^T; then dz0 = dh * (omega0 c_0), dA_b += d^T dz0,
//     db0_b += sum dz0. FiLM, for i = T-1..0: dmod = dh * cos(f_i pre_i + p_i),
//     dfreqs_{b,i} += sum dmod * pre_i, dphases_{b,i} += sum dmod,
//     dz = dmod * f_i, dbs_i += sum dz; i = 0: dA0_b += d^T dz; else
//     dWs_{i-1} += h_{i-1}^T dz, dh = dz W_{i-1}^T.
// With the bf16 trunk both operands of every product are rounded to bf16
// (g, dz and d too) and summed in float32, as JAX's _dot does; the loss, the
// bias sums and the modulation sums take the float32 values. Padded lanes
// (3..7) and rows past P carry sw = 0, so they add exact zeros.
//
// What bounds it on the H100: tensor-core operations (per pixel at 5 x 256,
// 1.97e6 FLOP Cond-by-Concat and 1.58e6 FiLM, against 64 B of directions,
// target and weight read). The design:
//   - the TPU grid is sequential and accumulates every output across grid
//     steps; CTAs run concurrently here. One CTA per (image, chunk of
//     consecutive 16-row tiles; 8 rows with the float32 trunk) keeps its sums
//     in shared memory: the per-image ones (dA | db0; FiLM dA0 | dfreqs |
//     dphases) go to its slot of a (B, chunks, n_img) buffer; the loss
//     partials, dbs, dWf, dbf to its slot of a (B * chunks, n_w) buffer;
//     reduce_slots adds the slots in a fixed order;
//   - dWs (n_mm x H x H) fits in no CTA: the kernel writes each tile's h and
//     dz to a device scratch and a split-K GEMM (siren_chain.cuh) forms
//     h^T dz, its partials summed in chunk order. No float atomicAdd
//     anywhere: two calls on the same inputs give the same bits;
//   - shared memory decides what is kept. Cond-by-Concat keeps h_i and c_i.
//     FiLM needs pre_i for dfreqs, and h_i, pre_i and cos of five layers do
//     not fit beside the working tiles, so it keeps h_i and pre_i and forms
//     cos(f pre + p) again in the backward (fast sine: fast_cos is the cosine
//     half of fast_sincos, so the value is the one a joint sincos gives);
//   - the products are those of siren_bwd.cuh: wmma 16x16x16 bf16 with float32
//     accumulators for H x H, FMA loops for K = 8 and N = 8 and for the
//     float32 trunk. A FiLM trunk of one layer has no H x H product at all.
// So one call is the chain kernel, the GEMM and three small sums: five
// launches on one stream, where the TPU kernel is one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "siren_chain.cuh"

namespace reni_step {

using namespace nvcuda;
using namespace reni;

enum { ACT_NONE = 0, ACT_TANH = 1, ACT_EXP = 2 };

struct Args {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) Cond-by-Concat first-layer bias; unused by FiLM
  const void* ws;       // (n_mm, H, H) hidden weights, bf16 or float32
  const float* bs;      // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const void* wf;       // (H, C_PAD) final weight, bf16 or float32
  const float* bf;      // (C_PAD,)
  const float* fr;      // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;      // FiLM (B, (n_mm + 1) * H) phase shifts
  const float* tgt;     // (B, P, C_PAD) targets
  const float* sw;      // (P, C_PAD) pixel weights, shared by the images
  const float* bm;      // (B, C_PAD) batch mask
  float* part_img;      // (B, n_chunks, n_img) per-image partial sums
  float* part_w;        // (B * n_chunks, n_w) loss and small weight sums
  void* sc_h;           // (n_mm, B * P, H) inputs h of the H x H products, trunk dtype
  void* sc_dz;          // (n_mm, B * P, H) cotangents dz of their outputs
  int P, H, n_mm, tiles_per_cta, n_chunks;
  float omega0, omega_h, gscale2;
};

// Per-image values: Cond-by-Concat dA (8H) | db0 (H); FiLM dA0 (8H) |
// dfreqs (T H) | dphases (T H), T = n_mm + 1.
__host__ __device__ inline int image_values(bool film, int H, int n_mm) {
  return film ? (K_PAD + 2 * (n_mm + 1)) * H : (K_PAD + 1) * H;
}

// Per-CTA weight sums mse (8) | dbs (n_bs H) | dWf (8 H) | dbf (8). FiLM's
// first-layer bias is a shared weight, so its dbs has T = n_mm + 1 rows.
__host__ __device__ inline int bias_rows(bool film, int n_mm) { return film ? n_mm + 1 : n_mm; }
__host__ __device__ inline int weight_values(bool film, int H, int n_mm) {
  return C_PAD + bias_rows(film, n_mm) * H + H * C_PAD + C_PAD;
}

// Shared-memory layout of one CTA (byte offsets). kernels/siren_step.py
// mirrors it in step_smem_bytes.
struct Layout {
  size_t hs, keep, dh, dz, stage, dtile, gtile, ttile, swtile, ltile, img, wacc, total;
};

__host__ __device__ inline Layout layout(bool film, bool bf16, int H, int n_mm) {
  const size_t tm = tile_rows(bf16), act = bf16 ? 2 : 4, lda = H + ROW_PAD, n_act = n_mm + 1;
  Layout L;
  size_t off = 0;
  L.hs = off;      // activations, (n_act, TM, lda), trunk dtype
  off += align128(n_act * tm * lda * act);
  L.keep = off;    // cos factors (FiLM: pre-modulation values), (n_act, TM, H)
  off += align128(n_act * tm * H * 4);
  L.dh = off;      // (TM, H) float32
  off += align128(tm * H * 4);
  L.dz = off;      // (TM, lda), trunk dtype
  off += align128(tm * lda * act);
  L.stage = off;   // per-warp 16 x 16 float32 staging (bf16 trunk)
  off += bf16 ? WARPS * 256 * 4 : 0;
  L.dtile = off;   // directions (TM, K_PAD)
  off += align128(tm * K_PAD * 4);
  L.gtile = off;   // output cotangent (TM, C_PAD)
  off += align128(tm * C_PAD * 4);
  L.ttile = off;   // targets
  off += align128(tm * C_PAD * 4);
  L.swtile = off;  // pixel weights
  off += align128(tm * C_PAD * 4);
  L.ltile = off;   // loss terms rs * r
  off += align128(tm * C_PAD * 4);
  L.img = off;     // per-image sums of this CTA
  off += align128((size_t)image_values(film, H, n_mm) * 4);
  L.wacc = off;    // loss and small weight sums of this CTA
  off += align128((size_t)weight_values(film, H, n_mm) * 4);
  L.total = off;
  return L;
}

template <bool FILM, bool BF16, bool FAST, int ACT>
__global__ void __launch_bounds__(THREADS) trunk_step(Args g) {
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
  float* tt = reinterpret_cast<float*>(smem + lay.ttile);
  float* st = reinterpret_cast<float*>(smem + lay.swtile);
  float* lt = reinterpret_cast<float*>(smem + lay.ltile);
  float* img = reinterpret_cast<float*>(smem + lay.img);
  float* wacc = reinterpret_cast<float*>(smem + lay.wacc);
  const int n_img = image_values(FILM, H, n_mm), n_w = weight_values(FILM, H, n_mm);
  float* mse_acc = wacc;
  float* dbs_acc = mse_acc + C_PAD;
  float* dwf_acc = dbs_acc + (size_t)bias_rows(FILM, n_mm) * H;
  float* dbf_acc = dwf_acc + (size_t)H * C_PAD;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const float* d = g.d + b * g.d_bstride;
  const float* a = g.a + (size_t)b * K_PAD * H;
  const float* b0 = FILM ? nullptr : g.b0 + (size_t)b * H;
  const float* fr = FILM ? g.fr + (size_t)b * n_act * H : nullptr;
  const float* ph = FILM ? g.ph + (size_t)b * n_act * H : nullptr;
  const float* bm = g.bm + (size_t)b * C_PAD;
  const act_t* ws = static_cast<const act_t*>(g.ws);
  const act_t* wf = static_cast<const act_t*>(g.wf);
  const act_t* h_last = hs + (size_t)n_mm * TM * lda;
  const size_t rows = (size_t)gridDim.y * g.P;
  act_t* sc_h = static_cast<act_t*>(g.sc_h);
  act_t* sc_dz = static_cast<act_t*>(g.sc_dz);

  for (int i = threadIdx.x; i < n_img; i += THREADS) img[i] = 0.0f;
  for (int i = threadIdx.x; i < n_w; i += THREADS) wacc[i] = 0.0f;
  __syncthreads();

  // activation of layer `layer` at (r, c) from its accumulator: the
  // activation goes to hs (rounded for the next product), the cos factor
  // (Cond-by-Concat) or the pre-modulation value (FiLM) to keep
  auto store_act = [&](int layer, int r, int c, float acc) {
    float s, kept;
    if constexpr (FILM) {
      kept = acc + g.bs[(size_t)layer * H + c];
      s = sine<FAST>(__fadd_rn(__fmul_rn(fr[layer * H + c], kept), ph[layer * H + c]));
    } else {
      const float x = layer == 0 ? g.omega0 * (acc + b0[c])
                                 : g.omega_h * (acc + g.bs[(size_t)(layer - 1) * H + c]);
      sine_cosine<FAST>(x, &s, &kept);
    }
    keep[((size_t)layer * TM + r) * H + c] = kept;
    put(hs + ((size_t)layer * TM + r) * lda + c, s);
  };

  for (int t = 0; t < g.tiles_per_cta; ++t) {
    const int p0 = (chunk * g.tiles_per_cta + t) * TM;
    if (p0 >= g.P) break;  // the same for every thread of the CTA
    const int valid = min(TM, g.P - p0);
    const size_t row0 = (size_t)b * g.P + p0;
    for (int i = threadIdx.x; i < TM * K_PAD; i += THREADS) {
      const int r = i / K_PAD, k = i % K_PAD, p = p0 + r;
      const bool in = p < g.P;
      dt[i] = in ? d[(size_t)p * K_PAD + k] : 0.0f;
      tt[i] = in ? g.tgt[(row0 + r) * C_PAD + k] : 0.0f;
      st[i] = in ? g.sw[(size_t)p * C_PAD + k] : 0.0f;
    }
    __syncthreads();

    // forward, keeping every layer
    for (int i = threadIdx.x; i < TM * H; i += THREADS) {
      const int r = i / H, c = i - r * H;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K_PAD; ++k)
        acc = fmaf(rnd<BF16>(dt[r * K_PAD + k]), rnd<BF16>(a[k * H + c]), acc);
      store_act(0, r, c, acc);
    }
    __syncthreads();
    for (int l = 1; l <= n_mm; ++l) {
      const act_t* w = ws + (size_t)(l - 1) * H * H;
      const act_t* hin = hs + (size_t)(l - 1) * TM * lda;
      auto epi = [&](int r, int c, float acc) { store_act(l, r, c, acc); };
      if constexpr (BF16) {
        hidden_layer_bf16(hin, w, stage, H, lda, epi);
      } else {
        hidden_layer_f32<TM>(hin, w, H, lda, epi);
      }
      __syncthreads();
    }
    for (int l = 0; l < n_mm; ++l)
      store_rows(hs + (size_t)l * TM * lda, sc_h + ((size_t)l * rows + row0) * H, valid, H, lda);

    // output layer, activation, loss terms and the output cotangent
    for (int i = threadIdx.x; i < TM * C_PAD; i += THREADS) {
      const int r = i / C_PAD, c = i % C_PAD;
      float acc = 0.0f;
      for (int k = 0; k < H; ++k)
        acc = fmaf(get(h_last[(size_t)r * lda + k]), get(wf[k * C_PAD + c]), acc);
      const float o = acc + g.bf[c];
      float out = o, dact = 1.0f;
      if (ACT == ACT_TANH) {
        out = tanhf(o);
        dact = __fsub_rn(1.0f, __fmul_rn(out, out));
      } else if (ACT == ACT_EXP) {
        out = expf(o);
        dact = out;
      }
      float loss = 0.0f, gv = 0.0f;
      if (r < valid) {
        const float res = __fsub_rn(out, tt[i]);
        const float rs = __fmul_rn(res, __fmul_rn(st[i], bm[c]));
        loss = __fmul_rn(rs, res);
        gv = __fmul_rn(g.gscale2, rs);
        if (ACT != ACT_NONE) gv = __fmul_rn(gv, dact);
      }
      lt[i] = loss;
      gt[i] = gv;
    }
    __syncthreads();

    // final layer: dh = g @ Wf^T; dWf += h_last^T g; dbf += sum g; mse += sum loss
    for (int i = threadIdx.x; i < TM * H; i += THREADS) {
      const int r = i / H, n = i - r * H;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < C_PAD; ++c)
        s = fmaf(rnd<BF16>(gt[r * C_PAD + c]), get(wf[n * C_PAD + c]), s);
      dh[i] = s;
    }
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
      float sg = 0.0f, sl = 0.0f;
      for (int r = 0; r < TM; ++r) {
        sg += gt[r * C_PAD + threadIdx.x];
        sl += lt[r * C_PAD + threadIdx.x];
      }
      dbf_acc[threadIdx.x] += sg;
      mse_acc[threadIdx.x] += sl;
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
          dbs_acc[(size_t)i * H + n] += sb;
        }
        __syncthreads();
        store_rows(dz, sc_dz + ((size_t)i * rows + row0) * H, valid, H, lda);
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
          const float f = fr[i * H + n], p = ph[i * H + n];
          float s_fr = 0.0f, s_ph = 0.0f, s_bs = 0.0f, sa[K_PAD];
#pragma unroll
          for (int k = 0; k < K_PAD; ++k) sa[k] = 0.0f;
          for (int r = 0; r < TM; ++r) {
            const float pre = pre_i[r * H + n];
            const float c = cosine<FAST>(__fadd_rn(__fmul_rn(f, pre), p));
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
          dbs_acc[(size_t)i * H + n] += s_bs;
          if (i == 0) {
#pragma unroll
            for (int k = 0; k < K_PAD; ++k) img[k * H + n] += sa[k];
          }
        }
        __syncthreads();
        if (i > 0) {
          store_rows(dz, sc_dz + ((size_t)(i - 1) * rows + row0) * H, valid, H, lda);
          input_grad<BF16>(dz, ws + (size_t)(i - 1) * H * H, dh, H, lda);
          __syncthreads();
        }
      }
    }
  }

  float* part_img = g.part_img + ((size_t)b * g.n_chunks + chunk) * n_img;
  for (int i = threadIdx.x; i < n_img; i += THREADS) part_img[i] = img[i];
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + chunk) * n_w;
  for (int i = threadIdx.x; i < n_w; i += THREADS) part_w[i] = wacc[i];
}

using KernelFn = void (*)(Args);

template <bool FILM, bool BF16, bool FAST>
KernelFn pick_act(int act) {
  if (act == ACT_TANH) return trunk_step<FILM, BF16, FAST, ACT_TANH>;
  if (act == ACT_EXP) return trunk_step<FILM, BF16, FAST, ACT_EXP>;
  return trunk_step<FILM, BF16, FAST, ACT_NONE>;
}

template <bool FILM>
KernelFn pick(int bf16, int fast, int act) {
  if (bf16) return fast ? pick_act<FILM, true, true>(act) : pick_act<FILM, true, false>(act);
  return fast ? pick_act<FILM, false, true>(act) : pick_act<FILM, false, false>(act);
}

// Work space and results of one call beside the kernel's own arguments:
// out_img (B, n_img) and out_w (n_w) receive the sums of the slots, dws
// (n_mm, H, H) the hidden weight gradients from the split-K partials.
struct Sums {
  float* out_img;
  float* out_w;
  float* part_dws;
  float* dws;
  int rows_per_chunk, n_wchunks;
};

// The chain kernel, the slot sums and the weight-gradient product on one
// stream. Returns a cudaError_t.
template <bool FILM>
int launch(const Args& g, const Sums& o, int batch, int bf16, int fast, int act,
           void* stream) {
  const KernelFn kern = pick<FILM>(bf16, fast, act);
  const size_t smem = layout(FILM, bf16 != 0, g.H, g.n_mm).total;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(g.n_chunks, batch), THREADS, smem, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(g.part_img, o.out_img, batch, g.n_chunks,
                      image_values(FILM, g.H, g.n_mm), s);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(g.part_w, o.out_w, 1, batch * g.n_chunks,
                      weight_values(FILM, g.H, g.n_mm), s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_weight_grads(bf16 != 0, g.sc_h, g.sc_dz, o.part_dws, o.dws,
                                  (long long)batch * g.P, o.rows_per_chunk, o.n_wchunks, g.H,
                                  g.n_mm, s);
}

}  // namespace reni_step
