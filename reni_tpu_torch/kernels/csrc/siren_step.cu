// Fused SIREN train step for Hopper (sm_90a): forward, weighted-MSE loss and
// the whole backward of the Cond-by-Concat trunk.
//
// Replaces the Pallas kernel _step_kernel of reni_tpu/kernels/siren_pallas.py
// (entry fused_step_mse), the FIT_DECODER objective.
//
// What it computes, per image b and pixel tile; all operands and results
// float32:
//   - the forward with the joint sincos, keeping every layer's activation
//     h_i and cos factor c_i: h_0 = sin(omega0 (d A_b + b0_b)),
//     h_i = sin(omega_h (h_{i-1} W_{i-1} + bs_{i-1})), o = h_L Wf + bf;
//   - out = act(o) (tanh, exp or none) and act'(o); r = out - tgt;
//     rs = r * (sw * bm_b); loss partials mse[lane] += sum rs * r; the output
//     cotangent g = (2 gscale) rs act'(o), gscale = 1 / (P * out_features);
//   - the backward chain of _bwd_kernel without the forward again:
//     dWf += h_L^T g, dbf += sum g, dh = g Wf^T; for i = L-1..0:
//     dz = dh * (omega_h c_{i+1}), dWs_i += h_i^T dz, dbs_i += sum dz,
//     dh = dz W_i^T; then dz0 = dh * (omega0 c_0), dA_b += d^T dz0,
//     db0_b += sum dz0.
// With the bf16 trunk both operands of every product are rounded to bf16
// (g, dz and d too) and summed in float32, as JAX's _dot does; the loss and
// the bias sums take the float32 values. Padded lanes (3..7) and rows past P
// carry sw = 0, so they add exact zeros.
//
// What bounds it on the H100: tensor-core operations (1.97e6 FLOP per pixel
// at 5 x 256 against 64 B of directions, target and weight read). The design:
//   - the TPU grid is sequential and accumulates every output across grid
//     steps; CTAs run concurrently here. One CTA per (image, chunk of
//     consecutive 16-row tiles; 8 rows with the float32 trunk) keeps its sums
//     in shared memory: dA, db0 go to its slot of a (B, chunks, 9H) buffer;
//     the loss partials, dbs, dWf, dbf to its slot of a (B * chunks, n_w)
//     buffer; reduce_slots adds the slots in a fixed order;
//   - dWs (L x H x H) fits in no CTA: the kernel writes each tile's h_i and
//     dz_i to a device scratch and a split-K GEMM (siren_chain.cuh) forms
//     h_i^T dz_i, its partials summed in chunk order. No float atomicAdd
//     anywhere: two calls on the same inputs give the same bits;
//   - the products are those of siren_bwd.cu: wmma 16x16x16 bf16 with float32
//     accumulators for H x H, FMA loops for K = 8 and N = 8 and for the
//     float32 trunk.
// So one call is the chain kernel, the GEMM and three small sums: five
// launches on one stream, where the TPU kernel is one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "siren_chain.cuh"

namespace {

using namespace nvcuda;
using namespace reni;

enum { ACT_NONE = 0, ACT_TANH = 1, ACT_EXP = 2 };

struct Args {
  const float* d;       // (B_d, P, K_PAD) direction features
  long long d_bstride;  // elements between images of d; 0 = one shared grid
  const float* a;       // (B, K_PAD, H) per-image first-layer weight
  const float* b0;      // (B, H) first-layer bias
  const void* ws;       // (L, H, H) hidden weights, bf16 or float32
  const float* bs;      // (L, H)
  const void* wf;       // (H, C_PAD) final weight, bf16 or float32
  const float* bf;      // (C_PAD,)
  const float* tgt;     // (B, P, C_PAD) targets
  const float* sw;      // (P, C_PAD) pixel weights, shared by the images
  const float* bm;      // (B, C_PAD) batch mask
  float* part_img;      // (B, n_chunks, 9H) per-image partial sums
  float* part_w;        // (B * n_chunks, n_w) loss and small weight sums
  void* sc_h;           // (L, B * P, H) activations h_0..h_{L-1}, trunk dtype
  void* sc_dz;          // (L, B * P, H) cotangents dz_0..dz_{L-1}
  int P, H, n_mm, tiles_per_cta, n_chunks;
  float omega0, omega_h, gscale2;
};

// Per-image values dA (8H) | db0 (H); per-CTA weight sums
// mse (8) | dbs (L H) | dWf (8 H) | dbf (8).
__host__ __device__ inline int image_values(int H) { return (K_PAD + 1) * H; }
__host__ __device__ inline int weight_values(int H, int n_mm) {
  return C_PAD + n_mm * H + H * C_PAD + C_PAD;
}

// Shared-memory layout of one CTA (byte offsets). kernels/siren_step.py
// mirrors it in step_smem_bytes.
struct Layout {
  size_t hs, cs, dh, dz, stage, dtile, gtile, ttile, swtile, ltile, img, wacc, total;
};

__host__ __device__ inline Layout layout(bool bf16, int H, int n_mm) {
  const size_t tm = tile_rows(bf16), act = bf16 ? 2 : 4, lda = H + ROW_PAD, n_act = n_mm + 1;
  Layout L;
  size_t off = 0;
  L.hs = off;      // activations, (n_act, TM, lda), trunk dtype
  off += align128(n_act * tm * lda * act);
  L.cs = off;      // cos factors, (n_act, TM, H)
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
  off += align128((size_t)image_values(H) * 4);
  L.wacc = off;    // loss and small weight sums of this CTA
  off += align128((size_t)weight_values(H, n_mm) * 4);
  L.total = off;
  return L;
}

template <bool BF16, bool FAST, int ACT>
__global__ void __launch_bounds__(THREADS) trunk_step(Args g) {
  using act_t = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int TM = tile_rows(BF16);
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = g.H, lda = H + ROW_PAD, n_mm = g.n_mm;
  const Layout lay = layout(BF16, H, n_mm);
  act_t* hs = reinterpret_cast<act_t*>(smem + lay.hs);
  float* cs = reinterpret_cast<float*>(smem + lay.cs);
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
  const int n_img = image_values(H), n_w = weight_values(H, n_mm);
  float* mse_acc = wacc;
  float* dbs_acc = mse_acc + C_PAD;
  float* dwf_acc = dbs_acc + (size_t)n_mm * H;
  float* dbf_acc = dwf_acc + (size_t)H * C_PAD;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const float* d = g.d + b * g.d_bstride;
  const float* a = g.a + (size_t)b * K_PAD * H;
  const float* b0 = g.b0 + (size_t)b * H;
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

  // activation of layer `layer` at (r, c) from its pre-activation x
  auto store_act = [&](int layer, int r, int c, float x) {
    float s, co;
    sine_cosine<FAST>(x, &s, &co);
    cs[((size_t)layer * TM + r) * H + c] = co;
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
      store_act(0, r, c, g.omega0 * (acc + b0[c]));
    }
    __syncthreads();
    for (int l = 1; l <= n_mm; ++l) {
      const act_t* w = ws + (size_t)(l - 1) * H * H;
      const act_t* hin = hs + (size_t)(l - 1) * TM * lda;
      const float* bias = g.bs + (size_t)(l - 1) * H;
      auto epi = [&](int r, int c, float acc) {
        store_act(l, r, c, g.omega_h * (acc + bias[c]));
      };
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

    for (int i = n_mm - 1; i >= 0; --i) {
      const float* c_next = cs + (size_t)(i + 1) * TM * H;
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
        const float v = __fmul_rn(dh[r * H + n], __fmul_rn(g.omega0, cs[r * H + n]));
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
  }

  float* part_img = g.part_img + ((size_t)b * g.n_chunks + chunk) * n_img;
  for (int i = threadIdx.x; i < n_img; i += THREADS) part_img[i] = img[i];
  float* part_w = g.part_w + ((size_t)b * g.n_chunks + chunk) * n_w;
  for (int i = threadIdx.x; i < n_w; i += THREADS) part_w[i] = wacc[i];
}

using KernelFn = void (*)(Args);

template <bool BF16, bool FAST>
KernelFn pick_act(int act) {
  if (act == ACT_TANH) return trunk_step<BF16, FAST, ACT_TANH>;
  if (act == ACT_EXP) return trunk_step<BF16, FAST, ACT_EXP>;
  return trunk_step<BF16, FAST, ACT_NONE>;
}

KernelFn pick(int bf16, int fast, int act) {
  if (bf16) return fast ? pick_act<true, true>(act) : pick_act<true, false>(act);
  return fast ? pick_act<false, true>(act) : pick_act<false, false>(act);
}

}  // namespace

extern "C" {

// The train step (replaces _step_kernel). out_img (B, 9H) receives
// dA (B, 8, H) | db0 (B, H); out_w (n_w) receives mse (8) | dbs (L, H) |
// dWf (H, 8) | dbf (8); dws (L, H, H) the hidden weight gradients. part_*,
// sc_* and part_dws are work space. act: 0 none, 1 tanh, 2 exp. Returns a
// cudaError_t.
int reni_siren_step(const float* d, long long d_bstride, const float* a, const float* b0,
                    const void* ws, const float* bs, const void* wf, const float* bf,
                    const float* tgt, const float* sw, const float* bm, float* part_img,
                    float* out_img, float* part_w, float* out_w, void* sc_h, void* sc_dz,
                    float* part_dws, float* dws, int batch, int P, int H, int n_hidden,
                    int tiles_per_cta, int n_chunks, int rows_per_chunk, int n_wchunks,
                    float omega0, float omega_h, float gscale, int bf16, int fast, int act,
                    void* stream) {
  const Args args{d, d_bstride, a, b0, ws, bs, wf, bf, tgt, sw, bm, part_img, part_w, sc_h,
                  sc_dz, P, H, n_hidden, tiles_per_cta, n_chunks, omega0, omega_h,
                  2.0f * gscale};
  const KernelFn kern = pick(bf16, fast, act);
  const size_t smem = layout(bf16 != 0, H, n_hidden).total;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(n_chunks, batch), THREADS, smem, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(part_img, out_img, batch, n_chunks, image_values(H), s);
  if (err != cudaSuccess) return (int)err;
  err = launch_reduce(part_w, out_w, 1, batch * n_chunks, weight_values(H, n_hidden), s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_weight_grads(bf16 != 0, sc_h, sc_dz, part_dws, dws,
                                  (long long)batch * P, rows_per_chunk, n_wchunks, H, n_hidden,
                                  s);
}

// Bytes of shared memory one CTA takes (kernels/siren_step.py mirrors this).
int reni_step_smem_bytes(int bf16, int H, int n_mm) {
  return (int)layout(bf16 != 0, H, n_mm).total;
}

const char* reni_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
