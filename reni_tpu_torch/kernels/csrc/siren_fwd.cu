// Fused SIREN / FiLM decoder forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels of reni_tpu/kernels/siren_pallas.py:
//   - _fwd_kernel       (Cond-by-Concat trunk, entry fused_apply)
//   - _film_fwd_kernel  (FiLM trunk, entry fused_film_apply)
// with one templated kernel (FILM flag, trunk dtype flag, fast-sine flag).
//
// What it computes (per image b, per pixel p; all operands float32):
//   Cond-by-Concat: h = sin(w0 * (d @ A_b + b0_b));  L x h = sin(wh * (h @ W_i + b_i));
//   FiLM:           h = sin(f_0 * (d @ A0_b + bs_0) + p_0);
//                   (T-1) x h = sin(f_i * (h @ W_{i-1} + bs_i) + p_i);
//   both:           out = h @ Wf + bf                      -> (B, P, 8)
// With the bf16 trunk both operands of every product (d @ A, h @ W, h @ Wf)
// are rounded to bf16 (round to nearest even) and summed in float32, as
// JAX's _matmul does; bias, omega and sine are float32, and the activation
// is rounded to bf16 once, for the next product. The order is
// omega * (acc + bias), never omega*acc + omega*bias.
//
// What bounds it on the H100: tensor-core operations. Per pixel, 5 x 256 x 256
// multiply-adds (~6.6e5 FLOP) against ~1.5e3 sines and 32 bytes written;
// weights (5 x 128 KB in bf16) are read by every CTA from L2. The design:
//   - one CTA per (image, 64-pixel tile); the tile's activations stay in
//     shared memory (two bf16 buffers, ping-pong) across all layers, so no
//     (B, P, H) tensor ever goes to device memory;
//   - hidden layers are wmma 16x16x16 bf16 products with float32
//     accumulators: each warp owns 16-column strips of the output and
//     reads each B fragment once per CTA from global/L2, reusing it over the
//     four 16-row tiles; the epilogue (bias, omega, sine, bf16 cast) runs
//     from a per-warp float32 staging tile;
//   - the K = 8 first layer and the N = 8 final layer are plain FMA loops
//     on the same bf16-rounded inputs (too narrow for a tensor-core tile);
//   - with the float32 trunk the same kernel runs an FMA loop instead of
//     wmma (no TF32: JAX's float32 trunk is full float32);
//   - the exact sine is sinf with full range reduction; the fast sine is
//     core/fastmath.py's polynomial (siren_common.cuh);
//   - a ragged tail tile is masked (rows past P read zeros, write nothing).
// Rows of the activation buffers are padded by 8 elements to spread the
// wmma row loads over the shared-memory banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "siren_common.cuh"

namespace {

using namespace nvcuda;
using namespace reni;

constexpr int TM = 64;  // pixel rows per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_PAD = 8;  // elements of padding per activation row

struct Args {
  const float* d;        // (B_d, P, K_PAD) direction features
  long long d_bstride;   // elements between images of d; 0 = one shared grid
  const float* a;        // (B, K_PAD, H) per-image first-layer weight
  const float* b0;       // (B, H) Cond-by-Concat first-layer bias; unused by FiLM
  const void* ws;        // (n_mm, H, H) hidden weights, bf16 or float32
  const float* bs;       // Cond-by-Concat (n_mm, H); FiLM (n_mm + 1, H)
  const void* wf;        // (H, C_PAD) final weight, bf16 or float32
  const float* bf;       // (C_PAD,)
  const float* fr;       // FiLM (B, (n_mm + 1) * H) scaled frequencies
  const float* ph;       // FiLM (B, (n_mm + 1) * H) phase shifts
  float* out;            // (B, P, C_PAD)
  int P, H, n_mm;        // n_mm: number of H x H products
  float omega0, omega_h;
};

// Bias, modulation and sine of layer `layer` (0 = first layer) at column c.
template <bool FILM, bool FAST>
__device__ __forceinline__ float activate(const Args& g, int b, int layer, int c, float acc) {
  if (FILM) {
    const size_t m = ((size_t)b * (g.n_mm + 1) + layer) * g.H + c;
    const float pre = acc + g.bs[(size_t)layer * g.H + c];
    return sine<FAST>(__fadd_rn(__fmul_rn(g.fr[m], pre), g.ph[m]));
  }
  if (layer == 0) return sine<FAST>(g.omega0 * (acc + g.b0[(size_t)b * g.H + c]));
  return sine<FAST>(g.omega_h * (acc + g.bs[(size_t)(layer - 1) * g.H + c]));
}

template <bool FILM, bool BF16, bool FAST, typename act_t>
__device__ void first_layer(const Args& g, int b, int p0, act_t* h, int lda) {
  const float* d = g.d + b * g.d_bstride;
  const float* a = g.a + (size_t)b * K_PAD * g.H;
  for (int i = threadIdx.x; i < TM * g.H; i += THREADS) {
    const int r = i / g.H, c = i - r * g.H, p = p0 + r;
    float acc = 0.0f;
    if (p < g.P) {
#pragma unroll
      for (int k = 0; k < K_PAD; ++k)
        acc = fmaf(rnd<BF16>(d[(size_t)p * K_PAD + k]), rnd<BF16>(a[k * g.H + c]), acc);
    }
    put(h + (size_t)r * lda + c, activate<FILM, FAST>(g, b, 0, c, acc));
  }
}

template <bool FILM, bool FAST>
__device__ void hidden_layer_bf16(const Args& g, int b, int layer, const __nv_bfloat16* w,
                                  const __nv_bfloat16* hin, __nv_bfloat16* hout,
                                  float* scratch, int lda) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, H = g.H;
  float* stage = scratch + warp * 256;
  for (int ct = warp; ct < H / 16; ct += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
    for (int rt = 0; rt < TM / 16; ++rt) wmma::fill_fragment(acc[rt], 0.0f);
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, w + (size_t)k * H + ct * 16, H);
#pragma unroll
      for (int rt = 0; rt < TM / 16; ++rt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, hin + (size_t)rt * 16 * lda + k, lda);
        wmma::mma_sync(acc[rt], afrag, bfrag, acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < TM / 16; ++rt) {
      wmma::store_matrix_sync(stage, acc[rt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
        put(hout + (size_t)r * lda + c, activate<FILM, FAST>(g, b, layer, c, stage[e]));
      }
      __syncwarp();
    }
  }
}

template <bool FILM, bool FAST>
__device__ void hidden_layer_f32(const Args& g, int b, int layer, const float* w,
                                 const float* hin, float* hout, int lda) {
  for (int i = threadIdx.x; i < TM * g.H; i += THREADS) {
    const int r = i / g.H, c = i - r * g.H;
    const float* x = hin + (size_t)r * lda;
    float acc = 0.0f;
    for (int k = 0; k < g.H; ++k) acc = fmaf(x[k], w[(size_t)k * g.H + c], acc);
    hout[(size_t)r * lda + c] = activate<FILM, FAST>(g, b, layer, c, acc);
  }
}

template <typename act_t>
__device__ void final_layer(const Args& g, int b, int p0, const act_t* h, int lda) {
  const act_t* wf = static_cast<const act_t*>(g.wf);
  for (int i = threadIdx.x; i < TM * C_PAD; i += THREADS) {
    const int r = i / C_PAD, c = i % C_PAD, p = p0 + r;
    if (p >= g.P) continue;
    const act_t* x = h + (size_t)r * lda;
    float acc = 0.0f;
    for (int k = 0; k < g.H; ++k) acc = fmaf(get(x[k]), get(wf[k * C_PAD + c]), acc);
    g.out[((size_t)b * g.P + p) * C_PAD + c] = acc + g.bf[c];
  }
}

template <bool FILM, bool BF16, bool FAST>
__global__ void __launch_bounds__(THREADS) trunk_fwd(Args g) {
  using act_t = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = g.H + ROW_PAD;
  act_t* h0 = reinterpret_cast<act_t*>(smem);
  act_t* h1 = h0 + (size_t)TM * lda;
  float* scratch = reinterpret_cast<float*>(h1 + (size_t)TM * lda);
  const int b = blockIdx.y, p0 = blockIdx.x * TM;

  first_layer<FILM, BF16, FAST>(g, b, p0, h0, lda);
  __syncthreads();
  const act_t* ws = static_cast<const act_t*>(g.ws);
  for (int l = 0; l < g.n_mm; ++l) {
    const act_t* w = ws + (size_t)l * g.H * g.H;
    if constexpr (BF16) {
      hidden_layer_bf16<FILM, FAST>(g, b, l + 1, w, h0, h1, scratch, lda);
    } else {
      hidden_layer_f32<FILM, FAST>(g, b, l + 1, w, h0, h1, lda);
    }
    __syncthreads();
    act_t* t = h0;
    h0 = h1;
    h1 = t;
  }
  final_layer<act_t>(g, b, p0, h0, lda);
}

using KernelFn = void (*)(Args);

template <bool FILM>
KernelFn pick(int bf16, int fast) {
  if (bf16) return fast ? trunk_fwd<FILM, true, true> : trunk_fwd<FILM, true, false>;
  return fast ? trunk_fwd<FILM, false, true> : trunk_fwd<FILM, false, false>;
}

template <bool FILM>
int launch(const Args& g, int batch, int bf16, int fast, void* stream) {
  const size_t act = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t smem = 2 * (size_t)TM * (g.H + ROW_PAD) * act + WARPS * 256 * sizeof(float);
  const KernelFn kern = pick<FILM>(bf16, fast);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.P + TM - 1) / TM, batch);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Cond-by-Concat forward (replaces _fwd_kernel). Returns a cudaError_t.
int reni_siren_fwd(const float* d, long long d_bstride, const float* a, const float* b0,
                   const void* ws, const float* bs, const void* wf, const float* bf,
                   float* out, int batch, int P, int H, int n_hidden, float omega0,
                   float omega_h, int bf16, int fast, void* stream) {
  const Args g{d, d_bstride, a, b0, ws, bs, wf, bf, nullptr, nullptr, out,
               P, H, n_hidden, omega0, omega_h};
  return launch<false>(g, batch, bf16, fast, stream);
}

// FiLM forward (replaces _film_fwd_kernel); n_trunk = T >= 1. Returns a cudaError_t.
int reni_film_fwd(const float* d, long long d_bstride, const float* a0, const void* ws,
                  const float* bs, const void* wf, const float* bf, const float* fr,
                  const float* ph, float* out, int batch, int P, int H, int n_trunk,
                  int bf16, int fast, void* stream) {
  const Args g{d, d_bstride, a0, nullptr, ws, bs, wf, bf, fr, ph, out,
               P, H, n_trunk - 1, 0.0f, 0.0f};
  return launch<true>(g, batch, bf16, fast, stream);
}

const char* reni_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
