// Device code shared by the training kernels (siren_bwd.cuh, siren_step.cuh):
// the tile geometry, one hidden layer of the forward, dh = dz @ W^T, and the
// weight-gradient reduction that needs no float atomics.
//
// Weight gradients without atomics. dWs_i = h_i^T dz_i sums over every pixel
// row of every image, and no CTA can hold L x H x H float32 accumulators. So
// the chain kernel writes each tile's h_i and dz_i (trunk dtype) to a device
// scratch (L, rows, H), and a second kernel (wgrad_bf16 / wgrad_f32) forms
// the products as a split-K GEMM: one CTA per (output tile, chunk of rows,
// layer) writes its partial to its own slot, and reduce_slots adds the slots
// in chunk order. The small sums (dbs, dWf, dbf, loss partials) go through
// per-CTA slots and the same reduce_slots. Every sum has a fixed order, so
// two calls on the same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "siren_common.cuh"

namespace reni {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_PAD = 8;  // elements of padding per activation row

__host__ __device__ constexpr int tile_rows(bool bf16) { return bf16 ? 16 : 8; }

// One hidden layer of a 16-row tile: epi(r, c, sum_k hin[r][k] W[k][c]) for
// every (r, c); one 16-column strip per warp.
template <typename Epi>
__device__ __forceinline__ void hidden_layer_bf16(const __nv_bfloat16* hin,
                                                  const __nv_bfloat16* w, float* stage, int H,
                                                  int lda, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
  for (int ct = warp; ct < H / 16; ct += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(af, hin + k, lda);
      wmma::load_matrix_sync(bf, w + (size_t)k * H + ct * 16, H);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(e / 16, ct * 16 + e % 16, st[e]);
    __syncwarp();
  }
}

// The same for a float32 tile of TM rows (FMA loops, no TF32).
template <int TM, typename Epi>
__device__ __forceinline__ void hidden_layer_f32(const float* hin, const float* w, int H,
                                                 int lda, Epi epi) {
  for (int i = threadIdx.x; i < TM * H; i += THREADS) {
    const int r = i / H, c = i - r * H;
    const float* x = hin + (size_t)r * lda;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(x[k], w[(size_t)k * H + c], acc);
    epi(r, c, acc);
  }
}

// dh (TM x H, float32) = dz @ W^T.
template <bool BF16, typename act_t>
__device__ void input_grad(const act_t* dz, const act_t* w, float* dh, int H, int lda) {
  if constexpr (BF16) {
    const int warp = threadIdx.x / 32;
    for (int ct = warp; ct < H / 16; ct += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < H; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(af, dz + k, lda);
        wmma::load_matrix_sync(bf, w + (size_t)ct * 16 * H + k, H);  // B(k, n) = W[n][k]
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(dh + ct * 16, acc, H, wmma::mem_row_major);
    }
  } else {
    constexpr int TM = tile_rows(false);
    for (int i = threadIdx.x; i < TM * H; i += THREADS) {
      const int r = i / H, n = i - r * H;
      const float* x = dz + (size_t)r * lda;
      const float* wn = w + (size_t)n * H;
      float s = 0.0f;
      for (int k = 0; k < H; ++k) s = fmaf(x[k], wn[k], s);
      dh[i] = s;
    }
  }
}

// Copy the first `valid` rows of a shared-memory tile (row pitch lda) to
// row-major device memory (row pitch H), 16 bytes at a time.
template <typename act_t>
__device__ __forceinline__ void store_rows(const act_t* tile, act_t* dst, int valid, int H,
                                           int lda) {
  const int per_row = H * (int)sizeof(act_t) / 16;
  for (int i = threadIdx.x; i < valid * per_row; i += THREADS) {
    const int r = i / per_row, c = i - r * per_row;
    reinterpret_cast<uint4*>(dst + (size_t)r * H)[c] =
        reinterpret_cast<const uint4*>(tile + (size_t)r * lda)[c];
  }
}

// out[b][j] = sum over slots, in slot order, of part[b][slot][j].
static __global__ void reduce_slots(const float* part, float* out, int n_slots, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float* p = part + (size_t)blockIdx.y * n_slots * n + j;
  float s = 0.0f;
  for (int c = 0; c < n_slots; ++c) s += p[(size_t)c * n];
  out[(size_t)blockIdx.y * n + j] = s;
}

static inline cudaError_t launch_reduce(const float* part, float* out, int batch, int n_slots,
                                        long long n, cudaStream_t s) {
  reduce_slots<<<dim3((unsigned)((n + 255) / 256), batch), 256, 0, s>>>(part, out, n_slots, n);
  return cudaGetLastError();
}

// part[chunk][layer] (H x H) = sum over the chunk's rows of
// h[layer][row][:]^T dz[layer][row][:]; bf16 operands, float32 sums. A CTA
// owns a 128 x 128 output tile (8 warps x 2 x 4 wmma tiles) and walks its
// rows 32 at a time through shared memory. Grid: (output tiles, chunks,
// layers), the tiles fastest so that the CTAs reading the same rows run
// together.
constexpr int WG_BM = 128, WG_KT = 32, WG_PITCH = WG_BM + 8;

static __global__ void __launch_bounds__(THREADS)
wgrad_bf16(const __nv_bfloat16* h, const __nv_bfloat16* dz, float* part, long long rows,
           int rows_per_chunk, int H) {
  __shared__ __align__(128) __nv_bfloat16 sh[WG_KT * WG_PITCH];
  __shared__ __align__(128) __nv_bfloat16 sz[WG_KT * WG_PITCH];
  const int tiles_n = (H + WG_BM - 1) / WG_BM;
  const int m0 = (blockIdx.x / tiles_n) * WG_BM, n0 = (blockIdx.x % tiles_n) * WG_BM;
  const int chunk = blockIdx.y, layer = blockIdx.z, n_layers = gridDim.z;
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  const long long row0 = (long long)chunk * rows_per_chunk;
  const long long row_end = min(rows, row0 + (long long)rows_per_chunk);
  h += (size_t)layer * rows * H;
  dz += (size_t)layer * rows * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long k0 = row0; k0 < row_end; k0 += WG_KT) {
    for (int i = threadIdx.x; i < WG_KT * (WG_BM / 8); i += THREADS) {
      const int r = i / (WG_BM / 8), c = (i % (WG_BM / 8)) * 8;
      const long long row = k0 + r;
      uint4 vh = make_uint4(0, 0, 0, 0), vz = vh;
      if (row < row_end) {
        if (m0 + c < H) vh = *reinterpret_cast<const uint4*>(h + (size_t)row * H + m0 + c);
        if (n0 + c < H) vz = *reinterpret_cast<const uint4*>(dz + (size_t)row * H + n0 + c);
      }
      *reinterpret_cast<uint4*>(sh + r * WG_PITCH + c) = vh;
      *reinterpret_cast<uint4*>(sz + r * WG_PITCH + c) = vz;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WG_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // A(m, k) = h[k][m]
        wmma::load_matrix_sync(af[i], sh + kk * WG_PITCH + wm + i * 16, WG_PITCH);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], sz + kk * WG_PITCH + wn + j * 16, WG_PITCH);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + ((size_t)chunk * n_layers + layer) * H * H;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + wm + i * 16, gn = n0 + wn + j * 16;
      if (gm < H && gn < H)
        wmma::store_matrix_sync(out + (size_t)gm * H + gn, acc[i][j], H, wmma::mem_row_major);
    }
}

// The same product for the float32 trunk: FMA loops, a 64 x 64 output tile
// per CTA, 4 x 4 outputs per thread, 16 rows at a time.
constexpr int WF_BM = 64, WF_KT = 16;

static __global__ void __launch_bounds__(THREADS)
wgrad_f32(const float* h, const float* dz, float* part, long long rows, int rows_per_chunk,
          int H) {
  __shared__ __align__(16) float sh[WF_KT * WF_BM];
  __shared__ __align__(16) float sz[WF_KT * WF_BM];
  const int tiles_n = (H + WF_BM - 1) / WF_BM;
  const int m0 = (blockIdx.x / tiles_n) * WF_BM, n0 = (blockIdx.x % tiles_n) * WF_BM;
  const int chunk = blockIdx.y, layer = blockIdx.z, n_layers = gridDim.z;
  const int tm = (threadIdx.x / 16) * 4, tn = (threadIdx.x % 16) * 4;
  const long long row0 = (long long)chunk * rows_per_chunk;
  const long long row_end = min(rows, row0 + (long long)rows_per_chunk);
  h += (size_t)layer * rows * H;
  dz += (size_t)layer * rows * H;
  float acc[4][4] = {};
  for (long long k0 = row0; k0 < row_end; k0 += WF_KT) {
    {
      const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
      const long long row = k0 + r;
      float4 vh = make_float4(0.f, 0.f, 0.f, 0.f), vz = vh;
      if (row < row_end) {
        if (m0 + c < H) vh = *reinterpret_cast<const float4*>(h + (size_t)row * H + m0 + c);
        if (n0 + c < H) vz = *reinterpret_cast<const float4*>(dz + (size_t)row * H + n0 + c);
      }
      *reinterpret_cast<float4*>(sh + r * WF_BM + c) = vh;
      *reinterpret_cast<float4*>(sz + r * WF_BM + c) = vz;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WF_KT; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(sh + k * WF_BM + tm);
      const float4 y = *reinterpret_cast<const float4*>(sz + k * WF_BM + tn);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + ((size_t)chunk * n_layers + layer) * H * H;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m0 + tm + i < H && n0 + tn + j < H)
        out[(size_t)(m0 + tm + i) * H + n0 + tn + j] = acc[i][j];
}

// dws (n_layers, H, H) = h^T dz over all rows, from the scratch the chain
// kernel filled: split-K partials into `part` (n_chunks, n_layers, H, H),
// then their sum in chunk order (left out with reduce = false, which only the
// anatomy probes ask for).
static inline cudaError_t launch_weight_grads(bool bf16, const void* h, const void* dz,
                                              float* part, float* dws, long long rows,
                                              int rows_per_chunk, int n_chunks, int H,
                                              int n_layers, cudaStream_t s,
                                              bool reduce = true) {
  if (n_layers == 0) return cudaSuccess;
  if (bf16) {
    const int t = (H + WG_BM - 1) / WG_BM;
    wgrad_bf16<<<dim3(t * t, n_chunks, n_layers), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(dz), part, rows,
        rows_per_chunk, H);
  } else {
    const int t = (H + WF_BM - 1) / WF_BM;
    wgrad_f32<<<dim3(t * t, n_chunks, n_layers), THREADS, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(dz), part, rows, rows_per_chunk,
        H);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return err;
  return launch_reduce(part, dws, 1, n_chunks, (long long)n_layers * H * H, s);
}

}  // namespace reni
