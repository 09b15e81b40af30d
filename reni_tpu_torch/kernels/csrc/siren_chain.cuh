// Device code shared by the training kernels (siren_bwd.cuh, siren_step.cuh,
// step_passes.cuh, tiled_passes.cuh): the tile geometry, one hidden layer of
// the forward, dh = dz @ W^T, and the weight-gradient reduction that needs no
// float atomics.
//
// Weight gradients without atomics. dWs_i = h_i^T dz_i sums over every pixel
// row of every image, and no CTA can hold L x H x H float32 accumulators. So
// the kernels write each row's h_i and dz_i (trunk dtype) to a device scratch
// (L, rows, H), and a second kernel forms the products as a split-K GEMM: one
// CTA per (output block, chunk of rows, layer) writes its partial to its own
// slot, and reduce_slots adds the slots in chunk order. In bf16 that kernel
// is wgrad_bf16 (wgmma on MN-major K-slabs that a producer thread brings in
// by tensor-map copies, 128 x up to 256 outputs a CTA), in float32 wgrad_f32
// (FFMA register tiles). The small sums (dbs, dWf, dbf, loss partials) go
// through per-CTA slots and the same reduce_slots. Every sum has a fixed
// order, so two calls on the same inputs give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include "siren_common.cuh"
#include "wgmma.cuh"

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

// out[b][j] = sum over slots, in slot order, of part[b][slot][j]; with
// `block` > 0 the slots are summed `block` at a time and the blocks' sums in
// order. A flat grid (image_grid): blocks of 256 values of one image, the
// values fastest.
static __global__ void reduce_slots(const float* part, float* out, int n_slots, long long n,
                                    int block) {
  const int per = (int)((n + 255) / 256), b = cta_image(per);
  const long long j = (long long)cta_item(per) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float* p = part + (size_t)b * n_slots * n + j;
  const int step = block > 0 ? block : n_slots;
  float s = 0.0f;
  for (int c0 = 0; c0 < n_slots; c0 += step) {
    float t = 0.0f;
    for (int c = c0; c < min(n_slots, c0 + step); ++c) t += p[(size_t)c * n];
    s = c0 == 0 ? t : s + t;
  }
  out[(size_t)b * n + j] = s;
}

// Up to SLOT_SEQ_MAX slots are summed in one sequential sum; more are summed
// SLOT_BLOCK at a time. The rounding error of a sequential float32 sum grows
// with the number of slots: over the 65,536 weight slots of 65,536 images one
// sum missed the float32 step's loss bar (2.4e-6 relative against 1e-6, an
// H100 at 65,536 x 64).
constexpr int SLOT_BLOCK = 256, SLOT_SEQ_MAX = 1024;

static inline cudaError_t launch_reduce(const float* part, float* out, int batch, int n_slots,
                                        long long n, cudaStream_t s) {
  const unsigned grid = image_grid((n + 255) / 256, batch);
  if (grid == 0) return cudaErrorInvalidValue;
  reduce_slots<<<grid, 256, 0, s>>>(part, out, n_slots, n,
                                    n_slots > SLOT_SEQ_MAX ? SLOT_BLOCK : 0);
  return cudaGetLastError();
}

// part[chunk][layer] (H x H) = sum over the chunk's rows of
// h[layer][row][:]^T dz[layer][row][:]; bf16 operands, float32 sums, on the
// tensor cores (wgmma). Replaces no TPU kernel: the Pallas step and backward
// kernels sum dWs in VMEM across their sequential grid, which blocks on
// Hopper cannot do. The product reduces over rows, the slow index of the
// scratch, so both operands are MN-major: A(m, k) = h[k][m] and B(k, n) =
// dz[k][n], each 64 m (n) of a row contiguous. A CTA owns an output block of
// 128 m (two consumer warpgroups of m64) by 64 NB n (NB = 1..4, wgrad_nb: a
// compile-time constant, so no wgmma sits under a branch) of one (chunk,
// layer). The rows come in blocks of rows_per_chunk rows (whole 64-row
// slabs), and chunk c sums blocks c, c + n_chunks, c + 2 n_chunks, ...: each
// block in the tensor cores' accumulators, which are then added to the slot
// in float32 (the first block stored), so that the caller bounds the rows
// one tensor-core sum takes (kernels/siren_bwd.py::wgrad_chunks). One
// producer thread fills a ring of WB_STAGES stages with 64-row K-slabs of
// h[:, m block] and dz[:, n block]: each 64 x 64 box one tensor-map copy
// (tma_load_3d), swizzled on the way, rows past the scratch and columns past
// H zero-filled; a box wholly past H is not copied (it feeds only outputs
// that are never stored). Each consumer warpgroup issues four wgmma
// m64n(64 NB)k16 on a slab, keeps one slab's products in flight and frees
// the slab before it. Grid: (blocks, chunks, layers), the m blocks fastest:
// the CTAs that read the same dz rows run side by side. Where the m blocks
// pair up, a pair is a cluster (CL = 2): each producer copies every other
// dz box and multicasts it into both CTAs, and a stage is free once the
// consumer warps of both have arrived on its barrier in each (on an H100
// dWs 4-8% faster than with single CTAs, which read the shared slab from L2
// twice; the bf16 4 x 512 and 5 x 512 steps 2% faster).
//
// What bounds it on the H100. Per slab a 128 x 256 block does 4.2 MFLOP on
// 48 KB (85 FLOP a byte, under the ridge of 295), and the function itself
// moves 2 H bytes a row of each operand for 2 H^2 FLOP: bytes bound it up to
// H ~ 600, the tensor cores beyond. The ring keeps three slabs (144 KB) in
// flight per SM; setmaxnreg gives the consumers 232 registers a thread for
// their 128 accumulators.
constexpr int WB_BM = 128, WB_BK = 64, WB_STAGES = 4, WB_THREADS = 384;
constexpr int WB_CONSUMERS = 256, WB_CONSUMER_REGS = 232, WB_PRODUCER_REGS = 40;
constexpr uint32_t WB_BOX = 64 * WB_BK * 2;  // bytes of one 64 x 64 box

// 64-column atoms of the n block at width H: the fewest blocks of at most
// 256 columns, as even as whole atoms allow (siren_bwd.py::wgrad_tile)
__host__ __device__ constexpr int wgrad_nb(int H) {
  return ((H + (H + 255) / 256 - 1) / ((H + 255) / 256) + 63) / 64;
}

__host__ __device__ constexpr size_t wgrad_smem(int nb) {
  return (size_t)WB_STAGES * (2 + nb) * WB_BOX + 2 * WB_STAGES * sizeof(uint64_t) + 1024;
}

template <int NB, int CL>
static __global__ void __launch_bounds__(WB_THREADS, 1)
wgrad_bf16(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_dz,
           float* part, long long rows, int rows_per_chunk, int H) {
  using namespace reni_wg;
  constexpr int BN = 64 * NB, NV = BN / 2;
  constexpr uint32_t STAGE = (2 + NB) * WB_BOX;
  extern __shared__ unsigned char wb_raw[];
  unsigned char* smem = aligned_smem(wb_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WB_STAGES * STAGE);
  uint64_t* empty = full + WB_STAGES;
  const int tiles_m = (H + WB_BM - 1) / WB_BM;  // a multiple of CL
  const int m0 = (blockIdx.x % tiles_m) * WB_BM, n0 = (blockIdx.x / tiles_m) * BN;
  const int chunk = blockIdx.y, n_chunks = gridDim.y, layer = blockIdx.z;
  const uint32_t rank = CL > 1 ? cluster_rank() : 0;
  const int n_blocks = (int)((rows + rows_per_chunk - 1) / rows_per_chunk);
  const int mine = chunk < n_blocks ? (n_blocks - chunk + n_chunks - 1) / n_chunks : 0;
  auto slabs = [&](int b) {  // 64-row slabs of block b, the last one ragged
    const long long r = min((long long)rows_per_chunk, rows - (long long)b * rows_per_chunk);
    return (int)((r + WB_BK - 1) / WB_BK);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < WB_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CL * WB_CONSUMERS / 32);  // the consumer warps of the cluster
    }
    mbar_fence_init();
  }
  if constexpr (CL > 1) {
    cluster_sync();  // every CTA's barriers are set before a copy or an arrival reaches them
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= WB_CONSUMERS) {  // the producer: one thread issues the copies in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WB_PRODUCER_REGS));
    if (threadIdx.x == WB_CONSUMERS) {
      auto col = [&](int i) { return i < 2 ? m0 + 64 * i : n0 + 64 * (i - 2); };  // box i's first
      uint32_t bytes = 0;  // this CTA's h boxes and every dz box of the cluster's block
      for (int i = 0; i < 2 + NB; ++i) bytes += col(i) < H ? WB_BOX : 0;
      int it = 0;  // slabs issued so far: the ring's stage and phase
      for (int j = 0; j < mine; ++j) {
        const int b = chunk + j * n_chunks, nk = slabs(b);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int slot = it % WB_STAGES;
          const int row = (int)((long long)b * rows_per_chunk + (long long)kb * WB_BK);
          if (it >= WB_STAGES) mbar_wait(empty + slot, ((it / WB_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + slot, bytes);
          unsigned char* st = smem + slot * STAGE;
          for (int i = 0; i < 2 + NB; ++i) {
            if (col(i) >= H) continue;
            if (i < 2) {
              tma_load_3d(st + i * WB_BOX, &tm_h, col(i), row, layer, full + slot);
            } else if (CL == 1) {
              tma_load_3d(st + i * WB_BOX, &tm_dz, col(i), row, layer, full + slot);
            } else if ((uint32_t)(i % CL) == rank) {  // a share of the dz boxes, into every CTA
              tma_load_3d_multicast(st + i * WB_BOX, &tm_dz, col(i), row, layer, full + slot,
                                    (uint16_t)((1 << CL) - 1));
            }
          }
        }
      }
    }
    if constexpr (CL > 1) cluster_sync();  // no CTA leaves while copies into it may be pending
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WB_CONSUMER_REGS));

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  float* out = part + ((size_t)chunk * gridDim.z + layer) * H * H;
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
  int it = 0;
  // the chunk's blocks in order (a chunk past the last block stores zeros):
  // each starts its accumulators anew and adds them to the slot at its end
  for (int j = 0; j < max(mine, 1); ++j) {
    const int nk = j < mine ? slabs(chunk + j * n_chunks) : 0;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int slot = it % WB_STAGES;
      mbar_wait(full + slot, (it / WB_STAGES) & 1);
      const bf16* sa = reinterpret_cast<const bf16*>(smem + slot * STAGE + wg * WB_BOX);
      const bf16* sb = reinterpret_cast<const bf16*>(smem + slot * STAGE + 2 * WB_BOX);
      fence_regs<NV>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // 16 rows of K, 2,048 bytes into each box
        wgmma_bf16<BN, 1>(acc, gmma_desc_mn(sa + ks * 16 * 64, WB_BOX, 1024),
                          gmma_desc_mn(sb + ks * 16 * 64, WB_BOX, 1024), kb | ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (it > 0) {  // the products of the slab before are done: free its stage in every CTA
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs<NV>(acc);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < CL; ++r) {
            if constexpr (CL > 1) {
              mbar_arrive_cluster(empty + (it - 1) % WB_STAGES, r);
            } else {
              mbar_arrive(empty + (it - 1) % WB_STAGES);
            }
          }
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<NV>(acc);
    // G pairs of outputs at a time, their loads in flight together
    constexpr int G = NV >= 128 ? 16 : 32;
#pragma unroll
    for (int i0 = 0; i0 < NV; i0 += 2 * G) {
      float2 was[G];
#pragma unroll
      for (int g = 0; g < G && i0 + 2 * g < NV; ++g) {
        const int i = i0 + 2 * g, m = m0 + acc_row(i & 31), n = n0 + acc_col(i >> 5, i & 31);
        was[g] = j > 0 && m < H && n < H
                     ? *reinterpret_cast<const float2*>(out + (size_t)m * H + n)
                     : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int g = 0; g < G && i0 + 2 * g < NV; ++g) {
        const int i = i0 + 2 * g, m = m0 + acc_row(i & 31), n = n0 + acc_col(i >> 5, i & 31);
        if (m < H && n < H)
          *reinterpret_cast<float2*>(out + (size_t)m * H + n) =
              make_float2(was[g].x + acc[i], was[g].y + acc[i + 1]);
      }
    }
  }
  if constexpr (CL > 1) cluster_sync();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so that the library needs no -lcuda; null where it is missing
typedef CUresult (*TensorMapEncoder)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncoder>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a bf16 scratch (n_layers, rows, H) at `base`: boxes of 64
// columns x 64 rows of one layer, 128-byte swizzle, zero fill outside
static inline cudaError_t scratch_map(CUtensorMap* map, const void* base, long long rows, int H,
                                      int n_layers) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)rows, (cuuint64_t)n_layers};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)rows * H * 2};
  const cuuint32_t box[3] = {64, WB_BK, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NB, int CL>
static inline cudaError_t launch_wgrad_bf16(const void* h, const void* dz, float* part,
                                            long long rows, int rows_per_chunk, int n_chunks,
                                            int H, int n_layers, cudaStream_t s) {
  CUtensorMap th, tz;
  cudaError_t err = scratch_map(&th, h, rows, H, n_layers);
  if (err == cudaSuccess) err = scratch_map(&tz, dz, rows, H, n_layers);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wgrad_bf16<NB, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wgrad_smem(NB));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((H + WB_BM - 1) / WB_BM) * ((H + 64 * NB - 1) / (64 * NB)), n_chunks,
                     n_layers);
  cfg.blockDim = dim3(WB_THREADS);
  cfg.dynamicSmemBytes = wgrad_smem(NB);
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CL;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wgrad_bf16<NB, CL>, th, tz, part, rows, rows_per_chunk, H);
}

// The same product for the float32 trunk on the CUDA cores (FFMA, no TF32),
// the register tiling of the tiled passes' float32 product: a 128 x 128
// output tile per CTA, 8 x 8 outputs a thread (rows ty * 4 + i and 64 +
// ty * 4 + i, columns likewise by tx), the chunk's rows 16 at a time through
// a ring of WF_STAGES cp.async stages of both operands, read as float4.
constexpr int WF_BM = 128, WF_KT = 16, WF_STAGES = 3;
constexpr size_t WF_SMEM = (size_t)WF_STAGES * 2 * WF_KT * WF_BM * sizeof(float);

__device__ __forceinline__ void wf_cp16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

static __global__ void __launch_bounds__(THREADS, 1)
wgrad_f32(const float* h, const float* dz, float* part, long long rows, int rows_per_chunk,
          int H) {
  extern __shared__ __align__(16) float wf_smem[];  // WF_STAGES x (h rows, dz rows), (WF_KT, WF_BM)
  const int tiles_n = (H + WF_BM - 1) / WF_BM;
  const int m0 = (blockIdx.x / tiles_n) * WF_BM, n0 = (blockIdx.x % tiles_n) * WF_BM;
  const int chunk = blockIdx.y, layer = blockIdx.z, n_layers = gridDim.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (long long)chunk * rows_per_chunk;
  const long long row_end = min(rows, row0 + (long long)rows_per_chunk);
  const int nk = (int)((row_end - row0 + WF_KT - 1) / WF_KT);
  h += (size_t)layer * rows * H;
  dz += (size_t)layer * rows * H;
  auto stage = [&](int kb) { return wf_smem + (size_t)(kb % WF_STAGES) * 2 * WF_KT * WF_BM; };
  auto load = [&](int kb) {  // 16 rows x 32 chunks of each operand, two a thread
    float* sh = stage(kb);
    float* sz = sh + WF_KT * WF_BM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + THREADS * i, r = e / 32, c = (e % 32) * 4;
      const long long row = row0 + (long long)kb * WF_KT + r;
      const bool in = row < row_end;
      const size_t at = (size_t)(in ? row : row0) * H;
      wf_cp16(sh + r * WF_BM + c, h + at + (m0 + c < H ? m0 + c : 0), in && m0 + c < H);
      wf_cp16(sz + r * WF_BM + c, dz + at + (n0 + c < H ? n0 + c : 0), in && n0 + c < H);
    }
  };
  float acc[8][8] = {};
#pragma unroll
  for (int kb = 0; kb < WF_STAGES - 1; ++kb) {
    if (kb < nk) load(kb);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kb = 0; kb < nk; ++kb) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WF_STAGES - 2) : "memory");
    __syncthreads();
    if (kb + WF_STAGES - 1 < nk) load(kb + WF_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* sh = stage(kb);
    const float* sz = sh + WF_KT * WF_BM;
#pragma unroll
    for (int k = 0; k < WF_KT; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sh + k * WF_BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sh + k * WF_BM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sz + k * WF_BM + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sz + k * WF_BM + 64 + tx * 4);
      const float xs[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float ys[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float* out = part + ((size_t)chunk * n_layers + layer) * H * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= H) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + jh * 64 + tx * 4;
      if (n < H)
        *reinterpret_cast<float4*>(out + (size_t)m * H + n) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
    }
  }
}

// dws (n_layers, H, H) = h^T dz over all rows, from the scratch the chain
// kernel filled: split-K partials into `part` (n_chunks, n_layers, H, H),
// then their sum in chunk order (left out with reduce = false, which only the
// anatomy probes ask for). The rows go in blocks of rows_per_chunk, block b
// into chunk b % n_chunks (wgrad_bf16); wgrad_f32 takes one block a chunk
// (n_chunks x rows_per_chunk >= rows).
static inline cudaError_t launch_weight_grads(bool bf16, const void* h, const void* dz,
                                              float* part, float* dws, long long rows,
                                              int rows_per_chunk, int n_chunks, int H,
                                              int n_layers, cudaStream_t s,
                                              bool reduce = true) {
  if (n_layers == 0) return cudaSuccess;
  if (bf16) {
    // TMA's row coordinate is 32 bits; a block is whole slabs; rows of 16 bytes
    if (rows <= 0 || rows > INT_MAX || rows_per_chunk <= 0 || rows_per_chunk % WB_BK != 0 ||
        H % 16 != 0)
      return cudaErrorInvalidValue;
    using Launch = cudaError_t (*)(const void*, const void*, float*, long long, int, int, int,
                                   int, cudaStream_t);
    // pairs of CTAs along m share their dz boxes where the m blocks pair up
    constexpr Launch by_nb[2][4] = {
        {launch_wgrad_bf16<1, 1>, launch_wgrad_bf16<2, 1>, launch_wgrad_bf16<3, 1>,
         launch_wgrad_bf16<4, 1>},
        {launch_wgrad_bf16<1, 2>, launch_wgrad_bf16<2, 2>, launch_wgrad_bf16<3, 2>,
         launch_wgrad_bf16<4, 2>}};
    const int paired = ((H + WB_BM - 1) / WB_BM) % 2 == 0;
    const cudaError_t err = by_nb[paired][wgrad_nb(H) - 1](h, dz, part, rows, rows_per_chunk,
                                                           n_chunks, H, n_layers, s);
    if (err != cudaSuccess) return err;
  } else {
    const int t = (H + WF_BM - 1) / WF_BM;
    const cudaError_t err =
        cudaFuncSetAttribute(wgrad_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WF_SMEM);
    if (err != cudaSuccess) return err;
    wgrad_f32<<<dim3(t * t, n_chunks, n_layers), THREADS, WF_SMEM, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(dz), part, rows, rows_per_chunk,
        H);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return err;
  return launch_reduce(part, dws, 1, n_chunks, (long long)n_layers * H * H, s);
}

}  // namespace reni
