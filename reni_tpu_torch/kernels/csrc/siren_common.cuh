// Device helpers shared by every kernel source of this directory.
//
// fast_sin / fast_cos / fast_sincos are core/fastmath.py's polynomials: the
// same float32 constants (as exact hex literals), the same operation order,
// rintf (half to even, as jnp.round / torch.round) and floorf. The exact
// path is sinf / cosf / sincosf with full range reduction: the build must
// not use --use_fast_math (SIREN pre-activations reach |x| ~ 200).
// SINE_LINEAR is the stand-in of the anatomy probes (siren_anatomy.cu):
// sin -> 0.8 x, cos -> 0.6 x, numerically wrong on purpose; no shipped kernel
// is instantiated with it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace reni {

constexpr int K_PAD = 8;  // direction-feature width, padded
constexpr int C_PAD = 8;  // output channels, padded

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

constexpr float PI_HI = 0x1.92p+1f;
constexpr float PI_LO = 0x1.fb5444p-11f;
constexpr float INV_PI = 0x1.45f306p-2f;
// degree-9 odd polynomial for sin on [-pi/2, pi/2]
constexpr float S3 = -0x1.555556p-3f;
constexpr float S5 = 0x1.11110cp-7f;
constexpr float S7 = -0x1.a017e2p-13f;
constexpr float S9 = 0x1.71711cp-19f;
// degree-10 even polynomial for cos on [-pi/2, pi/2]
constexpr float C2 = -0x1p-1f;
constexpr float C4 = 0x1.555556p-5f;
constexpr float C6 = -0x1.6c16c2p-10f;
constexpr float C8 = 0x1.a01a02p-16f;
constexpr float C10 = -0x1.27e4fcp-22f;

// (r, sign): r = x - k*pi in [-pi/2, pi/2], sign = (-1)^k
__device__ __forceinline__ float reduce_pi(float x, float* sign) {
  const float k = rintf(x * INV_PI);
  const float r = (x - k * PI_HI) - k * PI_LO;
  const float half = k * 0.5f;
  *sign = 1.0f - 4.0f * (half - floorf(half));
  return r;
}

__device__ __forceinline__ float poly_sin(float r, float r2) {
  const float p = ((S9 * r2 + S7) * r2 + S5) * r2 + S3;
  return r + r * (r2 * p);
}

__device__ __forceinline__ float poly_cos(float r2) {
  const float p = (((C10 * r2 + C8) * r2 + C6) * r2 + C4) * r2 + C2;
  return 1.0f + r2 * p;
}

__device__ __forceinline__ float fast_sin(float x) {
  float sign;
  const float r = reduce_pi(x, &sign);
  return poly_sin(r, r * r) * sign;
}

__device__ __forceinline__ float fast_cos(float x) {
  float sign;
  const float r = reduce_pi(x, &sign);
  return poly_cos(r * r) * sign;
}

// fast_sin of N arguments in place, each step over all of them before the
// next: the same operations, so the same bits, as independent chains that
// the scheduler can interleave
template <int N>
__device__ __forceinline__ void fast_sin_n(float (&x)[N]) {
  float k[N], sign[N];
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = rintf(x[i] * INV_PI);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float half = k[i] * 0.5f;
    sign[i] = 1.0f - 4.0f * (half - floorf(half));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = (x[i] - k[i] * PI_HI) - k[i] * PI_LO;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = poly_sin(x[i], x[i] * x[i]) * sign[i];
}

// sin and cos of one argument sharing one range reduction
__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
  float sign;
  const float r = reduce_pi(x, &sign);
  const float r2 = r * r;
  *s = poly_sin(r, r2) * sign;
  *c = poly_cos(r2) * sign;
}

enum { SINE_EXACT = 0, SINE_FAST = 1, SINE_LINEAR = 2 };

template <int SINE>
__device__ __forceinline__ float sine(float x) {
  if constexpr (SINE == SINE_LINEAR) return __fmul_rn(x, 0.8f);
  return SINE == SINE_FAST ? fast_sin(x) : sinf(x);
}

template <int SINE>
__device__ __forceinline__ float cosine(float x) {
  if constexpr (SINE == SINE_LINEAR) return __fmul_rn(x, 0.6f);
  return SINE == SINE_FAST ? fast_cos(x) : cosf(x);
}

template <int SINE>
__device__ __forceinline__ void sine_cosine(float x, float* s, float* c) {
  if constexpr (SINE == SINE_LINEAR) {
    *s = __fmul_rn(x, 0.8f);
    *c = __fmul_rn(x, 0.6f);
  } else if constexpr (SINE == SINE_FAST) {
    fast_sincos(x, s, c);
  } else {
    sincosf(x, s, c);
  }
}

// the value a product operand takes: rounded to bf16 for the bf16 trunk
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ float get(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float get(float v) { return v; }

}  // namespace reni
