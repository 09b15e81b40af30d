// The shipped backward kernels: the instantiations of siren_bwd.cuh (which
// holds the design note) that training launches, behind a plain C interface.
// Replaces _bwd_kernel and _film_bwd_kernel of
// reni_tpu/kernels/siren_pallas.py.

#include "siren_bwd.cuh"

namespace {

using namespace reni;
using namespace reni_bwd;

template <bool FILM, bool BF16>
KernelFn pick(int fast, int wgrad) {
  if (fast) {
    return wgrad ? trunk_bwd<FILM, BF16, SINE_FAST, true> : trunk_bwd<FILM, BF16, SINE_FAST, false>;
  }
  return wgrad ? trunk_bwd<FILM, BF16, SINE_EXACT, true> : trunk_bwd<FILM, BF16, SINE_EXACT, false>;
}

template <bool FILM>
int run(const Args& g, int batch, int bf16, int fast, const WeightGrads* wg, float* out,
        void* stream) {
  const int wgrad = wg != nullptr;
  const KernelFn kern = bf16 ? pick<FILM, true>(fast, wgrad) : pick<FILM, false>(fast, wgrad);
  return launch(kern, FILM, g, batch, bf16 != 0, wg, out, stream);
}

}  // namespace

extern "C" {

// Cond-by-Concat backward (replaces _bwd_kernel). `out` (B, 9H) receives
// dA (B, 8, H) | db0 (B, H). With wgrad, out_w receives dbs (L, H) |
// dWf (H, 8) | dbf (8) and dws (L, H, H) the hidden weight gradients;
// part_w, sc_h, sc_dz and part_dws are their work space (null without
// wgrad). Returns a cudaError_t.
int reni_siren_bwd(const float* d, long long d_bstride, const float* a, const float* b0,
                   const void* ws, const float* bs, const void* wf, const float* g,
                   float* part, float* out, float* part_w, float* out_w, void* sc_h,
                   void* sc_dz, float* part_dws, float* dws, int batch, int P, int H,
                   int n_hidden, int tiles_per_cta, int n_chunks, int rows_per_chunk,
                   int n_wchunks, float omega0, float omega_h, int bf16, int fast, int wgrad,
                   void* stream) {
  const Args args{d, d_bstride, a, b0, ws, bs, wf, nullptr, nullptr, g, part, part_w, sc_h,
                  sc_dz, P, H, n_hidden, tiles_per_cta, n_chunks, omega0, omega_h};
  const WeightGrads wg{out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  return run<false>(args, batch, bf16, fast, wgrad ? &wg : nullptr, out, stream);
}

// FiLM backward (replaces _film_bwd_kernel); n_trunk = T >= 1. `out`
// (B, (8 + 2T) H) receives dA0 | dfreqs | dphases; with wgrad, out_w
// receives dbs (T, H) | dWf | dbf and dws (T - 1, H, H), as above. Returns a
// cudaError_t.
int reni_film_bwd(const float* d, long long d_bstride, const float* a0, const void* ws,
                  const float* bs, const void* wf, const float* fr, const float* ph,
                  const float* g, float* part, float* out, float* part_w, float* out_w,
                  void* sc_h, void* sc_dz, float* part_dws, float* dws, int batch, int P, int H,
                  int n_trunk, int tiles_per_cta, int n_chunks, int rows_per_chunk,
                  int n_wchunks, int bf16, int fast, int wgrad, void* stream) {
  const Args args{d, d_bstride, a0, nullptr, ws, bs, wf, fr, ph, g, part, part_w, sc_h,
                  sc_dz, P, H, n_trunk - 1, tiles_per_cta, n_chunks, 0.0f, 0.0f};
  const WeightGrads wg{out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  return run<true>(args, batch, bf16, fast, wgrad ? &wg : nullptr, out, stream);
}

// Bytes of shared memory one CTA takes (kernels/siren_bwd.py mirrors this).
int reni_bwd_smem_bytes(int film, int bf16, int H, int n_mm) {
  return (int)layout(film != 0, bf16 != 0, H, n_mm).total;
}

const char* reni_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
