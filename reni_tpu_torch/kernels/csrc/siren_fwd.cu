// The shipped forward kernels: the instantiations of siren_fwd.cuh (which
// holds the design note) that serving and training launch, behind a plain C
// interface. Replaces _fwd_kernel and _film_fwd_kernel of
// reni_tpu/kernels/siren_pallas.py.

#include "siren_fwd.cuh"

namespace {

using namespace reni;
using namespace reni_fwd;

template <bool FILM, int TM>
KernelFn pick_tile(int bf16, int fast) {
  if (bf16) {
    return fast ? trunk_fwd<FILM, true, SINE_FAST, 1, TM>
                : trunk_fwd<FILM, true, SINE_EXACT, 1, TM>;
  }
  return fast ? trunk_fwd<FILM, false, SINE_FAST, 1, TM>
              : trunk_fwd<FILM, false, SINE_EXACT, 1, TM>;
}

// the kernel of the largest row tile whose CTA fits in shared memory
template <bool FILM>
int run(const Args& g, int batch, int bf16, int fast, void* stream) {
  const int tm = tile_rows_for(g.H, bf16 != 0);
  const KernelFn kern = tm == 64   ? pick_tile<FILM, 64>(bf16, fast)
                        : tm == 32 ? pick_tile<FILM, 32>(bf16, fast)
                                   : pick_tile<FILM, 16>(bf16, fast);
  return launch(kern, g, batch, bf16, stream, tm);
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
  return run<false>(g, batch, bf16, fast, stream);
}

// FiLM forward (replaces _film_fwd_kernel); n_trunk = T >= 1. Returns a cudaError_t.
int reni_film_fwd(const float* d, long long d_bstride, const float* a0, const void* ws,
                  const float* bs, const void* wf, const float* bf, const float* fr,
                  const float* ph, float* out, int batch, int P, int H, int n_trunk,
                  int bf16, int fast, void* stream) {
  const Args g{d, d_bstride, a0, nullptr, ws, bs, wf, bf, fr, ph, out,
               P, H, n_trunk - 1, 0.0f, 0.0f};
  return run<true>(g, batch, bf16, fast, stream);
}

// The row tile a forward launch of width H takes (kernels/siren_fwd.py
// mirrors this in tile_rows).
int reni_fwd_tile_rows(int H, int bf16) { return tile_rows_for(H, bf16 != 0); }

const char* reni_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
