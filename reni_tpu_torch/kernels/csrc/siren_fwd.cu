// The shipped forward kernels, behind a plain C interface: the fused wgmma
// kernel of fused_fwd.cuh (the bf16 trunk, H a multiple of 64 up to 256) and
// the row-tile kernel of siren_fwd.cuh (the float32 trunk and other widths);
// each header holds its design note. kernels/siren_fwd.py::fwd_route picks.
// Replaces _fwd_kernel and _film_fwd_kernel of reni_tpu/kernels/siren_pallas.py.

#include "fused_fwd.cuh"
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

template <bool FILM>
int run_fused(const reni_fused::FusedArgs& g, int fast, int grid, void* stream) {
  using namespace reni_fused;
  const FusedFn kern = fast ? fused_fwd<FILM, SINE_FAST> : fused_fwd<FILM, SINE_EXACT>;
  return launch_fused(kern, FILM, g, grid, stream);
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

// Cond-by-Concat forward through the fused kernel: `slabs` are W_j^T packed
// as fused_fwd.cuh reads them (kernels/siren_fwd.py::pack_slabs), wf bf16;
// `stages` the ring of fused_layout, `sched` SCHED_LOCKSTEP or SCHED_PINGPONG,
// `grid` the persistent CTAs (at most one per item). Returns a cudaError_t.
int reni_siren_fwd_fused(const float* d, long long d_bstride, const float* a, const float* b0,
                         const void* slabs, const float* bs, const void* wf, const float* bf,
                         float* out, int batch, int P, int H, int n_hidden, float omega0,
                         float omega_h, int fast, int stages, int sched, int grid,
                         void* stream) {
  using reni_wg::bf16;
  const reni_fused::FusedArgs g{d, d_bstride, a, b0, static_cast<const bf16*>(slabs), bs,
                                static_cast<const bf16*>(wf), bf, nullptr, nullptr, out,
                                batch, P, H, n_hidden, stages, sched, omega0, omega_h};
  return run_fused<false>(g, fast, grid, stream);
}

// FiLM forward through the fused kernel (n_trunk = T >= 2); as above.
int reni_film_fwd_fused(const float* d, long long d_bstride, const float* a0, const void* slabs,
                        const float* bs, const void* wf, const float* bf, const float* fr,
                        const float* ph, float* out, int batch, int P, int H, int n_trunk,
                        int fast, int stages, int sched, int grid, void* stream) {
  using reni_wg::bf16;
  const reni_fused::FusedArgs g{d, d_bstride, a0, nullptr, static_cast<const bf16*>(slabs), bs,
                                static_cast<const bf16*>(wf), bf, fr, ph, out,
                                batch, P, H, n_trunk - 1, stages, sched, 0.0f, 0.0f};
  return run_fused<true>(g, fast, grid, stream);
}

// The fused kernel's shared memory and ring at the deepest ring that fits
// (0 and 0: none fits), and its persistent grid on the current device
// (kernels/siren_fwd.py mirrors them in fused_layout and fused_grid).
int reni_fused_fwd_smem_bytes(int H, int n_mm, int film) {
  const reni_fused::FusedLayout L = reni_fused::fused_layout(H, n_mm, film != 0);
  return L.stages ? (int)L.total : 0;
}
int reni_fused_fwd_stages(int H, int n_mm, int film) {
  return reni_fused::fused_layout(H, n_mm, film != 0).stages;
}
int reni_fused_fwd_grid(int batch, int P) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return reni_fused::fused_grid(batch, P, sms);
}

// The row tile a forward launch of width H takes (kernels/siren_fwd.py
// mirrors this in tile_rows).
int reni_fwd_tile_rows(int H, int bf16) { return tile_rows_for(H, bf16 != 0); }

const char* reni_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
