// The Cond-by-Concat train step: the instantiations of siren_step.cuh (which
// holds the design note) behind a plain C interface. Replaces _step_kernel of
// reni_tpu/kernels/siren_pallas.py (entry fused_step_mse).

#include "siren_step.cuh"

using namespace reni_step;

extern "C" {

// The train step. out_img (B, 9H) receives dA (B, 8, H) | db0 (B, H); out_w
// (n_w) receives mse (8) | dbs (L, H) | dWf (H, 8) | dbf (8); dws (L, H, H)
// the hidden weight gradients. part_*, sc_* and part_dws are work space.
// act: 0 none, 1 tanh, 2 exp. Returns a cudaError_t.
int reni_siren_step(const float* d, long long d_bstride, const float* a, const float* b0,
                    const void* ws, const float* bs, const void* wf, const float* bf,
                    const float* tgt, const float* sw, const float* bm, float* part_img,
                    float* out_img, float* part_w, float* out_w, void* sc_h, void* sc_dz,
                    float* part_dws, float* dws, int batch, int P, int H, int n_hidden,
                    int tiles_per_cta, int n_chunks, int rows_per_chunk, int n_wchunks,
                    float omega0, float omega_h, float gscale, int bf16, int fast, int act,
                    void* stream) {
  const Args args{d, d_bstride, a, b0, ws, bs, wf, bf, nullptr, nullptr, tgt, sw, bm, part_img,
                  part_w, sc_h, sc_dz, P, H, n_hidden, tiles_per_cta, n_chunks, omega0, omega_h,
                  2.0f * gscale};
  const Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  return launch<false>(args, sums, batch, bf16, fast, act, stream);
}

// Bytes of shared memory one CTA takes (kernels/siren_step.py mirrors this).
int reni_step_smem_bytes(int bf16, int H, int n_mm) {
  return (int)layout(false, bf16 != 0, H, n_mm).total;
}

const char* reni_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
