// The Cond-by-Concat train step behind a plain C interface: the layer-major
// wgmma passes of step_passes.cuh (the bf16 trunk at widths that are a
// multiple of 64) and the chain kernel of siren_step.cuh (every other trunk),
// each header holding its design note. Replaces _step_kernel of
// reni_tpu/kernels/siren_pallas.py (entry fused_step_mse).

#include "step_passes.cuh"

using namespace reni_step;

extern "C" {

// The train step through the chain kernel of siren_step.cuh (the float32
// trunk, and bf16 widths that are not a multiple of 64). out_img (B, 9H) receives dA (B, 8, H) | db0 (B, H); out_w
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

// The bf16 train step, or (gin set) the backward of _bwd_kernel, as
// layer-major passes (step_passes.cuh): passes [pass_lo, pass_hi) of the
// 2 L, then what `finish` asks for (reni_pass::FINISH_*: the per-image slot
// sums, the weight slot sums, dWs). ws is W as stored, wst its transpose per
// layer (bf16); sc_keep (L - 1, B P, H) float32 holds the cos factors of
// layers 1..L-1. A step passes tgt, sw and bm and no gin or out; a backward
// gin (B, P, 8), no tgt, sw or bm, and wgrad = 0 for the per-image gradients
// alone; a forward out (B, P, 8) and passes [0, L), its scratch then read by
// the backward's passes [L - 1, 2 L). Outputs as for reni_siren_step (out_w's
// mse is 0 for a backward). Returns a cudaError_t.
int reni_siren_step_passes(const float* d, long long d_bstride, const float* a, const float* b0,
                           const void* ws, const void* wst, const float* bs, const void* wf,
                           const float* bf, const float* tgt, const float* sw, const float* bm,
                           const float* gin, float* out, float* part_img, float* out_img,
                           float* part_w,
                           float* out_w, void* sc_h, float* sc_keep, void* sc_dz,
                           float* part_dws, float* dws,
                           int batch, int P, int H, int n_hidden, int tiles_per_cta, int n_chunks,
                           int rows_per_chunk, int n_wchunks, float omega0, float omega_h,
                           float gscale, int fast, int act, int wgrad, int pass_lo, int pass_hi,
                           int finish, void* stream) {
  using reni_pass::bf16;
  const reni_pass::PassArgs args{
      d, d_bstride, a, b0, static_cast<const bf16*>(ws), static_cast<const bf16*>(wst), bs,
      static_cast<const bf16*>(wf), bf, nullptr, nullptr, tgt, sw, bm, gin, out, part_img, part_w,
      static_cast<bf16*>(sc_h), sc_keep, static_cast<bf16*>(sc_dz), P, H, n_hidden,
      tiles_per_cta, n_chunks, act, wgrad, omega0, omega_h, 2.0f * gscale, 0};
  const Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? reni_pass::launch_passes<false, reni::SINE_FAST>(args, sums, batch, pass_lo,
                                                                 pass_hi, finish, s)
              : reni_pass::launch_passes<false, reni::SINE_EXACT>(args, sums, batch, pass_lo,
                                                                  pass_hi, finish, s);
}

// Bytes of shared memory one CTA of the chain kernel takes
// (kernels/siren_step.py mirrors this in chain_smem_bytes).
int reni_step_smem_bytes(int bf16, int H, int n_mm) {
  return (int)layout(false, bf16 != 0, H, n_mm).total;
}

// Bytes of shared memory one CTA of any pass takes (kernels/siren_step.py
// mirrors this in pass_smem_bytes; pass_route there decides the route).
int reni_pass_smem_bytes(int H) { return (int)reni_pass::pass_layout(H).total; }

// out[b][j] = the sum over slots, in slot order, of part[b][slot][j]: the
// sum of the slots of grouped calls (kernels/siren_step.py). Returns a
// cudaError_t.
int reni_pass_reduce(const float* part, float* out, int batch, int n_slots, long long n,
                     void* stream) {
  return (int)launch_reduce(part, out, batch, n_slots, n, static_cast<cudaStream_t>(stream));
}

const char* reni_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
