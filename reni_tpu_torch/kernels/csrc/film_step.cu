// The FiLM train step behind a plain C interface: the layer-major wgmma
// passes of step_passes.cuh (the bf16 trunk at widths that are a multiple of
// 64, two trunk layers or more) and the chain kernel of siren_step.cuh (every
// other trunk), each header holding its design note. Replaces
// _film_step_kernel of reni_tpu/kernels/siren_pallas.py (entry
// fused_film_step_mse).

#include "step_passes.cuh"

using namespace reni_step;

extern "C" {

// The FiLM train step through the chain kernel of siren_step.cuh; n_trunk = T >= 1. out_img (B, (8 + 2T) H) receives
// dA0 (B, 8, H) | dfreqs (B, T H) | dphases (B, T H); out_w (n_w) receives
// mse (8) | dbs (T, H) | dWf (H, 8) | dbf (8); dws (T - 1, H, H) the hidden
// weight gradients. part_*, sc_* and part_dws are work space. act: 0 none,
// 1 tanh, 2 exp. Returns a cudaError_t.
int reni_film_step(const float* d, long long d_bstride, const float* a0, const void* ws,
                   const float* bs, const void* wf, const float* bf, const float* fr,
                   const float* ph, const float* tgt, const float* sw, const float* bm,
                   float* part_img, float* out_img, float* part_w, float* out_w, void* sc_h,
                   void* sc_dz, float* part_dws, float* dws, int batch, int P, int H,
                   int n_trunk, int tiles_per_cta, int n_chunks, int rows_per_chunk,
                   int n_wchunks, float gscale, int bf16, int fast, int act, void* stream) {
  const Args args{d, d_bstride, a0, nullptr, ws, bs, wf, bf, fr, ph, tgt, sw, bm, part_img,
                  part_w, sc_h, sc_dz, P, H, n_trunk - 1, tiles_per_cta, n_chunks, 0.0f, 0.0f,
                  2.0f * gscale};
  const Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  return launch<true>(args, sums, batch, bf16, fast, act, stream);
}

// The bf16 FiLM train step, or (gin set) the backward of _film_bwd_kernel,
// as layer-major passes (step_passes.cuh), T = n_trunk >= 2: passes
// [pass_lo, pass_hi) of the 2 (T - 1), then what `finish` asks for
// (reni_pass::FINISH_*). ws is W as stored, wst its transpose per layer
// (bf16); sc_keep (T - 2, B P, H) float32 holds the pre-modulation values of
// layers 1..T-2. tgt, sw, bm, gin, out and wgrad as for
// reni_siren_step_passes.
// Outputs as for reni_film_step. Returns a cudaError_t.
int reni_film_step_passes(const float* d, long long d_bstride, const float* a0, const void* ws,
                          const void* wst, const float* bs, const void* wf, const float* bf,
                          const float* fr, const float* ph, const float* tgt, const float* sw,
                          const float* bm, const float* gin, float* out, float* part_img,
                          float* out_img, float* part_w,
                          float* out_w, void* sc_h, float* sc_keep, void* sc_dz, float* part_dws,
                          float* dws, int batch, int P, int H, int n_trunk, int tiles_per_cta,
                          int n_chunks, int rows_per_chunk, int n_wchunks, float gscale, int fast,
                          int act, int wgrad, int pass_lo, int pass_hi, int finish,
                          void* stream) {
  using reni_pass::bf16;
  const reni_pass::PassArgs args{
      d, d_bstride, a0, nullptr, static_cast<const bf16*>(ws), static_cast<const bf16*>(wst),
      bs, static_cast<const bf16*>(wf), bf, fr, ph, tgt, sw, bm, gin, out, part_img, part_w,
      static_cast<bf16*>(sc_h), sc_keep, static_cast<bf16*>(sc_dz), P, H, n_trunk - 1,
      tiles_per_cta, n_chunks, act, wgrad, 0.0f, 0.0f, 2.0f * gscale, 0};
  const Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? reni_pass::launch_passes<true, reni::SINE_FAST>(args, sums, batch, pass_lo,
                                                                 pass_hi, finish, s)
              : reni_pass::launch_passes<true, reni::SINE_EXACT>(args, sums, batch, pass_lo,
                                                                  pass_hi, finish, s);
}

// Bytes of shared memory one CTA of the chain kernel takes
// (kernels/siren_step.py mirrors this in chain_smem_bytes).
int reni_film_step_smem_bytes(int bf16, int H, int n_mm) {
  return (int)layout(true, bf16 != 0, H, n_mm).total;
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

const char* reni_film_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
