// Anatomy probes of the Cond-by-Concat forward and backward kernels: the
// kernel templates of fused_fwd.cuh, siren_fwd.cuh, siren_bwd.cuh and
// step_passes.cuh instantiated with one part taken out or rearranged, to see which part
// bounds the shipped kernels.
//
// Replaces the Pallas probe kernels _fwd_kernel_variant and
// _bwd_kernel_variant of benchmarks/bwd_anatomy.py. They are timed by
// time_kernels.py --anatomy and called by nothing on a serving or training
// path. This is a translation unit of its own, so the shipped libraries
// (siren_fwd.cu, siren_bwd.cu, siren_step.cu) hold the same machine code with
// or without it.
//
// Forward variants. Where the shipped bf16 forward is the fused kernel
// (fused_fwd.cuh; kernels/siren_fwd.py::fwd_route):
//   - sine mode SINE_LINEAR: every sine becomes 0.8 x (no transcendental);
//     built here (reni_anatomy_fwd_fused);
//   - interleave 2: the fused kernel with its two warpgroups in lock step
//     (SCHED_LOCKSTEP), so that no epilogue runs under a product: the
//     counterpart of the TPU probe's sub-tiles worked one after the other.
//     The schedule is an argument of the shipped kernel, so this variant is
//     launched from siren_fwd.cu; its results are the shipped kernel's bits;
//   - interleave 4 has no counterpart in the fused design: it stays the
//     row-tile kernel of siren_fwd.cuh working each 64-row tile as 4
//     sub-tiles, so a weight fragment read from L2 serves one row tile of 16;
//     its results are the row-tile kernel's bits.
// Where the shipped forward is the row-tile kernel (the float32 trunk, other
// widths): SINE_LINEAR, and interleave 2 or 4 as the sub-tiles of the row-tile
// kernel, with the row-tile kernel's bits.
// Backward variants. Where the shipped bf16 backward is the layer-major
// passes (step_passes.cuh; kernels/siren_step.py::pass_route: H a multiple
// of 64 up to 256):
//   - sine mode SINE_LINEAR: (sin, cos) becomes (0.8 x, 0.6 x) in every pass
//     (the fwd passes, the cotangent last pass's backward epilogue, the bwd
//     passes and the value of layer 0 that bwd pass 0 forms again from d),
//     with or without the weight gradients; built here
//     (reni_anatomy_passes);
//   - the shipped passes with weight gradients and finish = 0 ("no_accum"):
//     the TPU probe writes its weight gradients in place of accumulating
//     them across its sequential grid. This port has no such accumulation:
//     its counterpart is the reduction after the passes, so this variant
//     runs the passes alone, and the per-CTA slots and the scratch of h and
//     dz are the result (reduce_slots and the split-K product skipped). The
//     passes take finish as an argument, so this variant and the shipped
//     backward with and without weight gradients are launched from
//     siren_step.cu.
// Where the shipped backward is the chain kernel (the float32 trunk, bf16
// widths that are not a multiple of 64), the same variants of the chain
// kernel of siren_bwd.cuh: SINE_LINEAR, and reduce = 0 (the chain kernel
// with weight gradients alone; the slot sums and the split-K product
// skipped).
// reni_anatomy_l2_read reads a buffer that fits in L2 many times over, so that
// its time gives L2's read rate on this card: the rate the fused forward's
// weight slabs come at (fused_fwd.cuh).
// Beside them, reni_anatomy_wgrad runs the training kernels' weight-gradient
// product (wgrad_bf16 / wgrad_f32 of siren_chain.cuh) alone on a given
// scratch, with or without the sum of its split-K partials, so that it can
// be timed apart from the chain kernel.
// Every variant but the interleaved forwards is numerically wrong on purpose,
// and each is a definite function with a plain version in kernels/anatomy.py.
// The variants the shipped libraries already hold (the backward without
// weight gradients, each kernel unchanged, the fused kernel in lock step) are
// launched from there.
//
// What bounds them on the H100: as the shipped kernels; the point of a probe
// is the time that its missing part took.

#include "fused_fwd.cuh"
#include "siren_bwd.cuh"
#include "siren_fwd.cuh"
#include "step_passes.cuh"

namespace {

using namespace reni;

template <bool BF16>
reni_fwd::KernelFn pick_fwd(int sine, int interleave) {
  using namespace reni_fwd;
  if (sine == SINE_LINEAR) {
    if (interleave != 1) return nullptr;
    return trunk_fwd<false, BF16, SINE_LINEAR>;
  }
  if (interleave == 2) {
    return sine == SINE_FAST ? trunk_fwd<false, BF16, SINE_FAST, 2>
                             : trunk_fwd<false, BF16, SINE_EXACT, 2>;
  }
  if (interleave == 4) {
    return sine == SINE_FAST ? trunk_fwd<false, BF16, SINE_FAST, 4>
                             : trunk_fwd<false, BF16, SINE_EXACT, 4>;
  }
  return nullptr;
}

template <bool BF16>
reni_bwd::KernelFn pick_bwd(int sine, int wgrad, int reduce) {
  using namespace reni_bwd;
  if (sine == SINE_LINEAR) {
    return wgrad ? trunk_bwd<false, BF16, SINE_LINEAR, true>
                 : trunk_bwd<false, BF16, SINE_LINEAR, false>;
  }
  if (!wgrad || reduce) return nullptr;  // a shipped kernel: launch it from siren_bwd.cu
  return sine == SINE_FAST ? trunk_bwd<false, BF16, SINE_FAST, true>
                           : trunk_bwd<false, BF16, SINE_EXACT, true>;
}

// every thread sums the 32-bit words of its 16-byte pieces of buf, `reps`
// times over (ld.global.cg: cached in L2, not L1); the CTAs add their sums
// into *sink with integer atomics, so the total is exact
__global__ void l2_read(const uint4* buf, long long pieces, int reps, unsigned* sink) {
  unsigned s = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r)
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < pieces; i += stride) {
      unsigned x, y, z, w;
      asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                   : "l"(buf + i));
      s += x + y + z + w;
    }
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) atomicAdd(sink, s);
}

}  // namespace

extern "C" {

// A forward variant; the arguments of reni_siren_fwd with the sine mode
// (0 exact, 1 fast, 2 linear stand-in) and the interleave (1, 2 or 4). A
// combination this file does not hold returns cudaErrorInvalidValue.
int reni_anatomy_fwd(const float* d, long long d_bstride, const float* a, const float* b0,
                     const void* ws, const float* bs, const void* wf, const float* bf,
                     float* out, int batch, int P, int H, int n_hidden, float omega0,
                     float omega_h, int bf16, int sine, int interleave, void* stream) {
  const reni_fwd::Args g{d, d_bstride, a, b0, ws, bs, wf, bf, nullptr, nullptr, out,
                         P, H, n_hidden, omega0, omega_h};
  const reni_fwd::KernelFn kern =
      bf16 ? pick_fwd<true>(sine, interleave) : pick_fwd<false>(sine, interleave);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return reni_fwd::launch(kern, g, batch, bf16, stream);
}

// The fused forward (Cond-by-Concat) with the linear stand-in for every sine;
// the arguments of reni_siren_fwd_fused but `fast`. Returns a cudaError_t.
int reni_anatomy_fwd_fused(const float* d, long long d_bstride, const float* a, const float* b0,
                           const void* slabs, const float* bs, const void* wf, const float* bf,
                           float* out, int batch, int P, int H, int n_hidden, float omega0,
                           float omega_h, int stages, int sched, int grid, void* stream) {
  using reni_wg::bf16;
  const reni_fused::FusedArgs g{d, d_bstride, a, b0, static_cast<const bf16*>(slabs), bs,
                                static_cast<const bf16*>(wf), bf, nullptr, nullptr, out,
                                batch, P, H, n_hidden, stages, sched, omega0, omega_h};
  return reni_fused::launch_fused(reni_fused::fused_fwd<false, reni::SINE_LINEAR>, false, g, grid,
                                  stream);
}

// A backward variant; the arguments of reni_siren_bwd with the sine mode and
// `reduce`. With reduce = 0, part (B, n_chunks, 9H), part_w (B * n_chunks,
// n_w), sc_h and sc_dz are the result and out, out_w, part_dws and dws are
// not touched. A combination this file does not hold returns
// cudaErrorInvalidValue.
int reni_anatomy_bwd(const float* d, long long d_bstride, const float* a, const float* b0,
                     const void* ws, const float* bs, const void* wf, const float* g,
                     float* part, float* out, float* part_w, float* out_w, void* sc_h,
                     void* sc_dz, float* part_dws, float* dws, int batch, int P, int H,
                     int n_hidden, int tiles_per_cta, int n_chunks, int rows_per_chunk,
                     int n_wchunks, float omega0, float omega_h, int bf16, int sine, int wgrad,
                     int reduce, void* stream) {
  const reni_bwd::Args args{d, d_bstride, a, b0, ws, bs, wf, nullptr, nullptr, g, part, part_w,
                            sc_h, sc_dz, P, H, n_hidden, tiles_per_cta, n_chunks, omega0,
                            omega_h};
  const reni_bwd::WeightGrads wg{out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  const reni_bwd::KernelFn kern = bf16 ? pick_bwd<true>(sine, wgrad, reduce)
                                       : pick_bwd<false>(sine, wgrad, reduce);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return reni_bwd::launch(kern, false, args, batch, bf16 != 0, wgrad ? &wg : nullptr, out,
                          stream, reduce != 0);
}

// Cond-by-Concat passes [pass_lo, pass_hi) of a backward (gin set) with the
// sine mode `sine`, then what `finish` asks for (reni_pass::FINISH_*): the
// arguments of reni_siren_step_passes with `sine` in place of `fast`. Only
// SINE_LINEAR is built here (the exact and fast passes are siren_step.cu's);
// another mode returns cudaErrorInvalidValue. Returns a cudaError_t.
int reni_anatomy_passes(const float* d, long long d_bstride, const float* a, const float* b0,
                        const void* ws, const void* wst, const float* bs, const void* wf,
                        const float* bf, const float* tgt, const float* sw, const float* bm,
                        const float* gin, float* out, float* part_img, float* out_img,
                        float* part_w, float* out_w, void* sc_h, float* sc_keep, void* sc_dz,
                        float* part_dws, float* dws, int batch, int P, int H, int n_hidden,
                        int tiles_per_cta, int n_chunks, int rows_per_chunk, int n_wchunks,
                        float omega0, float omega_h, float gscale, int sine, int act, int wgrad,
                        int pass_lo, int pass_hi, int finish, void* stream) {
  using reni_pass::bf16;
  if (sine != reni::SINE_LINEAR) return (int)cudaErrorInvalidValue;
  const reni_pass::PassArgs args{
      d, d_bstride, a, b0, static_cast<const bf16*>(ws), static_cast<const bf16*>(wst), bs,
      static_cast<const bf16*>(wf), bf, nullptr, nullptr, tgt, sw, bm, gin, out, part_img, part_w,
      static_cast<bf16*>(sc_h), sc_keep, static_cast<bf16*>(sc_dz), P, H, n_hidden,
      tiles_per_cta, n_chunks, act, wgrad, omega0, omega_h, 2.0f * gscale, 0};
  const reni_step::Sums sums{out_img, out_w, part_dws, dws, rows_per_chunk, n_wchunks};
  return reni_pass::launch_passes<false, reni::SINE_LINEAR>(
      args, sums, batch, pass_lo, pass_hi, finish, static_cast<cudaStream_t>(stream));
}

// dws (n_layers, H, H) = h^T dz from the scratches h and dz (n_layers, rows,
// H; bf16 or float32): the split-K product into part (n_wchunks, n_layers, H,
// H) and, with reduce, the sum of the partials into dws. Returns a
// cudaError_t.
int reni_anatomy_wgrad(const void* h, const void* dz, float* part, float* dws, long long rows,
                       int rows_per_chunk, int n_wchunks, int H, int n_layers, int bf16,
                       int reduce, void* stream) {
  return (int)launch_weight_grads(bf16 != 0, h, dz, part, dws, rows, rows_per_chunk, n_wchunks,
                                  H, n_layers, static_cast<cudaStream_t>(stream), reduce != 0);
}

// *sink += the sum of the 32-bit words of buf (`bytes`, a multiple of 16),
// `reps` times, modulo 2^32, by `grid` CTAs of 256 threads. Returns a
// cudaError_t.
int reni_anatomy_l2_read(const void* buf, long long bytes, int reps, unsigned* sink, int grid,
                         void* stream) {
  l2_read<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), bytes / 16, reps, sink);
  return (int)cudaGetLastError();
}

const char* reni_anatomy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
