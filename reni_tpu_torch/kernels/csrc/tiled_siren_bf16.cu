// The tiled layer-major passes of tiled_passes.cuh (which holds their design
// note) for the Cond-by-Concat trunk in bf16, behind the plain C interface that
// RENI_TILED_ENTRIES defines there. One source per conditioning and dtype,
// so that the four build side by side. Replaces, for these trunks,
// _step_kernel and _bwd_kernel of reni_tpu/kernels/siren_pallas.py.

#include "tiled_passes.cuh"

RENI_TILED_ENTRIES(__nv_bfloat16, false)
