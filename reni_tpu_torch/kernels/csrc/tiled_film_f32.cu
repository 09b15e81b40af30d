// The tiled layer-major passes of tiled_passes.cuh (which holds their design
// note) for the FiLM trunk in float32, behind the plain C interface that
// RENI_TILED_ENTRIES defines there. One source per conditioning and dtype,
// so that the four build side by side. Replaces, for these trunks,
// _film_step_kernel and _film_bwd_kernel of reni_tpu/kernels/siren_pallas.py.

#include "tiled_passes.cuh"

RENI_TILED_ENTRIES(float, true)
