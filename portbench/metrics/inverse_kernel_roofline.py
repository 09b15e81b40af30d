"""inverse_kernel_roofline: a FIT_INVERSE step's least time
(``counts.fit_inverse_step``) over the card's busy time a step in the
trace (the decoder's kernels and PyTorch's shading alike), in %."""


def read(trace: dict):
    if trace.get("task") != "fit_inverse" or not trace.get("busy_s"):
        return None
    return 100.0 * trace["least_s"] * trace["steps"] / trace["busy_s"]
