"""inverse_mfu: a FIT_INVERSE step's least time (the decoder's operations at
the bf16 peak plus the shading's at the float32 peak,
``counts.fit_inverse_step``) over the measured step time of the traced
stretch, in %."""


def read(trace: dict):
    if trace.get("task") != "fit_inverse" or not trace.get("steps"):
        return None
    return 100.0 * trace["least_s"] * trace["steps"] / trace["window_s"]
