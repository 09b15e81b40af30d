"""train_kernel_roofline: a FIT_DECODER step's least time (its model
operations at the bf16 peak, or its least bytes at the HBM peak, whichever
is larger: ``counts.fit_decoder_step``) over the card's busy time a step,
the union of every kernel's and copy's interval in the trace, in %."""


def read(trace: dict):
    if trace.get("task") != "fit_decoder" or not trace.get("busy_s"):
        return None
    return 100.0 * trace["least_s"] * trace["steps"] / trace["busy_s"]
