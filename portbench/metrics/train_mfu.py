"""train_mfu: a FIT_DECODER step's model operations at the bf16 peak
(``counts.fit_decoder_step``, a card's share of the batch) over the
measured step time of the traced stretch (its host-clock length over its
steps, the card synchronised at both ends), in %."""


def read(trace: dict):
    if trace.get("task") != "fit_decoder" or not trace.get("steps"):
        return None
    return 100.0 * trace["least_s"] * trace["steps"] / trace["window_s"]
