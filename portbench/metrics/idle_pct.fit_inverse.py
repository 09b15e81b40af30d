"""idle_pct.fit_inverse: the share of the traced FIT_INVERSE stretch in
which no kernel or copy ran on the card, in %."""


def read(trace: dict):
    if trace.get("task") != "fit_inverse" or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
