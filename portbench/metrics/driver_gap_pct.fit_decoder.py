"""driver_gap_pct.fit_decoder: the share of the traced FIT_DECODER stretch
(its host-clock length) that lies on the card between one ``task.step``
span's end event and the next one's start event
(``reni_tpu_torch/utils/profiling.py``): the batches' upload, the
metrics' readback and the host's Python between steps, in %. None where
the program records no spans."""


def read(trace: dict):
    if trace.get("task") != "fit_decoder" or not trace.get("window_s"):
        return None
    try:
        from reni_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    steps = sorted((s for s in snapshot()["spans"]
                    if s["name"] == "task.step" and s["device_start_ms"] is not None),
                   key=lambda s: s["device_start_ms"])
    if len(steps) < 2:
        return None
    gap_ms = sum(max(0.0, b["device_start_ms"] - a["device_end_ms"])
                 for a, b in zip(steps, steps[1:]))
    return 100.0 * gap_ms / (1e3 * trace["window_s"])
