"""decoder_device_ms: the card's time a step inside the port's
``kernels.trunk_fwd`` and ``kernels.trunk_bwd`` spans
(``reni_tpu_torch/utils/profiling.py``: the decoder trunk's forward and
backward kernels; each span's time between its two device events) over
the traced FIT_INVERSE stretch, their total over the ``task.step`` spans,
in ms. None where the program records no spans."""

NAMES = ("kernels.trunk_fwd", "kernels.trunk_bwd")


def read(trace: dict):
    if trace.get("task") != "fit_inverse":
        return None
    try:
        from reni_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    steps = sum(s["name"] == "task.step" for s in spans)
    timed = [s["device_ms"] for s in spans if s["name"] in NAMES and s["device_ms"] is not None]
    return sum(timed) / steps if steps and timed else None
