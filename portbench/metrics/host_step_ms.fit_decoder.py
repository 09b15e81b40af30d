"""host_step_ms.fit_decoder: the median host time of the port's
``task.step`` span (``reni_tpu_torch/utils/profiling.py``: one step
function's call in ``train/tasks.py::run_stage``, the host's enqueue of a
step) over the traced FIT_DECODER stretch, in ms. None where the program
records no spans."""

import statistics


def read(trace: dict):
    if trace.get("task") != "fit_decoder":
        return None
    try:
        from reni_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    host = [s["host_ms"] for s in snapshot()["spans"]
            if s["name"] == "task.step" and s["host_ms"] is not None]
    return statistics.median(host) if host else None
