"""launch_host_ms.fit_decoder: the host's time a step inside the port's
``kernels.*`` spans (``reni_tpu_torch/utils/profiling.py``: the kernel
wrappers' planning, operand packing and launches; a span inside another
``kernels.*`` span counted once, with it) over the traced FIT_DECODER
stretch, its total over the ``task.step`` spans, in ms. None where the
program records no spans."""


def read(trace: dict):
    if trace.get("task") != "fit_decoder":
        return None
    try:
        from reni_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    steps = sum(s["name"] == "task.step" for s in spans)

    def in_kernels(i) -> bool:
        p = spans[i]["parent"]
        while p is not None:
            if spans[p]["name"].startswith("kernels."):
                return True
            p = spans[p]["parent"]
        return False

    host = sum(s["host_ms"] for i, s in enumerate(spans)
               if s["name"].startswith("kernels.") and s["host_ms"] is not None
               and not in_kernels(i))
    return host / steps if steps else None
