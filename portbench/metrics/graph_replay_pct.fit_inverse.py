"""graph_replay_pct.fit_inverse: the share of the port's ``task.step``
spans over the traced FIT_INVERSE stretch that hold a ``task.graph_replay``
span (the step replayed one captured CUDA graph of its update), in %. None
where the program records no spans or no replay at all: a program without
a graphed step."""


def read(trace: dict):
    if trace.get("task") != "fit_inverse":
        return None
    try:
        from reni_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "task.step"]
    held = set()
    for s in spans:
        if s["name"] != "task.graph_replay":
            continue
        parent = s["parent"]
        while parent is not None and spans[parent]["name"] != "task.step":
            parent = spans[parent]["parent"]
        if parent is not None:
            held.add(parent)
    if not steps or not held:
        return None
    return 100.0 * len(held) / len(steps)
