"""``kernels_per_epoch.conv``: kernels launched on the card (copies and
fills left out) over the epochs the traced Conv1D jobs ran."""


def read(trace, counters, config, traffic):
    if not counters.get("epochs"):
        return None
    n = trace.op_count(lambda name: not name.startswith(("Memcpy", "Memset")))
    return n / counters["epochs"] if n else None
