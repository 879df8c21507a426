"""``kernels_per_step.serve``: kernels launched on the card (copies and
fills left out) in the traced requests over their tracker steps (requests
× steps): the captured step's launches, with the decode and the reference
building spread over the steps."""


def read(trace, counters, config, traffic):
    steps = counters.get("requests", 0) * counters.get("steps", 0)
    if not steps:
        return None
    n = trace.op_count(lambda name: not name.startswith(("Memcpy", "Memset")))
    return n / steps if n else None
