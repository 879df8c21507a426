"""``tracker_step_us.serve``: device time of the traced requests over their
tracker steps, in µs (the captured step's kernels, and the decode and
reference building spread over the steps)."""


def read(trace, counters, config, traffic):
    steps = counters.get("requests", 0) * counters.get("steps", 0)
    if not steps or not trace.events:
        return None
    return 1e6 * trace.op_seconds() / steps
