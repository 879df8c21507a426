"""``mfu.conv``: the traced Conv1D jobs' model FLOPs (``flops.py``, from the
shapes) over the traced window, as a share of the configuration's peak
times the chips used."""

from port_bench import flops


def read(trace, counters, config, traffic):
    return flops.train_mfu(counters, config, trace.window_s)
