"""``device_idle_pct.conv``: the share of the traced Conv1D jobs' window in which
no operation ran on the card."""


def read(trace, counters, config, traffic):
    return trace.idle_percent()
