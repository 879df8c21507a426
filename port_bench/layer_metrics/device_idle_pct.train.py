"""``device_idle_pct.train``: the share of the traced K3 jobs' window in which
no operation ran on the card."""


def read(trace, counters, config, traffic):
    return trace.idle_percent()
