"""``device_idle_pct.serve``: the share of the traced requests' window in which
no operation ran on the card."""


def read(trace, counters, config, traffic):
    return trace.idle_percent()
