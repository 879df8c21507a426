"""``entry_ms_per_job.train``: a job's wall time in which the card ran
nothing (the entry's packing, host-to-device copies, ε draw set-up and
copy-back), in ms, averaged over the traced jobs."""


def read(trace, counters, config, traffic):
    jobs = trace.spans_named(".job")
    if not jobs:
        return None
    idle = [(e - s) / 1e9 - trace.busy_between(s, e) for s, e in jobs]
    return 1e3 * sum(idle) / len(idle)
