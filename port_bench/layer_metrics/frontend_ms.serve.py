"""``frontend_ms.serve``: a request's client latency minus the serve
program's span (the harness's wrapper, which synchronises the card), in
ms, averaged over the window's requests: HTTP, JSON and the one-threaded
server's turnaround."""


def read(trace, counters, config, traffic):
    gaps = counters.get("frontend_s")
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
