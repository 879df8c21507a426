"""``mfu.serve``: the traced requests' operations from their shapes
(``flops.serve_request_flops``: the decoder on batch × draws candidates,
the tracker's LM iterations) over the traced window, as a share of the
float32 peak."""

from port_bench import flops


def read(trace, counters, config, traffic):
    if not counters.get("requests"):
        return None
    per = flops.serve_request_flops(config, counters["batch"], counters["draws"],
                                    counters["steps"], counters["P"], counters["M"],
                                    counters["lm_iters"])
    return flops.percent(counters["requests"] * per
                         / (trace.window_s * flops.PEAKS[config["serve_peak"]]))
