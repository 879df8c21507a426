"""``k3_roofline``: K3's least time at the job's shapes (``flops.py``: the
products and Adam at the bf16 peak, or its bytes at the HBM rate) over
the summed time of its kernels (``ks_*``, ``csrc/fused_scale.cu``)."""

from port_bench import flops


def read(trace, counters, config, traffic):
    k3_s = trace.op_seconds(lambda name: "ks_" in name)
    if not counters.get("jobs") or k3_s <= 0:
        return None
    itemsize = 2 if config["precision"] == "bfloat16" else 4
    ops, nbytes = flops.k3_flops_bytes(config, counters["rows"], counters["job_epochs"],
                                       itemsize, traffic.get("noise") == "hbm")
    bound = flops.bound_s(ops, nbytes, flops.PEAKS[config["peak"]])
    return flops.percent(counters["jobs"] * bound / k3_s)
