"""``mpc_step_roofline``: the tracker step kernels' least time
(``mpc_step_flops.step_flops_bytes`` of the traced steps at the float32
peak or the HBM rate) over the summed time of ``mpc_form_kernel`` and
``mpc_update_kernel`` (``csrc/mpc_step.cu``) in the traced requests; steps
= requests × steps.  Nothing where the program has no such kernels."""

from port_bench import flops, mpc_step_flops


def read(trace, counters, config, traffic):
    k_s = trace.op_seconds(lambda name: "mpc_form_kernel" in name
                           or "mpc_update_kernel" in name)
    steps = counters.get("requests", 0) * counters.get("steps", 0)
    if k_s <= 0 or not steps:
        return None
    ops, nbytes = mpc_step_flops.step_flops_bytes(counters["batch"], counters["P"],
                                                  counters["M"], counters["lm_iters"])
    return flops.percent(steps * flops.bound_s(ops, nbytes, flops.PEAKS["float32"]) / k_s)
