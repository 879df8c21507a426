"""``lu_roofline``: the LM solves' least time (``flops.lu_flops_bytes`` of a
batch-row, order-2M solve at the float32 peak or the HBM rate) over the
time of the LU kernel (``lu_reg_kernel``/``lu_smem_kernel``,
``csrc/lu_solve.cu``) in the traced requests; solves = requests × steps ×
LM iterations."""

from port_bench import flops


def read(trace, counters, config, traffic):
    lu_s = trace.op_seconds(lambda name: "lu_reg_kernel" in name or "lu_smem_kernel" in name)
    solves = counters.get("requests", 0) * counters.get("steps", 0) * counters.get("lm_iters", 0)
    if lu_s <= 0 or not solves:
        return None
    ops, nbytes = flops.lu_flops_bytes(counters["batch"], 2 * counters["M"])
    return flops.percent(solves * flops.bound_s(ops, nbytes, flops.PEAKS["float32"]) / lu_s)
