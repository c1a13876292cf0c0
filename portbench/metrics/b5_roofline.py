"""kernels: the compensated matmul (B5, kernels named ``kahan_matmul``)
against its roofline, in percent: a step's dense projections (each
microbatch's forward product and the two of its backward pass, from the
configuration's shapes, at the peak of the operands' dtype) at their
least time, divided by the device time a step of those kernels."""

from portbench.harness.yardstick import projection_least_s

NAMES = ("kahan_matmul",)


def read(run):
    busy = run.busy_s(NAMES)
    if busy <= 0:
        return None
    dtype = run.compute_dtype.replace("torch.", "")
    least = projection_least_s(run.fam, run.cfg, run.traffic, dtype)
    return 100.0 * least / (busy / run.steps)
