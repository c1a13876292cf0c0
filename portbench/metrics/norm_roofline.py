"""kernels: the global norm's kernels against their roofline, in percent:
the float32 gradient's bytes read once at the HBM's rate, divided by the
device time a step of the kernels named ``kahan_sq_columns`` (the column
scan) or ``kahan_sum_grid`` (B3). The work is the same whichever of them
computes the norm."""

from portbench.harness.yardstick import HBM_BYTES_S, norm_bytes

NAMES = ("kahan_sq_columns", "kahan_sum_grid")


def read(run):
    busy = run.busy_s(NAMES)
    if busy <= 0:
        return None
    least = norm_bytes(run.layout) / HBM_BYTES_S
    return 100.0 * least / (busy / run.steps)
