"""model: device-busy milliseconds of a step in the traced window (the
union of its device operations, divided by the steps) less the
optimizer's (``optimizer_ms``): the forward and backward passes, the
loss and the microbatch fold."""

from portbench.harness.yardstick import union_ns


def read(run):
    if not run.events or not run.optimizer_events:
        return None
    step = 1e3 * run.busy_s() / run.steps
    return step - union_ns((s, d) for s, d, _ in run.optimizer_events) / 1e6
