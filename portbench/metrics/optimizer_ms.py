"""optimizer: device milliseconds of one AdamW update (``apply_update``:
the global norm, the clip and the update of every leaf) on the cell's
parameters and state with a float32 gradient of their shapes, run by
itself under the profiler after the window: the union of its device
operations."""

from portbench.harness.yardstick import union_ns


def read(run):
    if not run.optimizer_events:
        return None
    return union_ns((s, d) for s, d, _ in run.optimizer_events) / 1e6
