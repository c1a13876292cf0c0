"""whole step: model FLOPs a step (6 x the weights a token multiplies by x
the tokens, plus the causal attention's products, no recomputation) over
the device's busy seconds a step in the traced window (the union of its
operations' intervals, so neither the profiler's host overhead nor the
host's gaps count) times the H100's bfloat16 dense peak, in percent."""

from portbench.harness.yardstick import PEAK_FLOPS, step_flops


def read(run):
    if not run.events:
        return None
    flops = step_flops(run.fam, run.cfg, run.traffic)
    return 100.0 * flops / (run.busy_s() / run.steps
                            * PEAK_FLOPS["bfloat16"])
