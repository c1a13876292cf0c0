"""MoE: the share of (token, expert) entries the routing dropped at an
expert's capacity, in percent: each step's returned ``dropped_frac``
(summed over the MoE layers by the program) divided by the MoE layers,
averaged over the traced window's steps. A change that raises it does
less work a token."""


def read(run):
    if not run.moe_layers:
        return None
    drops = [m["dropped_frac"] for m in run.step_metrics]
    return 100.0 * sum(drops) / len(drops) / run.moe_layers
