"""device: the share of the traced window in which no operation ran on
the card, in percent: 1 less the union of the device's operation
intervals over the window's host-clock length."""


def read(run):
    if not run.events:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window_s)
