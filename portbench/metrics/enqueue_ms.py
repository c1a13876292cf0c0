"""trainer: host milliseconds a ``train_step`` call takes to return, before
the synchronise that ends the step, averaged over the traced window's
steps (the benchmark's own span around each call)."""


def read(run):
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
