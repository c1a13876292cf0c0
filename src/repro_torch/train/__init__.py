"""Training driver of the port, and the prefill and decode steps of the
dry run (``train.serve``; the reference's deprecated ``Server`` shim is
not carried: serving lives in ``repro_torch.serve``)."""

from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    make_train_step,
)
