"""Training driver of the port (the reference's deprecated ``train/serve``
shim is not carried: serving lives in ``repro_torch.serve``)."""

from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
    make_train_step,
)
