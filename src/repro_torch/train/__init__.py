"""Training loop of the port."""
from repro_torch.train.trainer import (  # noqa: F401
    TrainerConfig,
    TrainState,
    fit,
    make_train_step,
)
