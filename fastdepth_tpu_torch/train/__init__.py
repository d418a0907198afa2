"""Training on the port: masked L1, SGD with momentum, train-mode
BatchNorm (counterpart of ``fastdepth_tpu.train``)."""

from fastdepth_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
    sgd_init,
    train_step,
)
from fastdepth_tpu_torch.train.loss import l1_loss, masked_l1_loss  # noqa: F401
