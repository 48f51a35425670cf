"""Training of the port: the one-device train step and AdamW."""

from ray_tpu_torch.train.optim import AdamW, AdamWState, adamw, global_norm  # noqa: F401
from ray_tpu_torch.train.step import (TrainState, init_train_state,  # noqa: F401
                                      make_train_step)
