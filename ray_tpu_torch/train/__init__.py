"""Training of the port: the train step (one device, or sharded over a
mesh) and AdamW; the gang (`backend`), the rank-side mesh state (`spmd`)
and the multi-GPU bench (`spmd_bench`)."""

from ray_tpu_torch.train.optim import AdamW, AdamWState, adamw, global_norm  # noqa: F401
from ray_tpu_torch.train.step import (TrainState, init_train_state,  # noqa: F401
                                      make_train_step)
