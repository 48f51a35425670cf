"""Training of the port: the train step (one device, or sharded over a
mesh) and AdamW; checkpoints (`checkpoint`) and predictors (`predictor`,
with `BatchPredictor` over a dataset); the gang (`backend`: `TorchConfig`
and `TorchBackend`, which the runtime's `DataParallelTrainer` runs), the
rank-side mesh state (`spmd`) and the multi-GPU bench (`spmd_bench`)."""

from ray_tpu_torch.train.optim import AdamW, AdamWState, adamw, global_norm  # noqa: F401
from ray_tpu_torch.train.step import (TrainState, init_train_state,  # noqa: F401
                                      make_train_step)
from ray_tpu_torch.train.backend import TorchBackend, TorchConfig  # noqa: F401,E402
from ray_tpu_torch.train.checkpoint import (Checkpoint, host_tree,  # noqa: F401,E402
                                            place_like)
from ray_tpu_torch.train.spmd import get_mesh  # noqa: F401,E402
from ray_tpu_torch.train.predictor import BatchPredictor  # noqa: F401,E402
