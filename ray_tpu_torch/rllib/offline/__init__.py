"""Offline RL input and off-policy estimators: episode JSON lines
(`io.py`) and importance sampling, weighted importance sampling and the
direct method (`estimators.py`), the port's copies of
`ray_tpu/rllib/offline/`."""

from ray_tpu_torch.rllib.offline.estimators import (  # noqa: F401
    DirectMethod,
    ImportanceSampling,
    WeightedImportanceSampling,
)
from ray_tpu_torch.rllib.offline.io import (JsonReader, JsonWriter,  # noqa: F401
                                            load_episode_batches)

__all__ = ["DirectMethod", "ImportanceSampling", "JsonReader", "JsonWriter",
           "WeightedImportanceSampling", "load_episode_batches"]
