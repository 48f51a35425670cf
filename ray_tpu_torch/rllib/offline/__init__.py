"""Offline RL input: episode JSON lines (`io.py`, the port's copy of
`ray_tpu/rllib/offline/io.py`). The off-policy estimators are not ported
yet (ROADMAP.md queue 1, item 3)."""

from ray_tpu_torch.rllib.offline.io import (JsonReader, JsonWriter,  # noqa: F401
                                            load_episode_batches)

__all__ = ["JsonReader", "JsonWriter", "load_episode_batches"]
