"""ConnectorV2 pipelines (reference: ray rllib/connectors/connector_v2.py:18
— composable transforms between env <-> module <-> learner; standard pieces
like observation preprocessing and batching live here rather than inside
algorithms).

The port's copy of `ray_tpu/rllib/connectors.py`
(which imports no JAX; the port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class ConnectorV2:
    """One transform stage. Subclasses override __call__(batch) -> batch."""

    def __call__(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipelineV2(ConnectorV2):
    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, batch, **kwargs):
        for c in self.connectors:
            batch = c(batch, **kwargs)
        return batch

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def get_state(self):
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class FlattenObservations(ConnectorV2):
    """Flatten dict/nested observations into a single [B, D] array."""

    def __call__(self, batch, **kwargs):
        obs = batch.get("obs")
        if isinstance(obs, dict):
            parts = [np.asarray(obs[k], np.float32).reshape(
                len(next(iter(obs.values()))), -1) for k in sorted(obs)]
            batch["obs"] = np.concatenate(parts, axis=-1)
        elif obs is not None:
            arr = np.asarray(obs, np.float32)
            batch["obs"] = arr.reshape(arr.shape[0], -1)
        return batch


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (Welford), the classic env-to-module
    connector for MuJoCo-style continuous control."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, batch, *, update_stats: bool = True, **kwargs):
        obs = np.asarray(batch["obs"], np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[-1])
            self._m2 = np.zeros(obs.shape[-1])
        if update_stats:
            for row in obs.reshape(-1, obs.shape[-1]):
                self._count += 1.0
                delta = row - self._mean
                self._mean += delta / self._count
                self._m2 += delta * (row - self._mean)
        var = self._m2 / max(self._count, 1.0)
        norm = (obs - self._mean) / np.sqrt(var + self.eps)
        batch["obs"] = np.clip(norm, -self.clip, self.clip).astype(np.float32)
        return batch

    def get_state(self):
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state):
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipRewards(ConnectorV2):
    """Learner connector: clip rewards into [-bound, bound] (Atari-style)."""

    def __init__(self, bound: float = 1.0):
        self.bound = bound

    def __call__(self, batch, **kwargs):
        if "rewards" in batch:
            batch["rewards"] = np.clip(
                np.asarray(batch["rewards"], np.float32),
                -self.bound, self.bound)
        return batch
