"""Off-policy estimators (reference: ray rllib/offline/estimators/ —
importance_sampling.py, weighted_importance_sampling.py, direct_method.py).

Each estimator scores a target policy on behavior-policy episodes. Episode
batches must carry "action_logp" (behavior log-probs); the target policy is
a callable (obs_batch, actions) -> target log-probs.

The port's copy of `ray_tpu/rllib/offline/estimators.py`
(which imports no JAX; the port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

TargetLogP = Callable[[np.ndarray, np.ndarray], np.ndarray]


def _episode_ratios(batch: Dict[str, np.ndarray],
                    target_logp: TargetLogP, gamma: float):
    """-> (per-step cumulative IS ratios, discounted rewards)."""
    logp_b = np.asarray(batch["action_logp"], dtype=np.float64)
    logp_t = np.asarray(
        target_logp(batch["obs"], batch["actions"]), dtype=np.float64)
    step_ratio = np.exp(np.clip(logp_t - logp_b, -20, 20))
    cum_ratio = np.cumprod(step_ratio)
    discounts = gamma ** np.arange(len(step_ratio))
    rewards = np.asarray(batch["rewards"], dtype=np.float64)
    return cum_ratio, discounts * rewards


class ImportanceSampling:
    """Per-episode trajectory-IS estimate of the target policy's return."""

    def __init__(self, gamma: float = 1.0):
        self.gamma = gamma

    def estimate(self, batches: List[Dict[str, np.ndarray]],
                 target_logp: TargetLogP) -> Dict[str, float]:
        values = []
        for b in batches:
            cum_ratio, disc_r = _episode_ratios(b, target_logp, self.gamma)
            values.append(float(np.sum(cum_ratio * disc_r)))
        v = np.asarray(values)
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(values)}


class WeightedImportanceSampling:
    """Self-normalized (weighted) per-step IS — lower variance than IS."""

    def __init__(self, gamma: float = 1.0):
        self.gamma = gamma

    def estimate(self, batches: List[Dict[str, np.ndarray]],
                 target_logp: TargetLogP) -> Dict[str, float]:
        # per-step normalization across episodes (aligned by timestep)
        max_t = max(len(b["rewards"]) for b in batches)
        ratio_sum = np.zeros(max_t)
        counts = np.zeros(max_t)
        per_ep = []
        for b in batches:
            cum_ratio, disc_r = _episode_ratios(b, target_logp, self.gamma)
            per_ep.append((cum_ratio, disc_r))
            ratio_sum[:len(cum_ratio)] += cum_ratio
            counts[:len(cum_ratio)] += 1
        w_mean = ratio_sum / np.maximum(counts, 1)
        values = [float(np.sum(cum_ratio / np.maximum(
            w_mean[:len(cum_ratio)], 1e-12) * disc_r))
            for cum_ratio, disc_r in per_ep]
        v = np.asarray(values)
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(values)}


class DirectMethod:
    """Model-based estimate: a fitted value function evaluated at episode
    starts (the caller supplies v_fn, e.g. a MARWIL critic)."""

    def __init__(self, v_fn: Callable[[np.ndarray], np.ndarray]):
        self.v_fn = v_fn

    def estimate(self, batches: List[Dict[str, np.ndarray]],
                 target_logp: TargetLogP = None) -> Dict[str, float]:
        starts = np.stack([np.asarray(b["obs"][0]) for b in batches])
        v = np.asarray(self.v_fn(starts), dtype=np.float64).ravel()
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(batches)}
