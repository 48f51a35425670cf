"""Algorithm registry: resolve algorithms by name.

Reference: ray rllib/algorithms/registry.py (get_algorithm_class) — used
by Tune string trainables ("PPO") and the CLI.

The port's copy of `ray_tpu/rllib/algorithms/registry.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

__all__ = ["get_algorithm_class", "ALGORITHMS"]


def _table():
    from ray_tpu_torch.rllib import algorithms as a

    return {
        "PPO": a.PPO, "APPO": a.APPO, "IMPALA": a.IMPALA, "DQN": a.DQN,
        "SAC": a.SAC, "BC": a.BC, "MARWIL": a.MARWIL, "CQL": a.CQL,
        "DreamerV3": a.DreamerV3,
    }


ALGORITHMS = ("PPO", "APPO", "IMPALA", "DQN", "SAC", "BC", "MARWIL", "CQL",
              "DreamerV3")


def get_algorithm_class(name: str):
    table = _table()
    if name not in table:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {sorted(table)}")
    return table[name]
