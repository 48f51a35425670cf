"""RLlib callback API: user hooks into the training loop.

Reference: ray rllib/algorithms/callbacks.py (DefaultCallbacks, renamed
RLlibCallback on the new stack) — configured with
``config.callbacks(MyCallbacks)`` and invoked by the Algorithm around
init / train results / episode completion / checkpointing.

The port's copy of `ray_tpu/rllib/callbacks.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["RLlibCallback", "DefaultCallbacks"]


class RLlibCallback:
    """Subclass and override any hook; all are optional no-ops."""

    def on_algorithm_init(self, *, algorithm, **kwargs) -> None:
        pass

    def on_train_result(self, *, algorithm,
                        result: Dict[str, Any], **kwargs) -> None:
        pass

    def on_episode_end(self, *, episode, algorithm=None, **kwargs) -> None:
        pass

    def on_checkpoint_saved(self, *, algorithm, checkpoint_dir: str,
                            **kwargs) -> None:
        pass

    def on_checkpoint_loaded(self, *, algorithm, checkpoint_dir: str,
                             **kwargs) -> None:
        pass


DefaultCallbacks = RLlibCallback  # legacy alias (reference keeps both)


def make_callbacks(spec) -> Optional[RLlibCallback]:
    """Instantiate the configured callbacks: a class, an instance, or
    None."""
    if spec is None:
        return None
    if isinstance(spec, RLlibCallback):
        return spec
    if isinstance(spec, type):
        return spec()
    raise TypeError(
        f"callbacks must be an RLlibCallback subclass or instance, "
        f"got {spec!r}")
