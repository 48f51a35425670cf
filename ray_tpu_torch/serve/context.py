"""Global serve client state (reference: ray python/ray/serve/context.py —
the per-driver handle to the controller, replica-internal context)."""

from __future__ import annotations

import threading
from typing import Any, Optional

_lock = threading.Lock()
_controller = None

CONTROLLER_NAME = "SERVE_CONTROLLER"


def get_controller(create: bool = False):
    """The ServeController detached actor (created on first use)."""
    global _controller
    import ray_tpu_torch

    with _lock:
        if _controller is not None:
            return _controller
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            return _controller
        except ValueError:
            if not create:
                raise RuntimeError(
                    "Serve is not running; call serve.start() or serve.run()"
                ) from None
        from ray_tpu_torch.serve._private.controller import ServeController

        # max_restarts=-1: an UNINTENDED controller death (crash, OOM,
        # node loss) restarts it in place — same actor id, same name —
        # and the fresh incarnation recovers from its GCS-KV checkpoint,
        # adopting live replicas/proxy shards instead of restarting them.
        # ray_tpu_torch.kill() (serve.shutdown) stays terminal.
        _controller = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached", num_cpus=0.1,
            max_concurrency=256, max_restarts=-1,
        ).remote()
        ray_tpu_torch.get(_controller.ping.remote())
        return _controller


def clear_controller_cache() -> None:
    global _controller
    with _lock:
        _controller = None


_replica_context = threading.local()


def get_multiplexed_model_id() -> str:
    return getattr(_replica_context, "multiplexed_model_id", "")


def set_multiplexed_model_id(model_id: str) -> None:
    _replica_context.multiplexed_model_id = model_id


class ReplicaContext:
    """What a deployment can learn about itself from inside a replica
    (reference: serve/context.py ReplicaContext + api.py:140
    get_replica_context)."""

    def __init__(self, app_name: str, deployment: str, replica_tag: str,
                 servable_object: Any):
        self.app_name = app_name
        self.deployment = deployment
        self.replica_tag = replica_tag
        self.servable_object = servable_object

    @property
    def replica_id(self) -> str:  # newer-API alias
        return self.replica_tag


_process_replica_context: Optional[ReplicaContext] = None


def get_replica_context() -> ReplicaContext:
    """Inside a replica: this replica's identity. Raises elsewhere
    (reference: api.py:164)."""
    if _process_replica_context is None:
        raise RuntimeError(
            "`serve.get_replica_context()` may only be called from within "
            "a Serve replica")
    return _process_replica_context


def set_replica_context(ctx: Optional[ReplicaContext]) -> None:
    global _process_replica_context
    _process_replica_context = ctx
