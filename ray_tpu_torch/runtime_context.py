"""RuntimeContext: ids and placement info for the current process/task.

Reference: ray python/ray/runtime_context.py:15 (get_runtime_context) —
job/task/actor/node ids, namespace, assigned resources.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._raylet import get_core_worker


class RuntimeContext:
    def __init__(self, cw):
        self._cw = cw

    def get_job_id(self) -> str:
        return self._cw.current_job_id().hex()

    def get_node_id(self) -> str:
        return self._cw.node_id.hex() if self._cw.node_id else ""

    def get_worker_id(self) -> str:
        return self._cw.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        spec = self._cw.current_spec()
        return spec.task_id.hex() if spec is not None else None

    def get_actor_id(self) -> Optional[str]:
        aid = self._cw.current_actor_id
        return aid.hex() if aid is not None else None

    def get_actor_name(self) -> Optional[str]:
        aid = self._cw.current_actor_id
        if aid is None:
            return None
        info = self._cw.get_actor_info(aid)
        return info.name if info else None

    @property
    def namespace(self) -> str:
        return self._cw.namespace

    @property
    def gcs_address(self) -> str:
        return self._cw.gcs_address

    def get_accelerator_ids(self) -> dict:
        """The cards visible to this worker (reference: runtime_context.py
        get_accelerator_ids): {"GPU": [...]}, the entries of the
        CUDA_VISIBLE_DEVICES its lease bound it to (the raylet spawns a
        `num_gpus` worker with exactly its cards), else the indices of the
        `GPU` count assigned to the running task or actor."""
        from ray_tpu_torch._private.accelerators import nvidia

        return nvidia.accelerator_ids(self)

    def get_assigned_resources(self) -> dict:
        spec = self._cw.current_spec()
        return dict(spec.resources) if spec is not None else {}

    def get_placement_group_id(self) -> Optional[str]:
        spec = self._cw.current_spec()
        if spec is None:
            return None
        pg = spec.scheduling_strategy.placement_group_id
        return pg.hex() if pg is not None else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        aid = self._cw.current_actor_id
        if aid is None:
            return False
        info = self._cw.get_actor_info(aid)
        return bool(info and info.num_restarts > 0)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(get_core_worker())
