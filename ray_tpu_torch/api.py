"""Public API: init / remote / get / put / wait / kill / cancel / get_actor.

Reference: ray python/ray/_private/worker.py — init (:1216), get (:2550),
put (:2662), wait (:2727), get_actor (:2873), kill (:2908), cancel (:2939),
remote decorator (:3119+); process bring-up mirrors _private/node.py:37
(head = GCS + raylet + driver connect, see SURVEY §3.1) except that the head
node's GCS and raylet run as in-process services on their own event loops
rather than separate OS processes (workers are real subprocesses).
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._raylet import ObjectRef, ObjectRefGenerator, get_core_worker, global_state
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.remote_function import RemoteFunction

logger = logging.getLogger(__name__)

_init_lock = threading.RLock()
_global_node = None  # _HeadNode | None


class _HeadNode:
    """In-process head: GCS + head raylet (SURVEY §3.1 process layout)."""

    def __init__(self, num_cpus=None, resources=None, _system_config=None,
                 object_store_memory=None, gpu_info=None):
        from ray_tpu_torch.gcs.server import GcsServer
        from ray_tpu_torch.raylet.raylet import Raylet

        if _system_config:
            CONFIG.apply_system_config(_system_config)
        self.gcs = GcsServer()
        self.gcs_address = self.gcs.start(0)
        node_resources = dict(resources or {})
        if num_cpus is not None:
            node_resources["CPU"] = float(num_cpus)
        self.raylet = Raylet(
            gcs_address=self.gcs_address,
            resources=node_resources or None,
            is_head=True,
            gpu_info=gpu_info,
        )
        self.raylet_address = self.raylet.start(0)

    def stop(self):
        self.raylet.stop(unregister=False)
        self.gcs.stop()


class RayContext:
    def __init__(self, gcs_address: str, node_id, namespace: str):
        self.address_info = {"gcs_address": gcs_address, "address": gcs_address}
        self.node_id = node_id
        self.namespace = namespace

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()

    def __getitem__(self, key):
        return self.address_info[key]


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    resources: Optional[dict] = None,
    namespace: Optional[str] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _system_config: Optional[dict] = None,
    _gpu_info=None,
    **_kwargs,
) -> RayContext:
    """Start a head node in this process (GCS + raylet, workers as
    subprocesses) and connect this process to it as the driver, or connect
    to the cluster whose GCS is at `address` (or RT_ADDRESS).

    The head's raylet advertises this host's cards
    (`nvidia.node_advertisement`, read by a probe process, so the driver
    creates no CUDA context here): `GPU`, the typed `GPU-<part>` and the
    accelerator-type label. Values in `resources` win. `_gpu_info` (a
    `nvidia.GpuInfo`) stands in for the probe, for a node of fake cards.
    The dashboard, the client proxy, `runtime_env` and job submission are
    not part of the port's runtime yet, and their options raise."""
    global _global_node
    for opt in ("include_dashboard", "runtime_env"):
        if _kwargs.get(opt):
            raise NotImplementedError(
                f"init({opt}=...) is not part of ray_tpu_torch's runtime yet")
    with _init_lock:
        if global_state.core_worker is not None:
            if ignore_reinit_error:
                cw = global_state.core_worker
                return RayContext(cw.gcs_address, cw.node_id, cw.namespace)
            raise RuntimeError(
                "ray_tpu_torch.init() has already been called; pass "
                "ignore_reinit_error=True to ignore."
            )
        if address is None:
            address = os.environ.get("RT_ADDRESS")
        if address and address.startswith("client://"):
            raise NotImplementedError(
                "client:// addresses (the client proxy) are not part of "
                "ray_tpu_torch's runtime yet")
        gcs_address = None
        raylet_address = None
        if address is None:
            _global_node = _HeadNode(
                num_cpus=num_cpus, resources=resources,
                _system_config=_system_config,
                object_store_memory=object_store_memory,
                gpu_info=_gpu_info,
            )
            gcs_address = _global_node.gcs_address
            raylet_address = _global_node.raylet_address
        else:
            gcs_address = address
            # Connect as a driver to an existing cluster: use the head raylet.
            from ray_tpu_torch._private.rpc import EventLoopThread, RpcClient

            lt = EventLoopThread("bootstrap")
            client = RpcClient(gcs_address, lt)
            try:
                nodes = client.call("get_all_node_info", {})
            finally:
                client.close()
                lt.stop()
            head = next((n for n in nodes if n.alive and n.is_head), None)
            if head is None:
                head = next((n for n in nodes if n.alive), None)
            if head is None:
                raise ConnectionError(f"no alive nodes in cluster at {gcs_address}")
            raylet_address = head.raylet_address

        from ray_tpu_torch.worker.core_worker import CoreWorker
        from ray_tpu_torch._private.specs import JobInfo

        cw = CoreWorker(
            mode="driver",
            gcs_address=gcs_address,
            raylet_address=raylet_address,
            namespace=namespace or "",
        )
        cw._gcs.call(
            "add_job",
            {"info": JobInfo(job_id=cw.job_id, driver_address=cw.address_str,
                             namespace=namespace or "")},
        )
        atexit.register(shutdown)
        return RayContext(gcs_address, cw.node_id, namespace or "")


def shutdown():
    global _global_node
    with _init_lock:
        cw = global_state.core_worker
        if cw is not None:
            cw.shutdown()
        if _global_node is not None:
            _global_node.stop()
            _global_node = None


def is_initialized() -> bool:
    return global_state.core_worker is not None


def remote(*args, **kwargs):
    """@remote decorator for tasks and actors (worker.py:3119)."""

    def make(target, options):
        if isinstance(target, type):
            return ActorClass(target, options)
        if callable(target):
            return RemoteFunction(target, options)
        raise TypeError(f"@remote target must be a function or class, got {target!r}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return make(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def decorator(target):
        return make(target, dict(kwargs))

    return decorator


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    cw = get_core_worker()
    if isinstance(refs, ObjectRef):
        return cw.get([refs], timeout=timeout)[0]
    if isinstance(refs, ObjectRefGenerator):
        raise TypeError("pass generator items, not the generator, to get()")
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list of them, got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list items must be ObjectRefs, got {type(r)}")
    return cw.get(list(refs), timeout=timeout)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("calling put() on an ObjectRef is not allowed")
    return get_core_worker().put(value)


def wait(
    refs: List[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns <= 0:
        raise ValueError("num_returns must be > 0")
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs")
    return get_core_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    get_core_worker().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    get_core_worker().cancel_task(ref, force=force)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    from ray_tpu_torch._private.specs import ActorState

    info = get_core_worker().get_named_actor(name, namespace)
    if info is None or info.state == ActorState.DEAD:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(info.actor_id)


def available_resources() -> dict:
    cw = get_core_worker()
    nodes = cw._gcs.call("get_all_node_info", {})
    out: dict = {}
    for n in nodes:
        if not n.alive:
            continue
        for k, v in n.resources_available.items():
            out[k] = out.get(k, 0.0) + v
    return out


def cluster_resources() -> dict:
    cw = get_core_worker()
    nodes = cw._gcs.call("get_all_node_info", {})
    out: dict = {}
    for n in nodes:
        if not n.alive:
            continue
        for k, v in n.resources_total.items():
            out[k] = out.get(k, 0.0) + v
    return out


def nodes() -> List[dict]:
    cw = get_core_worker()
    infos = cw._gcs.call("get_all_node_info", {})
    return [
        {
            "NodeID": n.node_id.hex(),
            "Alive": n.alive,
            "RayletAddress": n.raylet_address,
            "Resources": dict(n.resources_total),
            "Labels": dict(n.labels),
            "IsHead": n.is_head,
        }
        for n in infos
    ]
