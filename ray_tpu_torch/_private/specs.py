"""L0 common value types: addresses, resource sets, task/actor specs.

Equivalents of the reference's TaskSpecification / ResourceSet / Address
(ray: src/ray/common/task/task_spec.h, scheduling/resource_set.h,
protobuf/common.proto). Specs are plain picklable dataclasses — they ARE the
wire format for the RPC layer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)

Resources = Dict[str, float]


def resources_fit(avail: Resources, demand: Resources) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)


def subtract_resources(avail: Resources, demand: Resources) -> None:
    for k, v in demand.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) - v


def add_resources(avail: Resources, demand: Resources) -> None:
    for k, v in demand.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) + v


@dataclass(frozen=True)
class Address:
    """Location of a worker process: (node, worker id, rpc address)."""

    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    rpc_address: str = ""  # host:port of the worker's RpcServer

    def __repr__(self):
        return f"Address({self.rpc_address})"


class TaskType(Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class TaskArg:
    """Either an inlined serialized value or an ObjectID reference.

    Mirrors the reference's TaskArg (by-value vs by-reference,
    ray: src/ray/common/task/task_util.h).
    """

    is_inline: bool
    data: Any = None                  # SerializedObject when inline
    object_id: Optional[ObjectID] = None
    owner_address: Optional[Address] = None
    # ObjectIDs nested inside an inlined value (borrowed refs).
    nested_ids: List[ObjectID] = field(default_factory=list)


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    name: Optional[str] = None
    namespace: Optional[str] = None
    is_detached: bool = False
    is_asyncio: bool = False
    concurrency_groups: Dict[str, int] = field(default_factory=dict)


@dataclass
class SchedulingStrategySpec:
    """DEFAULT / SPREAD / node-affinity / placement-group strategies."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | NODE_LABEL | PLACEMENT_GROUP
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False
    hard_labels: Optional[Dict[str, Any]] = None  # NODE_LABEL constraints
    soft_labels: Optional[Dict[str, Any]] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function_id: str                    # key into GCS function table
    function_name: str                  # for error messages
    args: List[TaskArg] = field(default_factory=list)
    num_returns: int = 1                # -1 => streaming generator
    resources: Resources = field(default_factory=dict)
    # Resources used for the scheduling decision when they differ from the
    # resources HELD while running (reference: TaskSpec required_resources vs
    # required_placement_resources — a default-cpu actor schedules with 1 CPU
    # but holds 0 for its lifetime).
    placement_resources: Optional[Resources] = None
    owner_address: Optional[Address] = None
    max_retries: int = 0
    retry_exceptions: bool = False
    # worker recycling: the executing worker exits after running this many
    # tasks of the function (0 = unlimited; reference: @ray.remote(max_calls=))
    max_calls: int = 0
    scheduling_strategy: SchedulingStrategySpec = field(
        default_factory=SchedulingStrategySpec
    )
    runtime_env: Optional[dict] = None
    # Actor tasks:
    actor_id: Optional[ActorID] = None
    # -1 = not yet assigned; stamped by the owner's actor push path per
    # incarnation. A spec REQUEUED after a failed push keeps its number
    # (same incarnation) so the worker's sequencing gate never sees a
    # permanent gap — re-stamping a requeued call burned its old slot and
    # stalled every later call 60s at the gate (chaos-harness find).
    sequence_number: int = -1
    method_name: str = ""
    concurrency_group: str = ""
    # Actor creation:
    actor_creation: Optional[ActorCreationSpec] = None
    # Attempt bookkeeping (owner-side retry FSM):
    attempt_number: int = 0
    # Dynamic/streaming generator backpressure:
    generator_backpressure_num_objects: int = -1
    # Trace-context propagation (reference: util/tracing/tracing_helper.py
    # :36-57 inject/propagate through submission): the SUBMITTER's task id
    # (or driver root id). A task's own span id is its task_id, so the
    # timeline joins driver -> task -> nested task into a tree.
    trace_parent: Optional[str] = None
    # Actor creation fast path: small serialized class defs ride IN the
    # creation spec so a fresh worker skips the GCS function-table fetch
    # (every actor is a fresh worker — at 1k-actor burst scale those
    # fetches were a measurable slice of both worker and GCS CPU). Normal
    # tasks leave this None: pooled workers amortize one fetch per
    # function across many tasks.
    function_blob: Optional[bytes] = None
    # Distributed trace context: the flat wire tuple of
    # _private/tracing.TraceContext — (trace_id, span_id, parent_span_id,
    # sampled). span_id is THIS task's own span; children submitted from
    # inside the task parent at it (tracing.current_trace falls back to
    # the executing spec). None = untraced, and every tracing touchpoint
    # is a single `is None` check (the zero-cost-uninstalled
    # bar). Requeued/retried specs keep their context — a requeued actor
    # push is the SAME request, so re-stamping would orphan its spans.
    trace_ctx: Optional[tuple] = None
    # Absolute wall-clock deadline (time.time() domain); None = no bound.
    # Set from .options(deadline_s=), the ambient submission deadline
    # (serve's X-Request-Deadline header), or inherited child-from-parent
    # with the remaining budget (_private/deadlines.py). The wire codec
    # stamps REMAINING time and re-anchors on receipt, so cross-host
    # clock skew shifts the budget instead of corrupting it. Every
    # queue-pop (owner pump, raylet lease queue, worker executor) drops
    # expired specs with a typed DeadlineExceededError.
    deadline_s: Optional[float] = None

    def return_ids(self) -> List[ObjectID]:
        n = max(self.num_returns, 1) if self.num_returns != 0 else 0
        if self.num_returns == -1:
            n = 1  # streaming: the generator ref itself
        return [ObjectID.for_task_return(self.task_id, i + 1) for i in range(n)]

    def is_streaming_generator(self) -> bool:
        return self.num_returns == -1

    def scheduling_key(self) -> tuple:
        """Tasks with equal keys can reuse each other's worker leases."""
        return (
            self.function_id,
            tuple(sorted(self.resources.items())),
            self.scheduling_strategy.kind,
            self.scheduling_strategy.node_id,
            self.scheduling_strategy.placement_group_id,
            self.scheduling_strategy.bundle_index,
            # label constraints route leases to different nodes — tasks with
            # different constraints must never share a lease
            _freeze(self.scheduling_strategy.hard_labels),
            _freeze(self.scheduling_strategy.soft_labels),
        )


def _freeze(labels: Optional[Dict[str, Any]]):
    if not labels:
        return None
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, set)) else v)
        for k, v in labels.items()))


# ---- compact wire codec (task-push hot path) --------------------------------
#
# Pickling the TaskSpec dataclass graph costs ~35us per task round trip
# (nested dataclasses, ID objects, enum lookups); the flat tuples below
# pickle in ~3us. This is the analogue of the reference's fixed protobuf
# encoding for TaskSpec (protobuf/common.proto TaskSpec) vs pickling Python
# objects. Used by push_task_w / its replies (core_worker); everything else
# still pickles specs directly — the codec must stay loss-free for every
# field, but only the push path needs the speed.

def _id_w(i):
    return None if i is None else i.binary()


def _addr_w(a: Optional[Address]):
    if a is None:
        return None
    return (_id_w(a.node_id), _id_w(a.worker_id), a.rpc_address)


def _addr_r(t) -> Optional[Address]:
    if t is None:
        return None
    return Address(
        None if t[0] is None else NodeID(t[0]),
        None if t[1] is None else WorkerID(t[1]),
        t[2],
    )


def _ser_w(s):
    # mirrors SerializedObject.__reduce__: contained_refs are metadata
    # carried in nested_ids; rebuilding them mid-decode would register
    # borrows on the RPC loop (deadlock)
    if s is None:
        return None
    return (s.inband, [bytes(b.raw()) for b in s.buffers])


def _ser_r(t):
    if t is None:
        return None
    import pickle

    from ray_tpu_torch._private.serialization import SerializedObject

    return SerializedObject(t[0], [pickle.PickleBuffer(b) for b in t[1]], [])


def _arg_w(a: TaskArg):
    return (
        a.is_inline,
        _ser_w(a.data) if a.is_inline else None,
        _id_w(a.object_id),
        _addr_w(a.owner_address),
        [i.binary() for i in a.nested_ids],
    )


def _arg_r(t) -> TaskArg:
    return TaskArg(
        is_inline=t[0],
        data=_ser_r(t[1]),
        object_id=None if t[2] is None else ObjectID(t[2]),
        owner_address=_addr_r(t[3]),
        nested_ids=[ObjectID(b) for b in t[4]],
    )


def _strat_w(s: SchedulingStrategySpec):
    if (s.kind == "DEFAULT" and s.node_id is None
            and s.placement_group_id is None
            and s.hard_labels is None and s.soft_labels is None):
        return None  # the overwhelmingly common default strategy
    return (s.kind, _id_w(s.node_id), s.soft, _id_w(s.placement_group_id),
            s.bundle_index, s.capture_child_tasks, s.hard_labels,
            s.soft_labels)


def _strat_r(t) -> SchedulingStrategySpec:
    if t is None:
        return SchedulingStrategySpec()
    return SchedulingStrategySpec(
        kind=t[0],
        node_id=None if t[1] is None else NodeID(t[1]),
        soft=t[2],
        placement_group_id=None if t[3] is None else PlacementGroupID(t[3]),
        bundle_index=t[4],
        capture_child_tasks=t[5],
        hard_labels=t[6],
        soft_labels=t[7],
    )


def spec_to_wire(sp: TaskSpec) -> tuple:
    return (
        sp.task_id.binary(),
        sp.job_id.binary() if sp.job_id is not None else None,
        sp.task_type.value,
        sp.function_id,
        sp.function_name,
        [_arg_w(a) for a in sp.args],
        sp.num_returns,
        sp.resources,
        sp.placement_resources,
        _addr_w(sp.owner_address),
        sp.max_retries,
        sp.retry_exceptions,
        sp.max_calls,
        _strat_w(sp.scheduling_strategy),
        sp.runtime_env,
        _id_w(sp.actor_id),
        sp.sequence_number,
        sp.method_name,
        sp.concurrency_group,
        sp.actor_creation,  # rare (creation only): pickled as-is
        sp.attempt_number,
        sp.generator_backpressure_num_objects,
        [(k, _arg_w(a))
         for k, a in getattr(sp, "kwarg_specs", {}).items()] or None,
        sp.function_blob,
        sp.trace_parent,
        # deadline rides as REMAINING seconds (absolute instants don't
        # survive clock skew between hosts; spec_from_wire re-anchors)
        None if sp.deadline_s is None else sp.deadline_s - time.time(),
        # trace context: already a flat tuple of scalars (tracing.py)
        sp.trace_ctx,
    )


def spec_from_wire(t: tuple) -> TaskSpec:
    sp = TaskSpec(
        task_id=TaskID(t[0]),
        job_id=None if t[1] is None else JobID(t[1]),
        task_type=TaskType(t[2]),
        function_id=t[3],
        function_name=t[4],
        args=[_arg_r(a) for a in t[5]],
        num_returns=t[6],
        resources=t[7],
        placement_resources=t[8],
        owner_address=_addr_r(t[9]),
        max_retries=t[10],
        retry_exceptions=t[11],
        max_calls=t[12],
        scheduling_strategy=_strat_r(t[13]),
        runtime_env=t[14],
        actor_id=None if t[15] is None else ActorID(t[15]),
        sequence_number=t[16],
        method_name=t[17],
        concurrency_group=t[18],
        actor_creation=t[19],
        attempt_number=t[20],
        generator_backpressure_num_objects=t[21],
    )
    sp.kwarg_specs = {} if t[22] is None else {
        k: _arg_r(a) for k, a in t[22]}
    if len(t) > 23:
        sp.function_blob = t[23]
        sp.trace_parent = t[24]
    if len(t) > 25:
        sp.deadline_s = None if t[25] is None else time.time() + t[25]
    if len(t) > 26:
        sp.trace_ctx = t[26]
    return sp


def _borrows_w(r: dict):
    """Arg-borrow retention report (executor._attach_retained_borrows):
    (borrower_address, [oid bytes, ...]) or None. Must survive the wire
    codec — dropping it silently reintroduces the owner frame-exit free
    race for refs nested in task args."""
    held = r.get("retained_borrows")
    if not held or not r.get("borrower_address"):
        return None
    return (r["borrower_address"], [o.binary() for o in held])


def _borrows_r(out: dict, t) -> dict:
    if t is not None:
        out["borrower_address"] = t[0]
        out["retained_borrows"] = [ObjectID(b) for b in t[1]]
    return out


def reply_to_wire(r: dict) -> tuple:
    """PushTaskReply dict -> flat tuple (see reply_from_wire for shape)."""
    if r.get("not_run"):
        return ("not_run",)
    status = r.get("status")
    if status == "ok":
        returns = [
            (oid.binary(), *(_ser_w(p["inline"]) if "inline" in p
                             else (None, None)),
             p.get("location"), p.get("plasma_node"), p.get("size"))
            for oid, p in r.get("returns", [])
        ]
        return ("ok", returns, r.get("exec_s"),
                r.get("streaming_num_items"), r.get("worker_retiring"),
                r.get("stages"), _borrows_w(r))
    if status == "cancelled":
        return ("cancelled", [o.binary() for o in r.get("return_ids", [])])
    return ("error", _ser_w(r.get("error")), r.get("error_str"),
            [o.binary() for o in r.get("return_ids", [])],
            r.get("exec_s"), r.get("worker_retiring"), r.get("stages"),
            _borrows_w(r))


def reply_from_wire(t: tuple) -> dict:
    kind = t[0]
    if kind == "not_run":
        return {"not_run": True}
    if kind == "ok":
        returns = []
        for oid_b, inband, bufs, location, plasma_node, *rest in t[1]:
            if inband is not None:
                payload = {"inline": _ser_r((inband, bufs))}
            else:
                payload = {"location": location, "plasma_node": plasma_node}
                # 6-tuple since the memory-observability PR; tolerate
                # 5-tuples from an in-flight old sender during upgrade
                if rest and rest[0]:
                    payload["size"] = rest[0]
            returns.append((ObjectID(oid_b), payload))
        out = {"status": "ok", "returns": returns}
        if t[2] is not None:
            out["exec_s"] = t[2]
        if t[3] is not None:
            out["streaming_num_items"] = t[3]
        if t[4]:
            out["worker_retiring"] = True
        if len(t) > 5 and t[5] is not None:
            out["stages"] = t[5]
        if len(t) > 6:
            _borrows_r(out, t[6])
        return out
    if kind == "cancelled":
        return {"status": "cancelled",
                "return_ids": [ObjectID(b) for b in t[1]]}
    out = {"status": "error", "error": _ser_r(t[1]), "error_str": t[2],
           "is_application_error": True,
           "return_ids": [ObjectID(b) for b in t[3]]}
    if t[4] is not None:
        out["exec_s"] = t[4]
    if t[5]:
        out["worker_retiring"] = True
    if len(t) > 6 and t[6] is not None:
        out["stages"] = t[6]
    if len(t) > 7:
        _borrows_r(out, t[7])
    return out


class ActorState(Enum):
    """GCS actor lifecycle FSM (reference: gcs_actor_manager.h:251-281)."""

    DEPENDENCIES_UNREADY = 0
    PENDING_CREATION = 1
    ALIVE = 2
    RESTARTING = 3
    DEAD = 4


@dataclass
class ActorInfo:
    actor_id: ActorID
    state: ActorState
    address: Optional[Address] = None
    name: Optional[str] = None
    namespace: str = ""
    is_detached: bool = False
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: Optional[str] = None
    class_name: str = ""
    job_id: Optional[JobID] = None
    pid: int = 0


class PlacementGroupState(Enum):
    PENDING = 0
    PREPARED = 1
    CREATED = 2
    REMOVED = 3
    RESCHEDULING = 4


@dataclass
class PlacementGroupSpec:
    placement_group_id: PlacementGroupID
    bundles: List[Resources]
    strategy: str = "PACK"  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    name: str = ""
    lifetime: Optional[str] = None  # None | "detached"
    job_id: Optional[JobID] = None


@dataclass
class PlacementGroupInfo:
    spec: PlacementGroupSpec
    state: PlacementGroupState
    # bundle index -> node id (filled when committed)
    bundle_locations: Dict[int, NodeID] = field(default_factory=dict)


@dataclass
class NodeInfo:
    node_id: NodeID
    raylet_address: str
    object_manager_address: str = ""
    resources_total: Resources = field(default_factory=dict)
    resources_available: Resources = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    start_time: float = field(default_factory=time.time)
    is_head: bool = False
    # Graceful drain (reference: `ray drain-node`, scripts.py:2268): a
    # draining node accepts no new leases and is excluded from scheduling;
    # it unregisters once its running leases finish (or the deadline hits).
    draining: bool = False


class WorkerExitType(Enum):
    IDLE = 0
    INTENDED_USER_EXIT = 1
    SYSTEM_ERROR = 2
    NODE_DEATH = 3


@dataclass
class JobInfo:
    job_id: JobID
    driver_address: str = ""
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    namespace: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)
    is_dead: bool = False
