"""Public exception taxonomy.

Mirrors the reference's taxonomy (ray: python/ray/exceptions.py — RayTaskError
:96, RayActorError :287, ActorDiedError :326, ActorUnavailableError :402,
ObjectStoreFullError :446, OutOfDiskError :463, OutOfMemoryError :483,
NodeDiedError :499, ObjectLostError :511, ObjectFetchTimedOutError,
OwnerDiedError :624, ObjectReconstructionFailed* :663-705, GetTimeoutError
:727, RuntimeEnvSetupError :748, placement-group errors :767-775) so user code
can migrate by renaming the import.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class CrossLanguageError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None, error_message: str = ""):
        self.task_id = task_id
        super().__init__(error_message or f"Task {task_id} was cancelled")


class RayTaskError(RayTpuError):
    """Wraps an exception raised inside a remote task.

    Re-raised on `get` at the caller with the remote traceback attached; the
    `cause` is the original user exception (reference: exceptions.py:96
    as_instanceof_cause behavior is approximated by exposing `.cause`).
    """

    def __init__(
        self,
        function_name: str = "",
        traceback_str: str = "",
        cause: Optional[BaseException] = None,
        *,
        label: str = "task",
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(self._format())

    def _format(self) -> str:
        msg = f"{type(self).__name__}: error in remote {self.function_name}"
        if self.traceback_str:
            msg += "\n\nRemote traceback:\n" + self.traceback_str
        return msg

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name=function_name, traceback_str=tb, cause=exc)

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that isinstance-checks as the cause's type."""
        cause = self.cause
        if cause is None or isinstance(cause, RayTaskError):
            return self
        try:
            cls = type(
                "RayTaskError(" + type(cause).__name__ + ")",
                (RayTaskError, type(cause)),
                {},
            )
            err = cls(self.function_name, self.traceback_str, cause)
            return err
        except TypeError:
            return self


class RayActorError(RayTpuError):
    """The actor died or is unreachable (reference: exceptions.py:287)."""

    def __init__(self, actor_id=None, error_message: str = ""):
        self.actor_id = actor_id
        super().__init__(error_message or f"Actor {actor_id} is dead or unreachable")


class ActorDiedError(RayActorError):
    """The actor died — tasks to it will never succeed (reference :326)."""


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (restarting); retry may succeed
    (reference :402)."""


class ActorPlacementGroupRemoved(RayActorError):
    """The placement group the actor was scheduled in was removed (ref :767)."""


class TaskPlacementGroupRemoved(RayTpuError):
    """The placement group the task was scheduled in was removed (ref :775)."""


class ObjectStoreFullError(RayTpuError):
    """The local object store is out of memory (reference :446)."""


class OutOfDiskError(RayTpuError):
    """Spilling failed: local disk is full (reference :463)."""


class OutOfMemoryError(RayTpuError):
    """A worker was killed by the memory monitor (reference :483)."""


class NodeDiedError(RayTpuError):
    """The node running the task died (reference :499)."""


class ObjectLostError(RayTpuError):
    """An object is unavailable: all copies were lost (reference :511)."""

    def __init__(self, object_ref_hex: str = "", owner_address=None, call_site: str = ""):
        self.object_ref_hex = object_ref_hex
        self.owner_address = owner_address
        super().__init__(f"Object {object_ref_hex} is lost: all copies unavailable.")


class ObjectFetchTimedOutError(ObjectLostError):
    pass


class ObjectFreedError(ObjectLostError):
    """The object was manually freed (reference :604)."""

    def __init__(self, object_ref_hex: str = ""):
        self.object_ref_hex = object_ref_hex
        Exception.__init__(self, f"Object {object_ref_hex} was manually freed.")


class OwnerDiedError(ObjectLostError):
    """The owner process died, so the object's metadata is gone (reference :624)."""

    def __init__(self, object_ref_hex: str = ""):
        self.object_ref_hex = object_ref_hex
        Exception.__init__(
            self, f"Owner of object {object_ref_hex} died; object cannot be retrieved."
        )


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction failed (reference :663)."""


class ObjectReconstructionFailedMaxAttemptsExceededError(ObjectReconstructionFailedError):
    """Reconstruction exceeded max task retries (reference :683)."""


class ObjectReconstructionFailedLineageEvictedError(ObjectReconstructionFailedError):
    """Lineage needed for reconstruction was evicted (reference :705)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get` timed out (reference :727)."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The task's deadline passed before it produced a result.

    Raised for work dropped at queue-pop (doomed-work elimination: the
    raylet lease queue, the worker executor, and the owner's submit pump
    all drop already-expired specs) and for work whose caller-supplied
    budget (`.options(deadline_s=...)`, serve's `X-Request-Deadline`
    header) ran out. Maps to HTTP 504 at the serve proxy. Never
    retried: a deadline is a promise to the caller, not a transient."""

    status_code = 504

    def __init__(self, error_message: str = "", *, layer: str = "",
                 deadline: Optional[float] = None):
        self.layer = layer
        self.deadline = deadline
        super().__init__(
            error_message
            or f"Task deadline exceeded (dropped at layer={layer or '?'})")


class RetryLaterError(RayTpuError):
    """Typed pushback from a bounded queue: the request was refused (not
    queued, not executed) and may be retried after `retry_after_s`.

    Raised by the raylet lease queue, the GCS actor-creation queue and
    the per-actor owner-side mailbox when full. Internal submitters pace
    resubmission with AIMD (_private/backoff.AIMDPacer); user-facing
    surfaces translate it to HTTP 503 + Retry-After. The work is
    accounted SHED (`ray_tpu_shed_total{layer=...}`), never lost."""

    status_code = 503

    def __init__(self, error_message: str = "", *,
                 retry_after_s: float = 1.0, layer: str = ""):
        self.retry_after_s = retry_after_s
        self.layer = layer
        super().__init__(
            error_message
            or f"Queue full at layer={layer or '?'}; "
               f"retry after {retry_after_s:.2f}s")


class RuntimeEnvSetupError(RayTpuError):
    """Creating the runtime environment failed (reference :748)."""

    def __init__(self, error_message: str = ""):
        super().__init__(f"Failed to set up runtime environment: {error_message}")


class RaySystemError(RayTpuError):
    """Internal system error."""


class WorkerCrashedError(RayTpuError):
    """The worker executing a task died unexpectedly (reference:
    exceptions.py WorkerCrashedError)."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's pending call queue is full (max_pending_calls exceeded)."""


class AsyncioActorExit(RayTpuError):
    """Internal: raised by exit_actor() inside an async actor."""


__all__ = [
    "RayTpuError",
    "RayTaskError",
    "TaskCancelledError",
    "RayActorError",
    "ActorDiedError",
    "ActorUnavailableError",
    "ActorPlacementGroupRemoved",
    "TaskPlacementGroupRemoved",
    "ObjectStoreFullError",
    "OutOfDiskError",
    "OutOfMemoryError",
    "NodeDiedError",
    "ObjectLostError",
    "ObjectFetchTimedOutError",
    "ObjectFreedError",
    "OwnerDiedError",
    "ObjectReconstructionFailedError",
    "ObjectReconstructionFailedMaxAttemptsExceededError",
    "ObjectReconstructionFailedLineageEvictedError",
    "GetTimeoutError",
    "DeadlineExceededError",
    "RetryLaterError",
    "RuntimeEnvSetupError",
    "RaySystemError",
    "WorkerCrashedError",
    "PendingCallsLimitExceeded",
]
