"""Binary ID scheme for the cluster kernel.

Follows the reference's ID layout (ray: src/ray/design_docs/id_specification.md):
  JobID     4 bytes
  ActorID  16 bytes = 12B unique | 4B JobID
  TaskID   24 bytes =  8B unique | 16B ActorID (zeros for normal tasks' actor part
                       carry the JobID in the low 4 bytes)
  ObjectID 28 bytes = 24B TaskID | 4B little-endian return/put index

IDs are immutable value objects; hex round-trips; Nil IDs are all-0xff like the
reference. Derivations (task -> return object id) are deterministic so that an
owner can name return objects before execution finishes.
"""

from __future__ import annotations

import os
import random
import threading

_JOB_ID_LEN = 4
_ACTOR_ID_LEN = 16
_TASK_ID_LEN = 24
_OBJECT_ID_LEN = 28

_rand_lock = threading.Lock()
# urandom-seeded PRNG instead of a per-call urandom syscall: TaskID minting
# is on the submit hot path (ray_perf tasks async), and IDs need uniqueness,
# not cryptographic strength. 256 bits of seed entropy per process keeps
# cross-process collision odds at the same 2^-64-per-pair scale as urandom.
_rng = random.Random(os.urandom(32))
_rng_pid = os.getpid()


def _random_bytes(n: int) -> bytes:
    global _rng, _rng_pid
    with _rand_lock:
        if _rng_pid != os.getpid():  # forked child must not replay the parent
            _rng = random.Random(os.urandom(32))
            _rng_pid = os.getpid()
        return _rng.randbytes(n)


class BaseID:
    """Immutable fixed-length binary identifier."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        object.__setattr__(self, "_bytes", bytes(id_bytes))
        object.__setattr__(self, "_hash", hash((type(self).__name__, id_bytes)))

    def __setattr__(self, *a):  # immutable
        raise AttributeError(f"{type(self).__name__} is immutable")

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return self._hash

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_LEN

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_LEN, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = 28


class WorkerID(BaseID):
    SIZE = 28


class ActorID(BaseID):
    SIZE = _ACTOR_ID_LEN

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(cls.SIZE - _JOB_ID_LEN) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-_JOB_ID_LEN:])


class PlacementGroupID(BaseID):
    SIZE = _ACTOR_ID_LEN  # 16B, same layout as ActorID in the reference

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_random_bytes(cls.SIZE - _JOB_ID_LEN) + job_id.binary())


class TaskID(BaseID):
    SIZE = _TASK_ID_LEN

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        # Normal tasks embed a nil actor id whose low bytes carry the job id.
        actor_part = b"\x00" * (_ACTOR_ID_LEN - _JOB_ID_LEN) + job_id.binary()
        return cls(_random_bytes(8) + actor_part)

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(8) + actor_id.binary())

    @classmethod
    def for_actor_creation_task(cls, actor_id: ActorID) -> "TaskID":
        # Deterministic: zeros unique part, so the creation task id is derivable
        # from the actor id alone.
        return cls(b"\x00" * 8 + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[8:])

    def job_id(self) -> JobID:
        return JobID(self._bytes[-_JOB_ID_LEN:])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_LEN

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        # Return indices start at 1 (index 0 is reserved for puts namespace).
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts use the high bit of the index word to avoid colliding with returns.
        return cls(task_id.binary() + (put_index | 0x8000_0000).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_LEN:], "little") & 0x7FFF_FFFF

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[_TASK_ID_LEN:], "little") & 0x8000_0000)

    def job_id(self) -> JobID:
        return self.task_id().job_id()


ObjectRefID = ObjectID  # alias

__all__ = [
    "BaseID",
    "JobID",
    "NodeID",
    "WorkerID",
    "ActorID",
    "PlacementGroupID",
    "TaskID",
    "ObjectID",
]
