"""ActorClass / ActorHandle / ActorMethod.

Reference: ray python/ray/actor.py — ActorClass (:566), ActorHandle (:1226),
ActorMethod (:116), with options num_cpus/max_restarts/max_task_retries/
max_concurrency/name/namespace/lifetime="detached"/get_if_exists (:204,:720).
Async actors: classes with `async def` methods run their methods on an event
loop with max_concurrency (default 1000), matching actor.py:953-956.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch._private import ray_option_utils as opts
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._raylet import get_core_worker
from ray_tpu_torch.util.scheduling_strategies import to_spec


def method(*args, **method_options):
    """Per-method option decorator (reference: ray.method — worker.py
    `method`): `@ray_tpu_torch.method(num_returns=2)` on an actor method makes
    every `handle.m.remote()` mint that many ObjectRefs without a
    per-call `.options()`. Options travel WITH handles (including
    serialized ones); `get_actor` handles fall back to defaults."""
    if args and callable(args[0]) and not method_options:
        return args[0]  # bare @method

    supported = {"num_returns"}
    unknown = set(method_options) - supported
    if unknown:
        raise ValueError(
            f"unsupported @method option(s) {sorted(unknown)}; "
            f"supported: {sorted(supported)}")

    def decorate(fn):
        fn.__ray_method_options__ = dict(method_options)
        return fn

    return decorate


def _collect_method_options(cls) -> Dict[str, Dict[str, Any]]:
    out = {}
    for name, fn in inspect.getmembers(cls, inspect.isfunction):
        o = getattr(fn, "__ray_method_options__", None)
        if o:
            out[name] = dict(o)
    return out


def _is_asyncio_class(cls) -> bool:
    for _name, method in inspect.getmembers(cls, inspect.isfunction):
        if inspect.iscoroutinefunction(method):
            return True
    return False


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns=1, deadline_s=None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._deadline_s = deadline_s

    def options(self, **overrides) -> "ActorMethod":
        return ActorMethod(
            self._handle,
            self._method_name,
            num_returns=overrides.get("num_returns", self._num_returns),
            deadline_s=overrides.get("deadline_s", self._deadline_s),
        )

    def remote(self, *args, **kwargs):
        cw = get_core_worker()
        result = cw.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            deadline_s=self._deadline_s,
        )
        if isinstance(result, list):
            if self._num_returns == 1:
                return result[0]
            if self._num_returns == 0:
                return None
        return result


def _reconstruct_handle(actor_id_bytes: bytes, method_options=None):
    return ActorHandle(ActorID(actor_id_bytes), method_options)


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_options=None):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_method_options", method_options or {})

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("__") and name.endswith("__") and name != "__ray_terminate__":
            raise AttributeError(name)
        o = self._method_options.get(name, {})
        return ActorMethod(self, name,
                           num_returns=o.get("num_returns", 1))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def __reduce__(self):
        return (_reconstruct_handle,
                (self._actor_id.binary(), self._method_options))

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __hash__(self):
        return hash(self._actor_id)


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = opts.validate_options(options or {}, is_actor=True)
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            "use .remote()."
        )

    def options(self, **overrides) -> "ActorClass":
        return ActorClass(self._cls, opts.merge_options(self._options, overrides))

    def remote(self, *args, **kwargs) -> ActorHandle:
        cw = get_core_worker()
        o = self._options
        strategy = to_spec(o.get("scheduling_strategy"), o)
        held, placement = opts.actor_resources_from_options(o)
        actor_id = cw.create_actor(
            self._cls,
            args,
            kwargs,
            resources=held,
            placement_resources=placement,
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            max_concurrency=o.get("max_concurrency"),
            name=o.get("name"),
            namespace=o.get("namespace"),
            lifetime=o.get("lifetime"),
            get_if_exists=o.get("get_if_exists", False),
            scheduling_strategy=strategy,
            is_asyncio=_is_asyncio_class(self._cls),
            runtime_env=o.get("runtime_env"),
        )
        return ActorHandle(actor_id, _collect_method_options(self._cls))

    @property
    def _underlying(self):
        return self._cls


def exit_actor() -> None:
    """Intentionally exit the current actor process (reference: ray
    python/ray/actor.py exit_actor). Call from inside an actor method; the
    in-flight call completes (callers see a normal return of None for the
    terminating call pattern used by __ray_terminate__) and the process
    exits without being treated as a failure, so max_restarts is NOT
    consumed by an intentional exit."""
    from ray_tpu_torch._raylet import get_core_worker

    cw = get_core_worker()
    if not getattr(cw, "is_actor_worker", False):
        raise RuntimeError("exit_actor() called outside an actor")
    # SystemExit (a BaseException), NOT an Exception subclass: user code's
    # broad `except Exception` must not be able to swallow the exit
    # (reference raises SystemExit for sync actors for the same reason).
    raise SystemExit(0)
