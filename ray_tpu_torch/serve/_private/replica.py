"""Replica actor: wraps the user's callable (reference: ray
python/ray/serve/_private/replica.py:231 ReplicaActor, :738
UserCallableWrapper — exposes queue length for the pow-2 router, runs
user __call__ / methods, supports async callables and streaming).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, Dict, Optional


class ReplicaActor:
    """Hosts one copy of a deployment's user callable."""

    def __init__(self, serialized_init: Dict[str, Any]):
        from ray_tpu_torch._private import serialization as ser

        cls_or_fn = ser.loads_function(serialized_init["callable"])
        args = serialized_init.get("init_args", ())
        kwargs = serialized_init.get("init_kwargs", {})
        self._deployment = serialized_init.get("deployment", "")
        self._replica_id = serialized_init.get("replica_id", "")
        # publish the replica context BEFORE constructing the user callable
        # so serve.get_replica_context() works inside __init__ too
        from ray_tpu_torch.serve import context as serve_ctx

        ctx = serve_ctx.ReplicaContext(
            app_name=serialized_init.get("app", ""),
            deployment=self._deployment,
            replica_tag=self._replica_id,
            servable_object=None,
        )
        serve_ctx.set_replica_context(ctx)
        if inspect.isclass(cls_or_fn):
            self._callable = cls_or_fn(*args, **kwargs)
            self._is_function = False
        else:
            self._callable = cls_or_fn
            self._is_function = True
        ctx.servable_object = self._callable
        self._num_ongoing = 0
        self._num_processed = 0
        self._lock = threading.Lock()
        self._healthy = True

    # -- metrics / control ---------------------------------------------------

    def get_queue_len(self) -> int:
        return self._num_ongoing

    def get_metrics(self) -> Dict[str, Any]:
        out = {
            "replica_id": self._replica_id,
            "num_ongoing_requests": self._num_ongoing,
            "num_processed": self._num_processed,
        }
        # User callables can report load the request counter can't see
        # (e.g. an LLM engine's admission backlog): merged here so the
        # controller's autoscaler and the routers' piggybacked load
        # scores both account for it.
        hook = getattr(self._callable, "get_autoscaling_metrics", None)
        if callable(hook):
            try:
                extra = hook()
                if isinstance(extra, dict):
                    out.update(extra)
            except Exception:  # noqa: BLE001 — user hook must not break
                pass            # the control loop
        return out

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None:
            user_check()
        return True

    def get_node_id(self) -> str:
        """Node attribution for the controller's preemption drains."""
        import ray_tpu_torch

        return ray_tpu_torch.get_runtime_context().get_node_id()

    def reconfigure(self, user_config: Any) -> None:
        hook = getattr(self._callable, "reconfigure", None)
        if hook is not None:
            hook(user_config)

    def prepare_shutdown(self) -> None:
        hook = getattr(self._callable, "shutdown", None)
        if callable(hook):
            hook()

    # -- request path --------------------------------------------------------

    def _user_loop(self) -> asyncio.AbstractEventLoop:
        """Private event loop for async user callables (lazily started)."""
        loop = getattr(self, "_loop", None)
        if loop is None:
            loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=loop.run_forever, name="rt-replica-loop", daemon=True)
            t.start()
            self._loop = loop
        return loop

    def _target(self, method_name: str):
        if self._is_function or method_name in ("__call__", ""):
            return self._callable
        return getattr(self._callable, method_name)

    def handle_request(self, method_name: str, args: tuple,
                       kwargs: dict) -> Any:
        with self._lock:
            self._num_ongoing += 1
        try:
            out = self._target(method_name)(*args, **kwargs)
            if inspect.iscoroutine(out):
                fut = asyncio.run_coroutine_threadsafe(out, self._user_loop())
                out = fut.result()
            if inspect.isgenerator(out):
                return list(out)
            return out
        finally:
            with self._lock:
                self._num_ongoing -= 1
                self._num_processed += 1

    def handle_request_streaming(self, method_name: str, args: tuple,
                                 kwargs: dict):
        """Generator variant: chunks stream back as a streaming-generator
        task (reference: replica.py handle_request_streaming — backs both
        handle .options(stream=True) and HTTP streaming responses)."""
        with self._lock:
            self._num_ongoing += 1
        try:
            out = self._target(method_name)(*args, **kwargs)
            if inspect.iscoroutine(out):
                fut = asyncio.run_coroutine_threadsafe(out, self._user_loop())
                out = fut.result()
            if inspect.isasyncgen(out):
                loop = self._user_loop()
                while True:
                    try:
                        chunk = asyncio.run_coroutine_threadsafe(
                            out.__anext__(), loop).result()
                    except StopAsyncIteration:
                        return
                    yield chunk
            elif inspect.isgenerator(out):
                yield from out
            else:
                yield out
        finally:
            with self._lock:
                self._num_ongoing -= 1
                self._num_processed += 1
