"""DeploymentHandle / DeploymentResponse (reference: ray
python/ray/serve/handle.py:714 DeploymentHandle, .remote() :786 —
composition: handles passed into other deployments' constructors route
requests replica-to-replica without the proxy).
"""

from __future__ import annotations

from typing import Any, Optional

import ray_tpu_torch


class DeploymentResponse:
    """Future for a deployment request (awaitable via .result())."""

    def __init__(self, ref, router=None):
        self._ref = ref
        self._router = router

    def _done(self):
        # releases the router's in-flight charge (probe-free load signal)
        if self._router is not None:
            self._router.notify_done(self._ref)
            self._router = None

    def result(self, timeout_s: Optional[float] = None) -> Any:
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        finally:
            self._done()

    def _to_object_ref(self):
        # composed into another deployment's args: the downstream replica
        # resolves it; release the charge here
        self._done()
        return self._ref

    def __await__(self):
        try:
            result = yield from self._ref.__await__()
        finally:
            self._done()
        return result


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call's chunks (reference:
    handle.py DeploymentResponseGenerator — .options(stream=True))."""

    def __init__(self, ref_gen):
        self._gen = ref_gen

    def __iter__(self):
        for ref in self._gen:
            yield ray_tpu_torch.get(ref)

    def __next__(self):
        return ray_tpu_torch.get(next(self._gen))

    def close(self):
        """Cancel the replica-side generator task (e.g. client went away)."""
        close = getattr(self._gen, "close", None)
        if close is not None:
            close()


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "",
                 method_name: str = "__call__", controller=None,
                 stream: bool = False):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._controller = controller
        self._stream = stream
        self._router = None

    def _get_router(self):
        if self._router is None:
            from ray_tpu_torch.serve._private.router import shared_router
            from ray_tpu_torch.serve.context import get_controller

            controller = self._controller or get_controller()
            self._router = shared_router(
                controller, self.deployment_name, self.app_name)
        return self._router

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None, **_kw) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self._method_name, self._controller,
            self._stream if stream is None else stream)
        h._router = self._router
        return h

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # Unwrap nested DeploymentResponses so composed models pass values.
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: v._to_object_ref() if isinstance(v, DeploymentResponse)
                  else v for k, v in kwargs.items()}
        if self._stream:
            gen = self._get_router().assign_request_streaming(
                self._method_name, args, kwargs)
            return DeploymentResponseGenerator(gen)
        router = self._get_router()
        ref = router.assign_request(self._method_name, args, kwargs)
        return DeploymentResponse(ref, router)

    def try_remote(self, *args, **kwargs) -> Optional[DeploymentResponse]:
        """Non-blocking remote(): None when no replica is available yet
        instead of waiting for one (the proxy's event-loop fast path;
        unary calls only)."""
        if self._stream:
            raise ValueError("try_remote does not support stream=True")
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: v._to_object_ref() if isinstance(v, DeploymentResponse)
                  else v for k, v in kwargs.items()}
        router = self._get_router()
        ref = router.try_assign_request(self._method_name, args, kwargs)
        if ref is None:
            return None
        return DeploymentResponse(ref, router)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._method_name,
                 None, self._stream))
