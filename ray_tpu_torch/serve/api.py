"""Public Serve API: @deployment, run, start, shutdown, handles.

Reference: ray python/ray/serve/api.py — serve.run (:544) →
controller.deploy_application (controller.py:719); @serve.deployment
decorator builds Deployment objects; .bind() builds an application graph
whose non-ingress nodes become DeploymentHandles injected into the ingress
constructor (handle.py composition).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch.serve import context as serve_context
from ray_tpu_torch.serve.handle import DeploymentHandle


@dataclasses.dataclass
class Application:
    """A bound deployment graph rooted at the ingress deployment."""

    root: "BoundDeployment"

    def _collect(self) -> List["BoundDeployment"]:
        seen: Dict[str, BoundDeployment] = {}

        def walk(node: BoundDeployment):
            if node.deployment.name in seen:
                return
            seen[node.deployment.name] = node
            for a in list(node.init_args) + list(node.init_kwargs.values()):
                child = _as_bound(a)
                if child is not None:
                    walk(child)

        walk(self.root)
        return list(seen.values())


@dataclasses.dataclass
class BoundDeployment:
    deployment: "Deployment"
    init_args: tuple
    init_kwargs: dict


def _as_bound(value: Any) -> Optional[BoundDeployment]:
    """bind() returns Application; nested graph args may be either form."""
    if isinstance(value, BoundDeployment):
        return value
    if isinstance(value, Application):
        return value.root
    return None


class Deployment:
    def __init__(self, func_or_class: Union[Callable, type],
                 name: Optional[str] = None,
                 num_replicas: Union[int, str, None] = None,
                 ray_actor_options: Optional[dict] = None,
                 user_config: Any = None,
                 max_ongoing_requests: int = 8,
                 autoscaling_config: Optional[dict] = None,
                 health_check_period_s: float = 2.0,
                 health_check_timeout_s: float = 5.0,
                 **_kw):
        self.func_or_class = func_or_class
        self.name = name or getattr(func_or_class, "__name__", "deployment")
        if num_replicas == "auto":
            autoscaling_config = autoscaling_config or {
                "min_replicas": 1, "max_replicas": 10,
                "target_ongoing_requests": 2}
            num_replicas = None
        self.num_replicas = num_replicas or 1
        self.ray_actor_options = ray_actor_options
        self.user_config = user_config
        self.max_ongoing_requests = max_ongoing_requests
        self.autoscaling_config = autoscaling_config
        self.health_check_period_s = health_check_period_s
        self.health_check_timeout_s = health_check_timeout_s

    def options(self, **overrides) -> "Deployment":
        merged = dict(
            name=self.name, num_replicas=self.num_replicas,
            ray_actor_options=self.ray_actor_options,
            user_config=self.user_config,
            max_ongoing_requests=self.max_ongoing_requests,
            autoscaling_config=self.autoscaling_config,
            health_check_period_s=self.health_check_period_s,
            health_check_timeout_s=self.health_check_timeout_s,
        )
        merged.update(overrides)
        return Deployment(self.func_or_class, **merged)

    def bind(self, *args, **kwargs) -> Application:
        return Application(BoundDeployment(self, args, kwargs))

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "Deployments cannot be called directly; use handle.remote() or "
            "serve.run()")


def deployment(func_or_class=None, **options):
    """@serve.deployment decorator."""
    if func_or_class is not None and callable(func_or_class) and not options:
        return Deployment(func_or_class)

    def wrap(fc):
        return Deployment(fc, **options)

    return wrap


def ingress(asgi_app):
    """@serve.ingress(app) — host a FastAPI/Starlette/any-ASGI app inside
    the ingress deployment (reference: serve/api.py @serve.ingress +
    http_util.ASGIAppReplicaWrapper). The proxy forwards raw requests; the
    app runs in the replica. Routes are plain ASGI/FastAPI handlers (module
    functions or closures over the app) — self-injecting method routes are
    not supported.

        fastapi_app = FastAPI()

        @fastapi_app.get("/hello")
        def hello():
            return {"ok": True}

        @serve.deployment
        @serve.ingress(fastapi_app)
        class Api:
            pass
    """
    def wrap(cls):
        from ray_tpu_torch.serve._private.asgi import run_asgi

        class ASGIIngress(cls):
            __serve_asgi__ = True

            async def __call__(self, request: dict):
                return await run_asgi(asgi_app, request or {})

        ASGIIngress.__name__ = getattr(cls, "__name__", "ASGIIngress")
        ASGIIngress.__qualname__ = ASGIIngress.__name__
        return ASGIIngress

    return wrap


def start(detached: bool = True, http_options: Optional[dict] = None,
          **_kw) -> None:
    serve_context.get_controller(create=True)
    if http_options and http_options.get("port"):
        _ensure_proxy(http_options)


_proxy = None

GRPC_NOT_PORTED = ("the gRPC proxy (serve/_private/grpc_proxy.py) is not part "
                   "of ray_tpu_torch's serve yet")


def _ensure_proxy(http_options: Optional[dict] = None):
    """HTTP ingress = N proxy shard actors sharing one listen port; the
    CONTROLLER owns their lifecycle (spawn/health/restart/route pushes).
    `http_options`: host, port, num_shards (default min(4, cpus))."""
    global _proxy
    import ray_tpu_torch

    opts = http_options or {}
    controller = serve_context.get_controller(create=True)
    ray_tpu_torch.get(controller.ensure_http_proxies.remote(
        host=opts.get("host", "127.0.0.1"),
        port=opts.get("port", 8000),
        num_shards=opts.get("num_shards")), timeout=60)
    _proxy = controller
    return _proxy


def run(app: Application, *, name: str = "default", route_prefix: str = "/",
        _blocking: bool = False, http_port: Optional[int] = None,
        http_shards: Optional[int] = None,
        grpc_port: Optional[int] = None,
        grpc_servicer_functions: Optional[list] = None) -> DeploymentHandle:
    if grpc_port is not None or grpc_servicer_functions:
        raise NotImplementedError(f"run(grpc_port=...): {GRPC_NOT_PORTED}")
    controller = serve_context.get_controller(create=True)
    import ray_tpu_torch

    nodes = app._collect()
    deployments = []
    for node in nodes:
        d = node.deployment
        # Replace bound children with handles so replicas route directly.
        init_args = tuple(
            DeploymentHandle(_as_bound(a).deployment.name, name)
            if _as_bound(a) is not None else a
            for a in node.init_args)
        init_kwargs = {
            k: DeploymentHandle(_as_bound(v).deployment.name, name)
            if _as_bound(v) is not None else v
            for k, v in node.init_kwargs.items()}
        code_blob = ser.dumps_function(d.func_or_class)
        # code version (reference: deployment_state.py versioned replicas):
        # identifies WHAT a replica would be constructed from. A redeploy
        # with a different version rolls replicas; a user_config VALUE
        # change reconfigures in place — but removing user_config rolls
        # (live replicas can't be un-configured), hence the presence flag.
        # cloudpickle, not stdlib pickle: init args are routinely local
        # closures, and a repr() fallback would embed memory addresses,
        # making every redeploy look like a code change.
        extras = ser.dumps_function(
            (init_args, init_kwargs, d.ray_actor_options,
             d.max_ongoing_requests, d.user_config is None))
        version = hashlib.sha1(code_blob + extras).hexdigest()[:12]
        deployments.append({
            "name": d.name,
            "callable": code_blob,
            "version": version,
            "init_args": init_args,
            "init_kwargs": init_kwargs,
            "num_replicas": d.num_replicas,
            "ray_actor_options": d.ray_actor_options,
            "user_config": d.user_config,
            "max_ongoing_requests": d.max_ongoing_requests,
            "autoscaling_config": d.autoscaling_config,
            "health_check_period_s": d.health_check_period_s,
            "health_check_timeout_s": d.health_check_timeout_s,
        })
    import inspect as _inspect

    root_fc = app.root.deployment.func_or_class
    call_target = root_fc if not _inspect.isclass(root_fc) else getattr(
        root_fc, "__call__", None)
    ingress_flags = {
        "asgi": bool(getattr(root_fc, "__serve_asgi__", False)),
        "streaming": bool(
            call_target is not None
            and (_inspect.isgeneratorfunction(call_target)
                 or _inspect.isasyncgenfunction(call_target))),
        # streamed chunks are Server-Sent Events: the proxy sets
        # text/event-stream and anti-buffering headers
        "sse": bool(getattr(root_fc, "__serve_sse__", False)),
        # serve.llm apps: name of the engine deployment backing this
        # ingress, so any process can discover LLM apps (CLI/dashboard
        # metric collection) from the controller alone
        "llm_engine": getattr(root_fc, "__serve_llm_engine__", None),
        # router construction knobs: proxy shards build a PER-SHARD
        # embedded LLMRouter from these (shed bound / affinity TTL /
        # default token budget), so HTTP token streams skip the
        # router-deployment hop
        "llm_config": getattr(root_fc, "__serve_llm_config__", None),
    }
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, deployments, app.root.deployment.name, route_prefix,
        ingress_flags))
    if http_port is not None:
        # no explicit route push needed: shards that existed before this
        # deploy already got the push from deploy_application, and fresh
        # shards read the route table in ProxyActor.__init__ (which runs
        # after the deploy above committed)
        _ensure_proxy({"port": http_port, "num_shards": http_shards})
    return DeploymentHandle(app.root.deployment.name, name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = serve_context.get_controller()
    import ray_tpu_torch

    info = ray_tpu_torch.get(controller.get_app_info.remote(name))
    if info is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(info["ingress"], name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def delete(name: str) -> None:
    controller = serve_context.get_controller()
    import ray_tpu_torch

    ray_tpu_torch.get(controller.delete_application.remote(name))


def status() -> Dict[str, Any]:
    controller = serve_context.get_controller()
    import ray_tpu_torch

    apps = ray_tpu_torch.get(controller.list_applications.remote())
    out = {}
    for app_name, info in apps.items():
        deps = {}
        for dep in info["deployments"]:
            deps[dep] = ray_tpu_torch.get(
                controller.get_deployment_status.remote(app_name, dep))
        out[app_name] = {"deployments": deps,
                         "route_prefix": info["route_prefix"]}
    return out


def shutdown() -> None:
    global _proxy
    import ray_tpu_torch

    from ray_tpu_torch.serve._private.router import shutdown_routers

    shutdown_routers()
    try:
        controller = serve_context.get_controller()
    except RuntimeError:
        return
    try:
        # controller.shutdown also kills the HTTP proxy shards it owns
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001 — best-effort teardown
        pass
    _proxy = None
    serve_context.clear_controller_cache()
