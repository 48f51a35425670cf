"""Serve config schema + declarative deploy.

Reference: ray python/ray/serve/schema.py (pydantic ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema powering the REST API and
`serve deploy` CLI). Dataclass-based here (no pydantic dependency): a JSON
config names applications by import path plus per-deployment overrides, and
`deploy_config` builds + runs them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    user_config: Any = None
    ray_actor_options: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeploymentSchema":
        known = {f.name for f in dataclasses.fields(DeploymentSchema)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown deployment fields: {sorted(unknown)}")
        return DeploymentSchema(**d)

    def overrides(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in ("num_replicas", "max_ongoing_requests",
                  "autoscaling_config", "user_config", "ray_actor_options"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out


@dataclasses.dataclass
class ServeApplicationSchema:
    import_path: str                      # "module.sub:app_or_builder"
    name: str = "default"
    route_prefix: str = "/"
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    runtime_env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployments: List[DeploymentSchema] = dataclasses.field(
        default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeApplicationSchema":
        d = dict(d)
        deps = [DeploymentSchema.from_dict(x)
                for x in d.pop("deployments", [])]
        known = {f.name for f in dataclasses.fields(ServeApplicationSchema)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown application fields: {sorted(unknown)}")
        return ServeApplicationSchema(deployments=deps, **d)


@dataclasses.dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema]
    # Typed gRPC ingress (reference: schema.py gRPCOptions — port +
    # grpc_servicer_functions, dotted paths to protoc-generated
    # add_XServicer_to_server functions importable on the cluster).
    grpc_options: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeDeploySchema":
        return ServeDeploySchema(applications=[
            ServeApplicationSchema.from_dict(a)
            for a in d.get("applications", [])
        ], grpc_options=d.get("grpc_options"))

    @staticmethod
    def parse_file(path: str) -> "ServeDeploySchema":
        with open(path) as f:
            return ServeDeploySchema.from_dict(json.load(f))


def _import_app(import_path: str, args: Dict[str, Any]):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'")
    target = getattr(importlib.import_module(module_name), attr)
    from ray_tpu_torch.serve.api import Application

    if isinstance(target, Application):
        return target
    if callable(target):  # app builder taking args
        return target(args) if args else target()
    raise TypeError(f"{import_path} is neither an Application nor a builder")


def deploy_config(config: ServeDeploySchema) -> Dict[str, Any]:
    """Build and run every application in the config (the REST/CLI deploy
    path). Returns {app_name: handle}."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.api import GRPC_NOT_PORTED

    if config.grpc_options:
        raise NotImplementedError(f"grpc_options: {GRPC_NOT_PORTED}")
    handles = {}
    for app_schema in config.applications:
        app = _import_app(app_schema.import_path, app_schema.args)
        overrides = {d.name: d.overrides() for d in app_schema.deployments}
        if overrides:
            _apply_overrides(app, overrides)
        handles[app_schema.name] = serve.run(
            app, name=app_schema.name, route_prefix=app_schema.route_prefix)
    return handles


def _apply_overrides(app, overrides: Dict[str, Dict[str, Any]]) -> None:
    """Apply per-deployment config overrides to a built application graph."""
    from ray_tpu_torch.serve.api import BoundDeployment

    seen = set()

    def visit(bound: BoundDeployment):
        if id(bound) in seen:
            return
        seen.add(id(bound))
        ov = overrides.get(bound.deployment.name)
        if ov:
            bound.deployment = bound.deployment.options(**ov)
        for arg in list(bound.init_args) + list(bound.init_kwargs.values()):
            from ray_tpu_torch.serve.api import _as_bound

            child = _as_bound(arg)
            if child is not None:
                visit(child)

    visit(app.root)
