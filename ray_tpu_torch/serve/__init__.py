"""Model serving library of the port: the counterpart of `ray_tpu.serve`,
on the port's own runtime (`ray_tpu_torch.init`).

Reference counterpart: Ray Serve (ray: python/ray/serve — serve.run
api.py:544, ServeController _private/controller.py:86, pow-2 router
_private/replica_scheduler/pow_2_scheduler.py:49, ReplicaActor
replica.py:231, DeploymentHandle handle.py:714, @serve.batch batching.py:468,
@serve.multiplexed multiplex.py:22).

A replica that needs a card asks for it in its actor options
(`ray_actor_options={"num_gpus": 1}`, or `engine_actor_options=` of
`serve.llm.build_llm_app`; two replicas of `num_gpus=0.5` share one card):
the runtime binds its worker to that card through CUDA_VISIBLE_DEVICES.

The serving benchmarks (`run_prefix_ttft_benchmark` here,
`inference.benchmarks.benchmark_serving`) take the serving stack as a value,
`ServingStack`: its entry points `init()`, `run(app, name=)`, `shutdown()`,
`build_llm_app(build_engine, name=, num_replicas=, default_config=,
shed_queue_depth=, engine_actor_options=)`, and for the prefix benchmark
`get_actor(name)` and `get(ref, timeout=)`. Without one they run on this
package's serve (`default_stack()`). The JAX package's runtime is another
such stack, passed in by its caller:

    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.serve.llm import build_llm_app
    from ray_tpu_torch.serve import ServingStack

    stack = ServingStack(
        init=lambda: ray_tpu.init(num_cpus=4, ignore_reinit_error=True),
        run=serve.run, shutdown=serve.shutdown, build_llm_app=build_llm_app,
        get_actor=ray_tpu.get_actor, get=ray_tpu.get)

`LocalServingStack` (`serve.local`) stands in for a stack in one process:
a thread a replica over a port engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ray_tpu_torch.serve.api import (  # noqa: F401
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    ingress,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.context import (  # noqa: F401
    ReplicaContext,
    get_multiplexed_model_id,
    get_replica_context,
)
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.multiplex import multiplexed  # noqa: F401


@dataclasses.dataclass
class ServingStack:
    """The serving stack's entry points, as values."""

    init: Callable[[], Any]
    run: Callable[..., Any]
    shutdown: Callable[[], Any]
    build_llm_app: Callable[..., Any]
    get_actor: Optional[Callable[[str], Any]] = None
    get: Optional[Callable[..., Any]] = None


def default_stack() -> ServingStack:
    """This package's serving stack: the port's runtime (`init` with 4 CPUs,
    as the JAX package's benchmarks start theirs; a running one is kept),
    `serve.run` / `serve.shutdown`, `serve.llm.build_llm_app`."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.llm import build_llm_app

    return ServingStack(
        init=lambda: ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True),
        run=run, shutdown=shutdown, build_llm_app=build_llm_app,
        get_actor=ray_tpu_torch.get_actor, get=ray_tpu_torch.get)


def require_stack(stack, caller: str, *needs: str):
    """`stack` (None: `default_stack()`), or a TypeError naming the entry
    points of it that `caller` needs and it lacks."""
    if stack is None:
        return default_stack()
    missing = [n for n in ("init", "run", "shutdown", "build_llm_app")
               + needs if getattr(stack, n, None) is None]
    if missing:
        raise TypeError(f"{caller}: the stack has no {missing}")
    return stack


def __getattr__(name):
    # torch loads with these, not when a controller or router worker
    # imports the package
    if name == "run_prefix_ttft_benchmark":
        from ray_tpu_torch.serve.benchmarks import run_prefix_ttft_benchmark

        return run_prefix_ttft_benchmark
    if name == "LocalServingStack":
        from ray_tpu_torch.serve.local import LocalServingStack

        return LocalServingStack
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ReplicaContext",
    "get_replica_context",
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "LocalServingStack",
    "ServingStack",
    "batch",
    "default_stack",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "ingress",
    "multiplexed",
    "require_stack",
    "run",
    "run_prefix_ttft_benchmark",
    "shutdown",
    "start",
    "status",
]
