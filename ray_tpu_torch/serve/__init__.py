"""Serving benchmarks of the port over a serving stack that comes in as a
value (counterpart of `ray_tpu.serve`'s benchmarks over `serve.llm`).

The stack holds what the benchmarks call: `init()`, `run(app, name=)`,
`shutdown()`, `build_llm_app(build_engine, name=, num_replicas=,
default_config=, shed_queue_depth=)`, and for the prefix benchmark
`get_actor(name)` and `get(ref, timeout=)`. Over the runtime:

    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.serve.llm import build_llm_app
    from ray_tpu_torch.serve import ServingStack

    stack = ServingStack(
        init=lambda: ray_tpu.init(num_cpus=4, ignore_reinit_error=True),
        run=serve.run, shutdown=serve.shutdown, build_llm_app=build_llm_app,
        get_actor=ray_tpu.get_actor, get=ray_tpu.get)

The runtime's `LLMEngineReplica` then runs over the port's
`PagedInferenceEngine`. `LocalServingStack` (`serve.local`) stands in for
it in one process: a thread a replica over a port engine. The runtime's
other serve benchmarks (`run_serve_benchmarks`, `run_sustained_benchmark`)
measure an echo deployment, touch no model, and stay the runtime's own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class ServingStack:
    """The serving stack's entry points, as values."""

    init: Callable[[], Any]
    run: Callable[..., Any]
    shutdown: Callable[[], Any]
    build_llm_app: Callable[..., Any]
    get_actor: Optional[Callable[[str], Any]] = None
    get: Optional[Callable[..., Any]] = None


def require_stack(stack, caller: str, *needs: str):
    """`stack`, or a TypeError naming the `stack=` argument of `caller`
    (there is no default stack to fall back to) or the entry points it
    lacks."""
    if stack is None:
        raise TypeError(
            f"{caller} needs stack=: the serving stack (a ServingStack over "
            "the runtime's serve.llm, or serve.local.LocalServingStack)")
    missing = [n for n in ("init", "run", "shutdown", "build_llm_app")
               + needs if getattr(stack, n, None) is None]
    if missing:
        raise TypeError(f"{caller}: the stack has no {missing}")
    return stack


from ray_tpu_torch.serve.benchmarks import run_prefix_ttft_benchmark  # noqa: E402,F401
from ray_tpu_torch.serve.local import LocalServingStack  # noqa: E402,F401
