"""serve.llm: distributed LLM serving on NVIDIA GPUs.

Composes the pieces the repo already had in isolation into an inference
service: continuous-batching engine replicas
(inference/paged_engine.py serve_stream) behind a token-streaming,
outstanding-token-balancing router with session affinity and 429 load
shedding, reached over streaming-generator actor calls
(num_returns="streaming") and the Serve proxy's chunked/SSE path, with
TTFT/TPOT/queue-depth/occupancy metrics flowing to prometheus_text(),
the dashboard and the CLI (both still to be ported).

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(lambda: PagedInferenceEngine(params, cfg),
                        num_replicas=2, shed_queue_depth=32)
    handle = serve.run(app, name="llm", http_port=8000)
    for tok in handle.options(method_name="stream_tokens",
                              stream=True).remote({"prompt": [1, 2, 3]}):
        ...                       # or: curl -N http://.../llm  (SSE)
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.serve.llm.engine import (  # noqa: F401
    LLMEngineReplica,
    LLMOverloadedError,
    LLMReplicaUnavailableError,
)
from ray_tpu_torch.serve.llm.metrics import (  # noqa: F401
    collect_llm_metrics,
    find_llm_apps,
    serving_summary,
)
from ray_tpu_torch.serve.llm.router import BadRequestError, LLMRouter  # noqa: F401


def build_llm_app(build_engine, *, name: str = "llm",
                  num_replicas: int = 2,
                  default_config: Optional[dict] = None,
                  max_queue_depth: int = 64,
                  shed_queue_depth: int = 64,
                  session_ttl_s: float = 600.0,
                  max_ongoing_requests: int = 32,
                  engine_actor_options: Optional[dict] = None,
                  autoscaling_config: Optional[dict] = None):
    """-> a bindable application: LLMRouter ingress over `num_replicas`
    LLMEngineReplica deployments.

    build_engine() -> PagedInferenceEngine (continuous batching) or
    InferenceEngine (wave batching); constructed inside each replica so
    params land on the replica's device. `shed_queue_depth` is the
    aggregate outstanding-request bound past which the router sheds with
    429; `max_queue_depth` is the per-replica admission backstop."""
    from ray_tpu_torch.serve.api import Deployment

    engine_name = f"{name}_engine"
    engine_d = Deployment(
        LLMEngineReplica, name=engine_name, num_replicas=num_replicas,
        ray_actor_options=engine_actor_options,
        max_ongoing_requests=max_ongoing_requests,
        autoscaling_config=autoscaling_config)
    engine_app = engine_d.bind(build_engine, default_config,
                               max_queue_depth)
    # Stamp the engine deployment's name onto the ingress class: it rides
    # the app's ingress_flags to the controller, making LLM apps (and
    # their metric sources) discoverable from any process (CLI,
    # dashboard) — see metrics.find_llm_apps.
    default_max_new = (default_config or {}).get("max_new_tokens", 64)
    router_cls = type("LLMRouter", (LLMRouter,),
                      {"__serve_llm_engine__": engine_name,
                       # proxy shards rebuild this router config locally
                       # (per-shard embedded ingress; see _private/proxy)
                       "__serve_llm_config__": {
                           "shed_queue_depth": shed_queue_depth,
                           "session_ttl_s": session_ttl_s,
                           "default_max_new_tokens": default_max_new,
                       },
                       "__module__": LLMRouter.__module__})
    router_d = Deployment(router_cls, name=name, num_replicas=1,
                          max_ongoing_requests=128)
    return router_d.bind(engine_app, shed_queue_depth=shed_queue_depth,
                         session_ttl_s=session_ttl_s,
                         default_max_new_tokens=default_max_new)


def llm_deployment(build_engine, *, name: str = "llm",
                   default_config: Optional[dict] = None,
                   num_replicas: int = 1,
                   ray_actor_options: Optional[dict] = None):
    """Single-deployment engine app (no router): the original serve.llm
    surface, kept for handle-first users.

        app = llm_deployment(lambda: InferenceEngine(params, cfg)).bind()
        handle = serve.run(app)
        tokens = handle.generate.remote([1,2,3]).result()
    """
    from ray_tpu_torch.serve.api import Deployment

    d = Deployment(LLMEngineReplica, name=name, num_replicas=num_replicas,
                   ray_actor_options=ray_actor_options,
                   max_ongoing_requests=64)
    return d.bind(build_engine, default_config)


__all__ = [
    "BadRequestError",
    "LLMEngineReplica",
    "LLMOverloadedError",
    "LLMReplicaUnavailableError",
    "LLMRouter",
    "build_llm_app",
    "collect_llm_metrics",
    "find_llm_apps",
    "llm_deployment",
    "serving_summary",
]
