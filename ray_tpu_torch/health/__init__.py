"""Cluster health plane.

Three cooperating pieces, all hosted GCS-side (Ray's GCS-as-control-
plane shape — the natural home for cluster-wide state):

* ``store`` — a bounded two-tier metric time-series store: every
  process's ``util.metrics`` registry is pushed on a background cadence
  (``health/push.py`` → ``push_metrics`` RPC) into raw rings plus
  10s/1m rollups (rate / p50 / p99), queryable by name/tags/time-range
  via ``query_metrics``.
* ``engine`` — a streaming SLO evaluator: declarative rules
  (``slo_rules.json``) judged every ``health_eval_interval_s`` with
  multi-window burn-rate semantics, emitting typed ``alert.firing`` /
  ``alert.resolved`` events with dedup + flap damping and exporting
  ``ray_tpu_alerts_firing{rule,severity}``.
* ``demand`` — autoscaler-ready demand signals (serve queue depth +
  TTFT, rl starvation/shed, pending placement groups, per-pool
  utilization) derived from the store as one structured RPC
  (``get_demand_signals``).

The GCS assembles them in ``gcs/metrics_manager.py``; surfaces are
``ray-tpu health`` / ``ray-tpu alerts``, the dashboard Health page, and
alert-annotated Grafana panels.
"""

from ray_tpu_torch.health.store import MetricsStore  # noqa: F401
from ray_tpu_torch.health.engine import SloEngine, SloRule, load_rules  # noqa: F401
