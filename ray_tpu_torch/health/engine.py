"""Streaming SLO engine: declarative rules evaluated against the
:class:`~ray_tpu_torch.health.store.MetricsStore` on a fixed cadence.

Rule kinds (``ray_tpu_torch/health/slo_rules.json``):

* ``burn_rate`` — multi-window multi-burn-rate availability alerting
  (the SRE-workbook shape): for a counter split by an outcome tag,
  ``err_frac = 1 - good/total`` over a FAST (~5m) and a SLOW (~1h)
  window, normalized to a burn rate ``err_frac / (1 - objective)``; the
  rule breaches only when BOTH windows exceed their thresholds — the
  fast window gives low detection latency, the slow window suppresses
  blips.
* ``rate_above`` — per-second counter rate over the fast window above a
  threshold (shed bursts, deadline expiries, rollout starvation).
* ``quantile_above`` — histogram quantile over the fast window above a
  threshold (TTFT p99).
* ``gauge_below`` / ``gauge_above`` — freshest gauge value vs a
  threshold, with a staleness bound so a dead series never passes as
  healthy-flat (node liveness).

Flap damping: a rule must breach ``for_evals`` consecutive evaluations
to fire and clear ``resolve_evals`` consecutive evaluations to resolve
— resolution is judged on the FAST window only, since the slow window
holds the incident's errors long after recovery. Transitions emit typed
``alert.firing`` / ``alert.resolved`` events (deduped by construction:
one transition per state flip) and drive
``ray_tpu_alerts_firing{rule,severity}``.

All windows are multiplied by ``CONFIG.health_window_scale`` so drills
and smokes can compress the clock (5m→15s) while exercising the
production rules unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import event_log
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.util import metrics as um

logger = logging.getLogger(__name__)

RULES_PATH = os.path.join(os.path.dirname(__file__), "slo_rules.json")

_KINDS = ("burn_rate", "rate_above", "quantile_above",
          "gauge_below", "gauge_above")


@dataclass
class SloRule:
    name: str
    kind: str
    metric: str
    severity: str = "ticket"
    description: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    # burn_rate
    good_tags: Dict[str, str] = field(default_factory=dict)
    objective: float = 0.999
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 10.0
    slow_burn: float = 2.0
    # rate_above / quantile_above / gauge_*
    threshold: float = 0.0
    quantile: float = 0.99
    stale_after_s: float = 60.0
    # damping
    for_evals: int = 1
    resolve_evals: int = 3

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SloRule":
        kind = d.get("kind")
        if kind not in _KINDS:
            raise ValueError(f"rule {d.get('name')!r}: unknown kind {kind!r}")
        allowed = {f for f in cls.__dataclass_fields__}  # noqa: C416
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(
                f"rule {d.get('name')!r}: unknown keys {sorted(unknown)}")
        return cls(**d)


def load_rules(path: Optional[str] = None) -> List[SloRule]:
    with open(path or RULES_PATH) as f:
        raw = json.load(f)
    return [SloRule.from_dict(d) for d in raw["rules"]]


class _RuleState:
    __slots__ = ("breach_run", "clear_run", "firing", "fired_at",
                 "last_value")

    def __init__(self):
        self.breach_run = 0
        self.clear_run = 0
        self.firing = False
        self.fired_at: Optional[float] = None
        self.last_value: Optional[float] = None


class SloEngine:
    """Evaluates rules against a store; owns alert state + history."""

    def __init__(self, store, rules: Optional[List[SloRule]] = None):
        self._store = store
        self.rules = rules if rules is not None else load_rules()
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=512)
        self._evals = 0
        self._gauge = um.get_or_create_gauge(
            "ray_tpu_alerts_firing",
            "1 while the SLO rule is firing, 0 otherwise.",
            ("rule", "severity"))

    # -- evaluation -----------------------------------------------------------

    def _scaled(self, w: float) -> float:
        return max(1.0, w * float(CONFIG.health_window_scale))

    def _breached(self, rule: SloRule, now: float,
                  fast_only: bool = False) -> Optional[bool]:
        """True/False = judged breach; None = no data (treated as
        clear, except gauge rules where staleness IS the signal)."""
        st = self._state[rule.name]
        if rule.kind == "burn_rate":
            denom = max(1e-9, 1.0 - rule.objective)
            windows = [(self._scaled(rule.fast_window_s), rule.fast_burn)]
            if not fast_only:
                windows.append(
                    (self._scaled(rule.slow_window_s), rule.slow_burn))
            for window_s, burn_thresh in windows:
                got = self._store.window_delta(
                    rule.metric, rule.tags or None, now - window_s, now)
                good = self._store.window_delta(
                    rule.metric, {**rule.tags, **rule.good_tags},
                    now - window_s, now)
                if got is None:
                    return None
                total = got[0]
                if total <= 0:
                    return False  # no traffic in window -> no burn
                good_n = good[0] if good is not None else 0.0
                err_frac = max(0.0, 1.0 - good_n / total)
                burn = err_frac / denom
                st.last_value = burn
                if burn <= burn_thresh:
                    return False
            return True
        if rule.kind == "rate_above":
            rate = self._store.window_rate(
                rule.metric, rule.tags or None,
                self._scaled(rule.fast_window_s), now)
            st.last_value = rate
            return None if rate is None else rate > rule.threshold
        if rule.kind == "quantile_above":
            q = self._store.window_quantile(
                rule.metric, rule.tags or None,
                self._scaled(rule.fast_window_s), rule.quantile, now)
            st.last_value = q
            return None if q is None else q > rule.threshold
        # gauge_below / gauge_above
        v = self._store.latest_gauge(
            rule.metric, rule.tags or None,
            max_age_s=self._scaled(rule.stale_after_s), now=now)
        st.last_value = v
        if v is None:
            # dead series: breach for gauge_below (liveness-style rules
            # must not pass on silence), no-data for gauge_above
            return True if rule.kind == "gauge_below" else None
        return v < rule.threshold if rule.kind == "gauge_below" \
            else v > rule.threshold

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One eval pass; returns {"firing": [...], "transitions": n}."""
        now = now if now is not None else time.time()
        transitions = 0
        with self._lock:
            self._evals += 1
            for rule in self.rules:
                st = self._state[rule.name]
                try:
                    breached = self._breached(
                        rule, now, fast_only=st.firing)
                except Exception:
                    logger.debug("slo eval failed for %s",
                                 rule.name, exc_info=True)
                    continue
                if breached:
                    st.breach_run += 1
                    st.clear_run = 0
                else:
                    st.clear_run += 1
                    st.breach_run = 0
                if not st.firing and st.breach_run >= max(1, rule.for_evals):
                    st.firing = True
                    st.fired_at = now
                    transitions += 1
                    self._record(rule, st, now, "alert.firing")
                elif st.firing and st.clear_run >= max(1, rule.resolve_evals):
                    st.firing = False
                    transitions += 1
                    self._record(rule, st, now, "alert.resolved")
                    st.fired_at = None
                self._gauge.set(
                    1.0 if st.firing else 0.0,
                    tags={"rule": rule.name, "severity": rule.severity})
            firing = [r.name for r in self.rules
                      if self._state[r.name].firing]
        every = max(1, int(CONFIG.health_eval_log_every))
        if self._evals % every == 0:
            event_log.emit("health.slo_eval",
                           rules=len(self.rules), firing=len(firing))
        return {"firing": firing, "transitions": transitions}

    def _record(self, rule: SloRule, st: _RuleState, now: float,
                etype: str) -> None:
        value = st.last_value
        if etype == "alert.firing":
            data: Dict[str, Any] = {
                "rule": rule.name, "severity": rule.severity,
                "value": round(value, 6) if value is not None else None}
        else:
            dur = (now - st.fired_at) if st.fired_at is not None else 0.0
            data = {"rule": rule.name, "severity": rule.severity,
                    "duration_s": round(dur, 3)}
        event_log.emit(etype, **data)
        self._history.append({"type": etype, "time": round(now, 3), **data})
        logger.info("%s %s (severity=%s value=%s)",
                    etype, rule.name, rule.severity, value)

    # -- reads ----------------------------------------------------------------

    def active_alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._state[rule.name]
                if st.firing:
                    out.append({"rule": rule.name,
                                "severity": rule.severity,
                                "fired_at": st.fired_at,
                                "value": st.last_value})
            return out

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._history)

    def scorecard(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Per-rule compliance rows for `ray-tpu health`."""
        now = now if now is not None else time.time()
        with self._lock:
            rows = []
            for rule in self.rules:
                st = self._state[rule.name]
                rows.append({
                    "rule": rule.name,
                    "kind": rule.kind,
                    "metric": rule.metric,
                    "severity": rule.severity,
                    "description": rule.description,
                    "firing": st.firing,
                    "fired_at": st.fired_at,
                    "value": st.last_value,
                    "threshold": (rule.fast_burn
                                  if rule.kind == "burn_rate"
                                  else rule.threshold),
                })
            return rows
