"""Deterministic, seeded fault injection at the RPC chokepoint.

Every GCS/raylet/worker/object-service message flows through
`RpcClient.call_async` / `RpcServer._dispatch` (rpc.py), so one
interception layer can drop, delay, duplicate, error, or hard-disconnect
any control- or data-plane message in the system — the message-level
analogue of `ray-tpu kill-random-node`'s process-level chaos. The
reference's fault-tolerance story (lineage + ownership recovery,
arXiv:1712.05889) must survive exactly these failures, and nothing
exercised them systematically before this layer.

Design constraints:

* ZERO overhead uninstalled — the transport hot path pays one module
  attribute load + `is not None` check (`fault_injection.PLAN`), nothing
  else. No plan object, no rule scan, no RNG.
* DETERMINISTIC — a plan owns a seed; each rule gets its own
  `random.Random((seed, rule_index))` and fires on its own match
  counter, so the same seed and the same sequence of intercepted calls
  reproduce the identical fault sequence (asserted by
  tests/test_fault_injection.py via `ChaosPlan.fingerprint()`).
* ADDRESSABLE — rules select injection sites by method glob, endpoint
  label glob (gcs / raylet / driver / worker), and peer glob; node pairs
  can be partitioned symmetrically; `kill` fires at named lifecycle
  points (`before_execute`, `after_reply`, `mid_stream`).

Installation paths:

* in-process: `ray_tpu_torch.chaos.install(plan)` (tests, notebooks);
* env: `RAY_TPU_CHAOS='{"seed": 7, "rules": [...]}'` (or a path to a
  JSON file) — read at import, so spawned workers inherit the plan;
* live cluster: `ray-tpu chaos start --plan plan.json` → GCS
  `chaos_start` RPC fans out to every alive raylet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from fnmatch import fnmatchcase
from random import Random
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_CHAOS"

# Injection sites wired into the transport (rules may glob over these).
SITE_CLIENT_REQUEST = "client_request"   # RpcClient before writing a frame
SITE_BEFORE_EXECUTE = "before_execute"   # RpcServer before the handler runs
SITE_AFTER_REPLY = "after_reply"         # RpcServer before sending the reply
SITE_MID_STREAM = "mid_stream"           # executor before a generator item report

ACTIONS = ("drop", "delay", "error", "duplicate", "disconnect", "kill")

# THE hot-path global: transports check `fault_injection.PLAN is not None`
# and bail — install/uninstall swap this atomically.
PLAN: Optional["ChaosPlan"] = None

_install_lock = threading.Lock()


class ChaosError(Exception):
    """Raised for malformed plans/rules (never from the injection path)."""


@dataclass
class ChaosRule:
    """One injection rule. All selectors are case-sensitive globs.

    action:   drop | delay | error | duplicate | disconnect | kill
    site:     which chokepoint(s) the rule applies to (glob over SITE_*)
    method:   RPC method name glob (e.g. "request_worker_lease",
              "push_task*", "report_*")
    label:    the LOCAL endpoint's label glob ("gcs", "raylet", "driver",
              "worker", ...)
    peer:     peer glob — the target address for client-side sites, the
              registered peer label/worker id (or host:port) server-side
    p:        per-match fire probability, drawn from the rule's own
              seeded RNG (1.0 = always)
    after:    skip the first N matches (fault the (N+1)-th occurrence)
    times:    stop firing after this many injections (None = unlimited)
    delay_s:  sleep for action="delay"
    maybe_delivered: the flag carried by the ConnectionLost raised for
              action="error" (False models connect-refused, True models
              reply-lost ambiguity)
    """

    action: str
    site: str = "*"
    method: str = "*"
    label: str = "*"
    peer: str = "*"
    p: float = 1.0
    after: int = 0
    times: Optional[int] = None
    delay_s: float = 0.05
    maybe_delivered: bool = False

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ChaosError(
                f"unknown action {self.action!r}; expected one of {ACTIONS}")
        if (self.site == SITE_MID_STREAM
                and self.action in ("duplicate", "disconnect")):
            # mid_stream is an executor-side lifecycle point, not a frame
            # site: only drop/delay/error/kill are meaningful there.
            # Rejecting here keeps the fingerprint honest — a rule must
            # never count as "fired" at a site that ignores its action.
            raise ChaosError(
                f"action {self.action!r} is not supported at site "
                f"{SITE_MID_STREAM!r} (use drop/delay/error/kill)")
        known = (SITE_CLIENT_REQUEST, SITE_BEFORE_EXECUTE,
                 SITE_AFTER_REPLY, SITE_MID_STREAM)
        if (self.site not in known
                and not any(c in self.site for c in "*?[")):
            raise ChaosError(
                f"unknown site {self.site!r}: not one of {known} and not "
                "a glob — a typo here would silently never fire")

    def matches(self, site: str, method: str, label: str, peer: str) -> bool:
        return (fnmatchcase(site, self.site)
                and fnmatchcase(method, self.method)
                and fnmatchcase(label, self.label)
                and fnmatchcase(peer, self.peer))


@dataclass
class _RuleState:
    rng: Random
    match_count: int = 0
    fire_count: int = 0


class ChaosPlan:
    """A seeded set of rules + node-pair partitions, with an event log.

    Thread-safe: decisions come from every component's event-loop thread;
    one lock guards the counters and the log. The log is the
    reproducibility artifact — `fingerprint()` hashes the fired sequence
    so two runs with the same seed can be compared exactly.
    """

    def __init__(self, seed: int = 0,
                 rules: Optional[List[ChaosRule]] = None,
                 partitions: Optional[List[Tuple[str, str]]] = None,
                 max_events: int = 10_000):
        self.seed = int(seed)
        self.rules: List[ChaosRule] = list(rules or [])
        # Symmetric address/label glob pairs: traffic between a matching
        # local/peer pair fails like an unreachable network.
        self.partitions: List[Tuple[str, str]] = [
            (a, b) for a, b in (partitions or [])]
        self.max_events = max_events
        self.events: List[Tuple[int, str, str, str, str, str]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._states = [
            _RuleState(rng=Random(f"{self.seed}:{i}"))
            for i in range(len(self.rules))
        ]
        self.installed_at: Optional[float] = None

    # -- construction helpers -------------------------------------------------

    def add_rule(self, rule: ChaosRule) -> "ChaosPlan":
        with self._lock:
            self.rules.append(rule)
            self._states.append(
                _RuleState(rng=Random(f"{self.seed}:{len(self.rules) - 1}")))
        return self

    def partition(self, a: str, b: str) -> "ChaosPlan":
        """Partition two endpoints (address or label globs), symmetric."""
        with self._lock:
            self.partitions.append((a, b))
        return self

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> "ChaosPlan":
        """Remove a partition (or all partitions when called bare)."""
        with self._lock:
            if a is None:
                self.partitions.clear()
            else:
                self.partitions = [
                    p for p in self.partitions
                    if set(p) != {a, b if b is not None else a}]
        return self

    # -- decision core --------------------------------------------------------

    def is_partitioned(self, local_id: str, peer: str) -> bool:
        for a, b in self.partitions:
            if ((fnmatchcase(local_id, a) and fnmatchcase(peer, b))
                    or (fnmatchcase(local_id, b) and fnmatchcase(peer, a))):
                return True
        return False

    def decide(self, site: str, method: str = "", label: str = "",
               peer: str = "") -> List[ChaosRule]:
        """All rules firing for this call, in rule order. Updates counters
        and the event log under the lock — the decision itself is pure
        function of (plan state, call sequence), never of wall time."""
        fired: List[ChaosRule] = []
        with self._lock:
            for rule, st in zip(self.rules, self._states):
                if not rule.matches(site, method, label, peer):
                    continue
                n = st.match_count
                st.match_count += 1
                if n < rule.after:
                    continue
                if rule.times is not None and st.fire_count >= rule.times:
                    continue
                if rule.p < 1.0 and st.rng.random() >= rule.p:
                    continue
                st.fire_count += 1
                fired.append(rule)
                self._record_locked(site, method, label, peer, rule.action)
        return fired

    def _record_locked(self, site, method, label, peer, action):
        self._seq += 1
        if len(self.events) < self.max_events:
            self.events.append((self._seq, site, method, label, peer, action))

    def record(self, site: str, method: str, label: str, peer: str,
               action: str) -> None:
        with self._lock:
            self._record_locked(site, method, label, peer, action)

    # -- observability --------------------------------------------------------

    def fingerprint(self) -> Tuple[Tuple[str, str, str], ...]:
        """(site, method, action) sequence of every fired injection —
        identical across runs for the same seed and call sequence."""
        with self._lock:
            return tuple((site, method, action)
                         for _, site, method, _, _, action in self.events)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": len(self.rules),
                "partitions": list(self.partitions),
                "fired_total": self._seq,
                "fired_by_rule": [st.fire_count for st in self._states],
                "installed_at": self.installed_at,
                "recent_events": [
                    {"seq": s, "site": site, "method": m, "label": lb,
                     "peer": p, "action": a}
                    for s, site, m, lb, p, a in self.events[-20:]],
            }

    # -- (de)serialization ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "rules": [asdict(r) for r in self.rules],
            "partitions": [list(p) for p in self.partitions],
        })

    @classmethod
    def from_json(cls, raw: str) -> "ChaosPlan":
        try:
            doc = json.loads(raw)
        except ValueError as e:
            raise ChaosError(f"chaos plan is not valid JSON: {e}") from None
        if not isinstance(doc, dict):
            raise ChaosError("chaos plan must be a JSON object")
        rules = [ChaosRule(**r) for r in doc.get("rules", [])]
        partitions = [tuple(p) for p in doc.get("partitions", [])]
        return cls(seed=doc.get("seed", 0), rules=rules,
                   partitions=partitions)


# -- install / uninstall ------------------------------------------------------

def _emit_event(etype: str, proc: str = "", **data) -> None:
    """Chaos firings into the lifecycle event log (_private/event_log) so
    an injection run's ACTUAL history is auditable after `chaos stop`
    (`ray-tpu chaos status`, `ray-tpu debug postmortem`). Lazy import +
    best-effort: chaos must keep working in a process where the event
    log cannot."""
    try:
        from ray_tpu_torch._private import event_log

        event_log.emit(etype, proc=proc or None, **data)
    except Exception:  # noqa: BLE001 — observability never blocks faults
        pass


def install(plan: ChaosPlan) -> ChaosPlan:
    """Install a plan process-wide. Replaces any existing plan."""
    global PLAN
    with _install_lock:
        plan.installed_at = time.time()
        PLAN = plan
        logger.warning(
            "chaos plan INSTALLED (seed=%d, %d rules, %d partitions)",
            plan.seed, len(plan.rules), len(plan.partitions))
    _emit_event("chaos.plan", op="install", seed=plan.seed,
                rules=len(plan.rules))
    return plan


def uninstall() -> Optional[ChaosPlan]:
    """Remove the active plan; returns it (with its event log) if any."""
    global PLAN
    with _install_lock:
        plan, PLAN = PLAN, None
    if plan is not None:
        logger.warning("chaos plan UNINSTALLED (%d injections fired)",
                       plan._seq)
        _emit_event("chaos.plan", op="uninstall", seed=plan.seed,
                    rules=len(plan.rules))
    return plan


def active_plan() -> Optional[ChaosPlan]:
    return PLAN


def load_env_plan(env: Optional[Dict[str, str]] = None) -> Optional[ChaosPlan]:
    """Install the plan named by RAY_TPU_CHAOS (inline JSON, or a path —
    optionally prefixed with '@'). Returns the installed plan or None."""
    raw = (env if env is not None else os.environ).get(ENV_VAR, "").strip()
    if not raw:
        return None
    try:
        if not raw.startswith("{"):
            path = raw[1:] if raw.startswith("@") else raw
            with open(path) as f:
                raw = f.read()
        return install(ChaosPlan.from_json(raw))
    except Exception:  # noqa: BLE001 — a bad plan must not kill bring-up
        logger.exception("failed to load %s chaos plan; ignoring", ENV_VAR)
        return None


# -- transport-facing interceptors -------------------------------------------
# Called only behind `fault_injection.PLAN is not None` checks; rpc.py owns
# the frame-level semantics (what "drop"/"duplicate"/"disconnect" mean for
# its wire protocol) while these apply delay/error/kill/partition inline.

def _connection_lost(msg: str, maybe_delivered: bool):
    from ray_tpu_torch._private.rpc import ConnectionLost  # no import cycle: lazy

    return ConnectionLost(msg, maybe_delivered=maybe_delivered)


def _rule_index(plan: ChaosPlan, rule: ChaosRule) -> int:
    """Identity (not equality) index: a plan may contain equal rules."""
    for i, r in enumerate(plan.rules):
        if r is rule:
            return i
    return -1


def _flight_dump_before_kill(site: str, method: str) -> None:
    """A chaos `kill` is os._exit — no atexit, no signal handler, no
    chance for the flight recorder to fire on its own. Dump the ring
    buffer explicitly so the simulated crash still leaves its black box
    for `ray-tpu debug postmortem`."""
    try:
        from ray_tpu_torch._private import event_log

        event_log.flight_dump(f"chaos_kill:{site}:{method}")
    except Exception:  # noqa: BLE001 — a dying process must still die
        pass


# The chaos control plane itself is exempt from injection: a plan that
# matched these methods (e.g. drop-everything on a raylet) would destroy
# the only remote off-switch — `ray-tpu chaos stop` could never uninstall.
_EXEMPT_METHODS = frozenset({"chaos_start", "chaos_stop", "chaos_status"})


async def intercept(site: str, method: str = "", label: str = "",
                    peer: str = "", local_id: str = "") -> Optional[str]:
    """Async injection point. Applies partition/delay/error/kill in
    place; returns the first terminal frame action for the caller to
    apply ("drop" | "duplicate" | "disconnect"), or None."""
    plan = PLAN
    if plan is None or method in _EXEMPT_METHODS:
        return None
    if site == SITE_CLIENT_REQUEST and plan.partitions and plan.is_partitioned(
            local_id or label, peer):
        plan.record(site, method, label, peer, "partition")
        _emit_event("chaos.partition", proc=label, site=site, method=method,
                    label=local_id or label, peer=peer)
        raise _connection_lost(
            f"chaos: partition between {local_id or label!r} and {peer!r}",
            maybe_delivered=False)
    terminal: Optional[str] = None
    for rule in plan.decide(site, method, label, peer):
        _emit_event("chaos.inject", proc=label, site=site, method=method,
                    label=label, peer=peer, action=rule.action,
                    rule=_rule_index(plan, rule))
        if rule.action == "delay":
            import asyncio

            await asyncio.sleep(rule.delay_s)
        elif rule.action == "error":
            raise _connection_lost(
                f"chaos: injected error on {method!r} at {site}",
                maybe_delivered=rule.maybe_delivered)
        elif rule.action == "kill":
            logger.warning("chaos: killing process at %s (%s)", site, method)
            _flight_dump_before_kill(site, method)
            os._exit(1)
        elif terminal is None:
            terminal = rule.action
    return terminal


def intercept_sync(site: str, method: str = "", label: str = "",
                   peer: str = "") -> Optional[str]:
    """Sync twin of `intercept` for non-async chokepoints (the executor's
    generator item reports — the `mid_stream` lifecycle point)."""
    plan = PLAN
    if plan is None or method in _EXEMPT_METHODS:
        return None
    terminal: Optional[str] = None
    for rule in plan.decide(site, method, label, peer):
        _emit_event("chaos.inject", proc=label, site=site, method=method,
                    label=label, peer=peer, action=rule.action,
                    rule=_rule_index(plan, rule))
        if rule.action == "delay":
            time.sleep(rule.delay_s)
        elif rule.action == "error":
            raise _connection_lost(
                f"chaos: injected error on {method!r} at {site}",
                maybe_delivered=rule.maybe_delivered)
        elif rule.action == "kill":
            logger.warning("chaos: killing process at %s (%s)", site, method)
            _flight_dump_before_kill(site, method)
            os._exit(1)
        elif terminal is None:
            terminal = rule.action
    return terminal


# Spawned processes (workers inherit the driver's env) arm themselves at
# import, so an env-installed plan covers every process in the cluster.
load_env_plan()
