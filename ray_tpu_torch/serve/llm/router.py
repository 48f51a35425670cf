"""Token-streaming LLM router.

The generic Serve router (serve/_private/router.py) balances by
request count, which is the wrong unit for LLM serving: a 4k-token
prompt with a 1k-token budget occupies an engine for orders of magnitude
longer than a chat ping. This router is the serving-aware ingress:

  * OUTSTANDING-TOKEN BALANCING — each assignment charges the replica
    with the request's expected token footprint (prompt + max_new);
    every streamed token pays one unit back. choose() picks the
    lighter of two random replicas by that score plus the
    controller-piggybacked ongoing/queue counts less this router's own
    requests in flight when the count was sampled (other routers' load).
  * SESSION AFFINITY — requests carrying a session_id stick to their
    replica (KV reuse locality for follow-up turns) while it stays
    healthy; affinity falls back to pow-2 when the replica goes away.
  * LOAD SHEDDING — when the aggregate outstanding-request depth
    crosses `shed_queue_depth`, new requests fail fast with
    LLMOverloadedError (HTTP 429) instead of joining a queue whose
    latency has already collapsed.
  * The replica set arrives by controller long-poll push, like the
    generic router — scale-downs reach this router in one RPC.

Streaming is end-to-end: the router calls the engine replica's
`generate_stream` as a streaming-generator task and re-yields tokens as
they are reported, so the proxy's chunked/SSE path ships each token the
moment it is sampled. Closing the client connection closes the router
generator, which closes the engine-side generator, which frees the
engine slot.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.rpc import ConnectionLost
from ray_tpu_torch.serve.llm import metrics as llm_metrics
from ray_tpu_torch.serve.llm.engine import (
    LLMOverloadedError,
    LLMReplicaUnavailableError,
)

# Transport/liveness failures that mean "the replica (or its node) is
# gone", as opposed to an application error raised by the engine itself.
# Only these trigger failover/typed-error handling; everything else
# propagates untouched.
_REPLICA_FAILURES = (
    ConnectionLost,
    exc.RayActorError,          # ActorDiedError / ActorUnavailableError
    exc.WorkerCrashedError,
    exc.RaySystemError,
    exc.OwnerDiedError,
    exc.NodeDiedError,
    exc.ObjectLostError,
)

# Pre-first-token retries against OTHER replicas before giving up.
_MAX_FAILOVERS = 2

# Shorter than the generic router's 30s long-poll: the piggybacked load
# metrics feed the SHED decision here, and listen_for_change only returns
# on a replica-set change or timeout — a 30s bound would keep rejecting
# with 429 long after a burst drained. 3s caps load staleness at roughly
# the controller's own 2s metric refresh.
_LONG_POLL_TIMEOUT_S = 3.0

# How long the router keeps its own assignments and releases: longer than
# a pushed count can be old (the controller's metric refresh plus one
# long-poll round).
_OWN_LOG_S = 60.0

logger = logging.getLogger(__name__)


class BadRequestError(Exception):
    status_code = 400


class LLMRouter:
    __serve_sse__ = True  # proxy streams __call__ as text/event-stream

    def __init__(self, engine, *, shed_queue_depth: int = 64,
                 session_ttl_s: float = 600.0,
                 default_max_new_tokens: int = 64):
        """`engine`: the engine deployment's handle (injected by
        serve.run graph composition). The router resolves replicas
        itself — per-replica placement is the whole point.
        `default_max_new_tokens` mirrors the engine default_config so
        requests without an explicit budget are charged their REAL
        expected footprint."""
        self._deployment = engine.deployment_name
        self._app = engine.app_name
        self._default_max_new = default_max_new_tokens
        self._key = (f"{self._app}#{self._deployment}"
                     if self._app else self._deployment)
        self._shed_queue_depth = shed_queue_depth
        self._session_ttl_s = session_ttl_s
        from ray_tpu_torch.serve import context as serve_ctx

        try:
            ctx = serve_ctx.get_replica_context()
            self._tags = {"deployment": ctx.deployment}
        except RuntimeError:
            self._tags = {"deployment": "llm_router"}
        self._controller = serve_ctx.get_controller()
        self._lock = threading.Lock()
        self._replicas: List[Tuple[str, Any]] = []
        self._base_load: Dict[str, int] = {}     # controller-piggybacked
        self._out_tokens: Dict[str, int] = {}    # this router's charges
        self._out_requests: Dict[str, int] = {}
        # (monotonic time, +1 assigned / -1 released) of this router's
        # requests, per replica, for the last _OWN_LOG_S
        self._own_log: Dict[str, Deque[Tuple[float, int]]] = {}
        self._assigned_total: Dict[str, int] = {}
        self._sessions: Dict[str, Tuple[str, float]] = {}
        self._shed_total = 0
        self._rng = random.Random()
        self._version = -1
        self._have_replicas = threading.Event()
        self._stopped = threading.Event()
        threading.Thread(target=self._long_poll_loop, daemon=True,
                         name=f"llm-router-poll-{self._key}").start()

    # -- replica set ---------------------------------------------------------

    def _long_poll_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                update = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._key, self._version,
                        timeout=_LONG_POLL_TIMEOUT_S),
                    timeout=_LONG_POLL_TIMEOUT_S + 10.0)
            except Exception:  # noqa: BLE001 — controller restarting
                if self._stopped.wait(0.5):
                    return
                continue
            self._version = update["version"]
            self._apply_update(update)

    def _apply_update(self, update: dict) -> None:
        with self._lock:
            self._replicas = list(update["replicas"])
            live = {rid for rid, _ in self._replicas}
            metrics = update.get("metrics") or {}
            ages = update.get("metrics_age_s") or {}
            now = time.monotonic()
            self._base_load = {
                rid: self._other_load(rid, metrics.get(rid, 0),
                                      ages.get(rid), now)
                for rid in live}
            self._out_tokens = {r: self._out_tokens.get(r, 0)
                                for r in live}
            self._out_requests = {r: self._out_requests.get(r, 0)
                                  for r in live}
            self._own_log = {r: log for r, log in self._own_log.items()
                             if r in live}
            self._sessions = {
                sid: (rid, exp)
                for sid, (rid, exp) in self._sessions.items()
                if rid in live}
            # Gate transitions under the SAME lock that _evict_replica
            # holds, and on the post-merge self._replicas: set outside
            # the lock raced the eviction of the last replica — the
            # stale update re-armed the event over an empty replica set,
            # and a FAILOVER waiter woke into an immediate typed 503
            # instead of waiting out the controller's replacement push.
            if self._replicas:
                self._have_replicas.set()
            else:
                self._have_replicas.clear()

    def _other_load(self, rid: str, pushed: int, age: Optional[float],
                    now: float) -> int:
        """Other routers' requests in flight at `rid`: the controller's
        count, sampled `age` seconds ago, less this router's own requests
        in flight at that moment. The count includes this router's own
        requests; charged again at 64 tokens each, a request that ended
        since the sample would keep steering streams off a replica that
        is idle (the lock is held)."""
        if age is None:
            return pushed
        since = now - age
        own_then = self._out_requests.get(rid, 0) - sum(
            d for t, d in self._own_log.get(rid, ()) if t > since)
        return max(0, pushed - own_then)

    def _log_own(self, rid: str, delta: int) -> None:
        """Note one of this router's assignments (+1) or releases (-1)
        on `rid` (the lock is held)."""
        now = time.monotonic()
        log = self._own_log.setdefault(rid, deque())
        log.append((now, delta))
        while log and log[0][0] < now - _OWN_LOG_S:
            log.popleft()

    def _score(self, rid: str) -> float:
        return self._out_tokens.get(rid, 0) + 64 * self._base_load.get(rid, 0)

    def _choose(self, session_id: Optional[str], cost: int,
                excluded: frozenset = frozenset()) -> Tuple[str, Any]:
        if not self._have_replicas.is_set():
            # On a FAILOVER retry (the caller just watched a replica die)
            # an empty replica set is replica death, not slow startup:
            # give the controller one short beat to push a replacement,
            # then surface the typed 503 — never the 30s cold-start wait
            # plus a generic RuntimeError the retry path would otherwise
            # hit when the LAST replica died pre-first-token.
            if excluded:
                if not self._have_replicas.wait(timeout=5.0):
                    raise LLMReplicaUnavailableError(
                        f"all replicas of {self._deployment!r} are gone "
                        f"({len(excluded)} failed this request); retry "
                        "once replacements come up")
            elif not self._have_replicas.wait(timeout=30.0):
                raise RuntimeError(
                    f"no engine replicas for {self._deployment!r} after 30s")
        now = time.monotonic()
        with self._lock:
            # Shed BEFORE assignment, on the router's OWN outstanding
            # count only: this router is the ingress, so its accounting
            # covers every request it routed, exactly and freshly. The
            # controller-piggybacked base_load is deliberately excluded —
            # it lags by the long-poll + metric-refresh cadence, and a
            # shed decision on seconds-stale "ongoing" data returns 429s
            # on an idle service right after a burst drains (base_load
            # still steers replica CHOICE below, where staleness only
            # costs balance, not availability). With multiple router
            # replicas the bound is per-router.
            agg = sum(self._out_requests.values())
            if agg >= self._shed_queue_depth:
                self._shed_total += 1
                llm_metrics.shed_counter().inc(tags=self._tags)
                ambient = _tracing.current_trace()
                if ambient is not None:
                    # a shed is a tail-keep trigger: the 429 the client
                    # sees must be traceable at any sample rate
                    _tracing.force_trace(ambient.trace_id,
                                         "llm_shed:router")
                raise LLMOverloadedError(
                    f"serving queue depth {agg} >= bound "
                    f"{self._shed_queue_depth}; retry later")
            replicas = [r for r in self._replicas if r[0] not in excluded]
            if not replicas:
                raise LLMReplicaUnavailableError(
                    f"all {len(self._replicas)} replica(s) of "
                    f"{self._deployment!r} failed this request")
            by_id = dict(replicas)
            choice = None
            if session_id is not None:
                hit = self._sessions.get(session_id)
                # expiry checked on LOOKUP (the bulk prune below is only
                # an amortized size bound); each use slides the TTL
                if hit is not None and hit[0] in by_id and hit[1] > now:
                    choice = (hit[0], by_id[hit[0]])
            if choice is None:
                if len(replicas) == 1:
                    choice = replicas[0]
                else:
                    a, b = self._rng.sample(replicas, 2)
                    choice = (a if self._score(a[0]) <= self._score(b[0])
                              else b)
            rid = choice[0]
            if session_id is not None:
                self._sessions[session_id] = (rid, now + self._session_ttl_s)
                if len(self._sessions) > 4096:  # TTL prune, amortized
                    self._sessions = {
                        s: v for s, v in self._sessions.items()
                        if v[1] > now}
            self._out_tokens[rid] = self._out_tokens.get(rid, 0) + cost
            self._out_requests[rid] = self._out_requests.get(rid, 0) + 1
            self._log_own(rid, +1)
            self._assigned_total[rid] = self._assigned_total.get(rid, 0) + 1
            return choice

    def _release(self, rid: str, remaining_tokens: int) -> None:
        with self._lock:
            if rid in self._out_tokens:
                self._out_tokens[rid] = max(
                    0, self._out_tokens[rid] - max(0, remaining_tokens))
            if self._out_requests.get(rid, 0) > 0:
                self._out_requests[rid] -= 1
                self._log_own(rid, -1)

    def _pay_token(self, rid: str) -> None:
        with self._lock:
            if rid in self._out_tokens and self._out_tokens[rid] > 0:
                self._out_tokens[rid] -= 1

    def _evict_replica(self, rid: str) -> None:
        """A stream to `rid` died: drop it from the local view NOW so new
        assignments (and session affinity) stop routing to it, instead of
        waiting a long-poll round for the controller to notice. If the
        failure was transient the next controller push re-adds it.

        The outstanding-token/request counters are deliberately KEPT:
        other streams to the same replica may still be in flight, and
        their _pay_token/_release on exit must settle against their own
        charges — popping here would let a survivor drain charges that
        belong to requests assigned after a re-add (under-counting the
        balance score and the 429 shed bound). A replica that never
        returns has its counters pruned by the long-poll update once the
        controller drops it from the live set."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r[0] != rid]
            self._base_load.pop(rid, None)
            self._sessions = {sid: (r, exp)
                              for sid, (r, exp) in self._sessions.items()
                              if r != rid}
            if not self._replicas:
                self._have_replicas.clear()

    # -- request path --------------------------------------------------------

    @staticmethod
    def _parse(request: Any) -> Dict[str, Any]:
        if isinstance(request, (bytes, bytearray)):
            try:
                request = json.loads(request)
            except ValueError:
                raise BadRequestError("body must be JSON") from None
        if isinstance(request, list):
            request = {"prompt": request}
        if not isinstance(request, dict):
            raise BadRequestError(
                "expected {'prompt': [token ids], 'max_new_tokens': int?, "
                "'session_id': str?}")
        prompt = request.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise BadRequestError(
                "'prompt' must be a non-empty list of token ids")
        max_new = request.get("max_new_tokens")
        if max_new is not None:
            max_new = int(max_new)
            if max_new <= 0:
                raise BadRequestError("'max_new_tokens' must be positive")
        sid = request.get("session_id")
        return {"prompt": prompt, "max_new_tokens": max_new,
                "session_id": str(sid) if sid is not None else None}

    def _token_stream(self, rq: Dict[str, Any], sse: bool = False):
        """Assign + stream: yields token ids (or, with sse=True,
        replica-PRE-ENCODED SSE byte frames forwarded verbatim — the
        zero-copy path); releases charges on exit.

        Replica-death failover: a stream whose replica dies BEFORE the
        first token retries transparently on a different replica (the
        client observes nothing); one that dies AFTER the first token
        raises the typed LLMReplicaUnavailableError (503) — replaying on
        another replica would re-emit tokens the client already has.
        Either way the dead replica's outstanding-token accounting is
        released and it is evicted from the local replica view."""
        cost = len(rq["prompt"]) + (rq["max_new_tokens"]
                                    or self._default_max_new)
        method = "generate_stream_sse" if sse else "generate_stream"
        failed: set = set()
        for failover in range(_MAX_FAILOVERS + 1):
            trace_ctx = _tracing.current_trace()
            t_pick = time.time() if trace_ctx is not None else 0.0
            rid, handle = self._choose(rq["session_id"], cost,
                                       excluded=frozenset(failed))
            if trace_ctx is not None:
                _tracing.record_span(
                    "router.pick", trace_ctx, t_pick, time.time(),
                    attrs={"deployment": self._deployment, "replica": rid,
                           "failover": failover, "cost": cost})
            produced = 0
            gen = None
            try:
                try:
                    # .remote() itself raises ActorDiedError when the
                    # owner already learned of the death — same failover
                    # treatment as a mid-stream transport failure
                    gen = handle.handle_request_streaming.options(
                        num_returns="streaming").remote(
                            method, (rq["prompt"],),
                            {"max_new_tokens": rq["max_new_tokens"]})
                    for ref in gen:
                        token = ray_tpu_torch.get(ref)
                        produced += 1
                        if produced <= cost:
                            # a request never pays back more than it was
                            # charged: the replica counter is shared, and
                            # over-paying would erase OTHER requests'
                            # outstanding charges
                            self._pay_token(rid)
                        yield token
                    return
                finally:
                    # Runs on success, failure, AND consumer abandonment
                    # (GeneratorExit): the outstanding charge is always
                    # released, dead replica or not.
                    if gen is not None:
                        try:
                            gen.close()  # no-op when exhausted; cancels
                        except Exception:  # noqa: BLE001 — teardown
                            pass
                    self._release(rid, cost - produced)
            except _REPLICA_FAILURES as e:
                failed.add(rid)
                self._evict_replica(rid)
                logger.warning(
                    "replica %s died serving a stream (%s tokens in, "
                    "attempt %d): %s", rid, produced, failover + 1, e)
                if produced > 0:
                    raise LLMReplicaUnavailableError(
                        f"engine replica {rid} became unavailable after "
                        f"{produced} streamed token(s); retry the request"
                    ) from e
                if failover >= _MAX_FAILOVERS:
                    raise LLMReplicaUnavailableError(
                        f"engine replica {rid} (and {failover} failover "
                        f"replica(s) before it) became unavailable before "
                        "the first token") from e
                # pre-first-token: silently fail over to another replica

    def stream_tokens(self, request: Any):
        """Raw token stream (handle callers / tests): yields ints."""
        yield from self._token_stream(self._parse(request))

    def __call__(self, request: Any = None):
        """HTTP ingress: streams Server-Sent Events, one per token, then
        a final usage event and `[DONE]` — each flushed through the
        proxy's chunked path as it is produced. Frames arrive from the
        engine replica PRE-ENCODED (generate_stream_sse) and pass through
        untouched — no per-token re-encoding on the router or proxy."""
        rq = self._parse(request)
        n = 0
        t0 = time.monotonic()
        for frame in self._token_stream(rq, sse=True):
            n += 1
            yield frame
        dt = time.monotonic() - t0
        usage = {"completion_tokens": n,
                 "prompt_tokens": len(rq["prompt"]),
                 "duration_s": round(dt, 4)}
        yield ("data: " + json.dumps({"usage": usage}) + "\n\n").encode()
        yield b"data: [DONE]\n\n"

    def generate(self, request: Any) -> Dict[str, Any]:
        """Unary path: full completion in one response."""
        rq = self._parse(request)
        tokens = list(self._token_stream(rq))
        return {"tokens": tokens, "n": len(tokens)}

    # -- control / observability ---------------------------------------------

    def get_router_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replicas": [rid for rid, _ in self._replicas],
                "assigned_total": dict(self._assigned_total),
                "outstanding_tokens": dict(self._out_tokens),
                "outstanding_requests": dict(self._out_requests),
                "base_load": dict(self._base_load),
                "sessions": len(self._sessions),
                "shed_total": self._shed_total,
                "shed_queue_depth": self._shed_queue_depth,
            }

    def llm_metrics_snapshot(self) -> List[Dict]:
        return llm_metrics.snapshot()

    def check_health(self) -> bool:
        return True

    def shutdown(self) -> None:
        self._stopped.set()
