"""LLM engine replica: admission queue + continuous-batching loop.

One replica hosts one inference engine. Requests stream in from the
router as actor calls; a single batcher thread drains the admission
queue through the engine:

  * With a `PagedInferenceEngine` the batcher runs ONE long-lived
    `serve_stream` service loop — requests are admitted between decode
    chunks, so a request arriving mid-generation joins the running batch
    instead of waiting behind it (true continuous batching).
  * With the dense `InferenceEngine` (no dynamic admission) the batcher
    falls back to wave mode: it coalesces whatever is queued into one
    `generate_stream` run per wave — concurrency within a wave, queueing
    between waves.

Tokens flow back per-request through a hand-off queue; the replica's
`generate_stream` method is a plain generator, which the Serve layer
streams to callers as a streaming-generator task
(`num_returns="streaming"` — worker/core_worker.py:1123). Cancelling the
consumer's ObjectRefGenerator cancels the task, which lands in the
generator as an exception; the finally-block marks the request cancelled
and the engine frees its slot and KV blocks at the next feed poll.

TTFT (arrival -> first token) and TPOT (mean inter-token gap) are
observed here — at the point tokens leave the engine — into the tagged
histograms in serve/llm/metrics.py, alongside queue-depth and
batch-occupancy gauges the batcher refreshes every poll.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.serve.llm import metrics as llm_metrics

if TYPE_CHECKING:
    from ray_tpu_torch.inference import GenerationConfig

logger = logging.getLogger(__name__)

_DONE = object()


class LLMOverloadedError(Exception):
    """Request shed by admission control; HTTP ingress maps it to 429."""

    status_code = 429


class LLMReplicaUnavailableError(Exception):
    """The engine replica serving a stream died (or became unreachable)
    AFTER the first token was emitted, so the router cannot silently
    retry — replaying the prompt on another replica would re-emit tokens
    the client already consumed. HTTP ingress maps it to 503; clients
    retry idempotently at the request level. Pre-first-token failures
    never surface this: the router fails over to another replica."""

    status_code = 503


class _Abort:
    def __init__(self, reason: str):
        self.reason = reason


class _Request:
    __slots__ = ("req_id", "prompt", "max_new", "gen_override", "out",
                 "enqueued_at", "first_at", "last_at", "n_tokens",
                 "cancelled")

    def __init__(self, req_id: int, prompt: List[int], max_new: int,
                 gen_override: Optional[GenerationConfig] = None):
        self.req_id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.gen_override = gen_override
        # bounded by the request's own max_new token budget (one entry
        # per generated token, consumer-drained)
        self.out: "queue.SimpleQueue" = queue.SimpleQueue()  # raylint: disable=unbounded-queue
        self.enqueued_at = time.monotonic()
        self.first_at: Optional[float] = None
        self.last_at: Optional[float] = None
        self.n_tokens = 0
        self.cancelled = False


def _flash_launches() -> Dict[str, int]:
    """The launches of the flash kernels in this process so far."""
    from ray_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches}


class LLMEngineReplica:
    """Deployment callable wrapping an inference engine for serving."""

    def __init__(self, build_engine, default_config: Optional[dict] = None,
                 max_queue_depth: int = 64):
        """build_engine() -> PagedInferenceEngine | InferenceEngine
        (constructed in the replica so params land on its device).
        `max_queue_depth` bounds requests waiting for engine admission;
        beyond it submissions fail with LLMOverloadedError (the router
        sheds earlier — this is the per-replica backstop)."""
        # torch loads here, in the replica, not in the router's process
        from ray_tpu_torch.inference import GenerationConfig

        # process_report counts the flash launches from here
        self._flash_at_start = _flash_launches()
        self.engine = build_engine()
        self.default = GenerationConfig(**(default_config or {}))
        self._continuous = hasattr(self.engine, "serve_stream")
        self._max_queue_depth = max_queue_depth
        # bounded by max_queue_depth at submit (LLMOverloadedError 429
        # past it) — the 429-shed half of the overload-protection story
        self._queue: "queue.Queue[_Request]" = queue.Queue()  # raylint: disable=unbounded-queue
        self._requests: Dict[int, _Request] = {}
        self._lock = threading.Lock()
        self._cancels: set = set()
        self._next_id = itertools.count()
        self._seen_preemptions = 0
        self._seen_prefix: Dict[str, int] = {}
        self._n_finished = 0
        self._shutdown = threading.Event()
        # metric tag values (stable for this replica's lifetime)
        from ray_tpu_torch.serve import context as serve_ctx

        try:
            ctx = serve_ctx.get_replica_context()
            self._tags = {"deployment": ctx.deployment,
                          "replica": ctx.replica_tag}
        except RuntimeError:  # constructed outside serve (tests, bench)
            self._tags = {"deployment": "llm", "replica": "local"}
        self._thread = threading.Thread(
            target=self._run, name="llm-batcher", daemon=True)
        self._thread.start()

    # -- request path --------------------------------------------------------

    def _backlog(self) -> int:
        """Requests waiting for an engine slot. NOT _queue.qsize(): the
        batcher drains the hand-off queue into the engine's internal
        pending list every poll, so qsize() reads ~0 under any load.
        Submitted-minus-decoding is the real admission backlog."""
        eng = self.engine
        decoding = eng.max_batch - len(eng.free_slots)
        with self._lock:
            return max(0, len(self._requests) - decoding)

    def _submit(self, prompt: List[int], max_new_tokens: Optional[int],
                gen_override: Optional[GenerationConfig]) -> _Request:
        if self._shutdown.is_set():
            raise RuntimeError("replica is shutting down")
        if self._backlog() >= self._max_queue_depth:
            llm_metrics.requests_counter().inc(
                tags={**self._tags, "outcome": "shed"})
            ambient = _tracing.current_trace()
            if ambient is not None:
                _tracing.force_trace(ambient.trace_id, "llm_shed:engine")
            raise LLMOverloadedError(
                f"engine admission backlog full "
                f"({self._max_queue_depth} requests waiting)")
        rq = _Request(next(self._next_id), list(prompt),
                      max_new_tokens if max_new_tokens is not None
                      else self.default.max_new_tokens, gen_override)
        with self._lock:
            self._requests[rq.req_id] = rq
        self._queue.put(rq)
        return rq

    def _cancel(self, rq: _Request) -> None:
        rq.cancelled = True
        with self._lock:
            if self._requests.pop(rq.req_id, None) is not None:
                if self._continuous:
                    # only the serve_stream feed consumes cancel ids; the
                    # wave path checks rq.cancelled directly (adding here
                    # would grow the set forever)
                    self._cancels.add(rq.req_id)
                llm_metrics.requests_counter().inc(
                    tags={**self._tags, "outcome": "cancelled"})

    def generate_stream(self, prompt: List[int],
                        max_new_tokens: Optional[int] = None):
        """Yields token ids as the engine samples them. Closing the
        consumer side (client disconnect, ObjectRefGenerator.close())
        cancels the request and frees its engine slot."""
        trace_ctx = _tracing.current_trace()
        t_submit = time.monotonic()
        t_prev_wall = time.time()
        first_token = trace_ctx is not None
        span_cap = (CONFIG.trace_max_stream_spans
                    if trace_ctx is not None else 0)
        rq = self._submit(prompt, max_new_tokens, None)
        finished = False
        produced = 0
        try:
            while True:
                try:
                    item = rq.out.get(timeout=2.0)
                except queue.Empty:
                    if self._shutdown.is_set() or not self._thread.is_alive():
                        raise RuntimeError(
                            "engine batcher stopped mid-request")
                    continue
                if item is _DONE:
                    finished = True
                    return
                if isinstance(item, _Abort):
                    finished = True
                    raise RuntimeError(f"request aborted: {item.reason}")
                if isinstance(item, BaseException):
                    finished = True
                    raise item
                if first_token:
                    # admission span of a traced request: submit ->
                    # first sampled token (queue wait + prefill — the
                    # TTFT the engine is responsible for)
                    first_token = False
                    now = time.time()
                    _tracing.record_span(
                        "engine.admission", trace_ctx,
                        now - (time.monotonic() - t_submit), now,
                        attrs={"req_id": rq.req_id,
                               "prompt_tokens": len(prompt)})
                    t_prev_wall = now
                elif produced < span_cap:
                    now = time.time()
                    _tracing.record_span(
                        "engine.decode_chunk", trace_ctx, t_prev_wall, now,
                        attrs={"req_id": rq.req_id, "index": produced})
                    t_prev_wall = now
                produced += 1
                yield item
        finally:
            if not finished:
                self._cancel(rq)

    def generate_stream_sse(self, prompt: List[int],
                            max_new_tokens: Optional[int] = None):
        """generate_stream with each token PRE-ENCODED as a complete SSE
        frame at the source (zero-copy streaming): the router
        and the HTTP proxy forward these bytes untouched, so a token is
        serialized exactly once on its way to the client."""
        for tok in self.generate_stream(prompt, max_new_tokens):
            yield b'data: {"token": %d}\n\n' % tok

    def generate(self, prompt: List[int],
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 eos_token_id: Optional[int] = None) -> List[int]:
        """Unary path (and the llm_deployment compatibility surface).
        Sampling overrides ride only on the dense-engine wave path; the
        continuous loop compiles one sampling config per replica."""
        override = None
        if temperature is not None or eos_token_id is not None:
            override = dataclasses.replace(
                self.default,
                temperature=(self.default.temperature if temperature is None
                             else temperature),
                eos_token_id=(self.default.eos_token_id if eos_token_id
                              is None else eos_token_id))
            if self._continuous:
                raise ValueError(
                    "per-request sampling overrides are not supported by "
                    "the continuous-batching engine (sampling params are "
                    "compile-time constants); configure them per replica "
                    "via default_config")
        rq = self._submit(prompt, max_new_tokens, override)
        out: List[int] = []
        while True:
            try:
                item = rq.out.get(timeout=2.0)
            except queue.Empty:
                # first requests can sit behind a cold replica's warm-up;
                # keep waiting as long as the batcher is alive
                if self._shutdown.is_set() or not self._thread.is_alive():
                    self._cancel(rq)
                    raise RuntimeError(
                        "engine batcher stopped mid-request") from None
                continue
            if item is _DONE:
                return out
            if isinstance(item, _Abort):
                raise RuntimeError(f"request aborted: {item.reason}")
            if isinstance(item, BaseException):
                raise item
            out.append(item)

    # -- control / observability ---------------------------------------------

    def get_stats(self) -> Dict[str, Any]:
        stats = {
            "queue_depth": self._backlog(),
            "outstanding_requests": len(self._requests),
            "finished_requests": self._n_finished,
            "continuous_batching": self._continuous,
            "max_queue_depth": self._max_queue_depth,
        }
        eng_stats = getattr(self.engine, "stats", None)
        if callable(eng_stats):
            stats["engine"] = eng_stats()
        else:
            stats["engine"] = {
                "max_batch": self.engine.max_batch,
                "active_slots": (self.engine.max_batch
                                 - len(self.engine.free_slots)),
            }
        return stats

    def get_autoscaling_metrics(self) -> Dict[str, float]:
        """Engine-reported backlog for the controller's autoscaler (see
        controller._autoscale): requests waiting for admission, which
        ongoing-request counts alone cannot see."""
        return {"queue_depth": self._backlog()}

    def llm_metrics_snapshot(self) -> List[Dict]:
        return llm_metrics.snapshot()

    def process_report(self, recent: int = 1 << 20) -> Dict[str, Any]:
        """This replica's process, as a check from outside reads it: its
        pid and cards (None outside the runtime); its engine's KV block report; every live engine's
        report of the process (`kv_registry.report_all`, which refreshes
        the ray_tpu_kv_blocks gauge) and the process's ray_tpu_* metrics
        after it; each device profiler's last `recent` steps, and the
        perf.phase_report events of the process, the engine's profiler
        emitting one now; the card's peak memory (None off the card); the
        flash kernels' launches in the process since this replica was
        constructed."""
        import os

        import torch

        import ray_tpu_torch
        from ray_tpu_torch._private import device_profiler, kv_registry
        from ray_tpu_torch.util import metrics as um

        kv = kv_registry.report_all()
        profilers = device_profiler.snapshot_all(recent)["profilers"]
        eng = self.engine
        if getattr(eng, "profiler", None) is not None:
            eng.profiler.report(recent=0)
        device = getattr(eng, "device", None)
        on_card = device is not None and torch.device(device).type == "cuda"
        return {
            "pid": os.getpid(),
            "gpu_ids": (ray_tpu_torch.get_runtime_context()
                        .get_accelerator_ids().get("GPU", [])
                        if ray_tpu_torch.is_initialized() else None),
            "engine_kv": (eng.kv_block_report()
                          if hasattr(eng, "kv_block_report") else None),
            "kv_reports": kv,
            "metrics": um.snapshot_metrics("ray_tpu_"),
            "profilers": profilers,
            "phase_reports": [e["data"] for e in um.events(
                "perf.phase_report")],
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if on_card else None),
            "flash_launches": {k: v - self._flash_at_start[k]
                               for k, v in _flash_launches().items()},
        }

    def check_health(self) -> bool:
        if not self._thread.is_alive() and not self._shutdown.is_set():
            raise RuntimeError("llm batcher thread died")
        return True

    def shutdown(self) -> None:
        self._shutdown.set()

    # -- batcher -------------------------------------------------------------

    def _run(self) -> None:
        run = (self._run_continuous if self._continuous
               else self._run_waves)
        while not self._shutdown.is_set():
            try:
                run()
            except Exception as e:  # noqa: BLE001 — fail waiters, recover
                logger.exception("llm batcher loop failed; restarting")
                self._fail_outstanding(e)

    def _fail_outstanding(self, e: BaseException) -> None:
        with self._lock:
            requests, self._requests = self._requests, {}
        for rq in requests.values():
            rq.out.put(e)
        while True:
            try:
                rq = self._queue.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                # a _submit racing the swap above lands its entry in the
                # NEW dict; failing its queue entry without removing it
                # would pin phantom backlog (and 429s) forever
                self._requests.pop(rq.req_id, None)
            rq.out.put(e)

    def _update_gauges(self) -> None:
        llm_metrics.queue_depth_gauge().set(
            self._backlog(), tags=self._tags)
        eng = self.engine
        llm_metrics.occupancy_gauge().set(
            (eng.max_batch - len(eng.free_slots)) / max(1, eng.max_batch),
            tags=self._tags)
        preempt = getattr(eng, "preemptions", 0)
        if preempt > self._seen_preemptions:
            llm_metrics.preemptions_counter().inc(
                preempt - self._seen_preemptions, tags=self._tags)
            self._seen_preemptions = preempt
        prefix = getattr(eng, "prefix_stats", None)
        if prefix:
            # engine counters are cumulative; export only the delta
            for name, (_d, key) in \
                    llm_metrics.PREFIX_CACHE_COUNTERS.items():
                cur = prefix.get(key, 0)
                seen = self._seen_prefix.get(key, 0)
                if cur > seen:
                    llm_metrics.prefix_cache_counter(name).inc(
                        cur - seen, tags=self._tags)
                    self._seen_prefix[key] = cur

    def _feed(self, block: bool):
        new: List[_Request] = []
        try:
            if block:
                new.append(self._queue.get(timeout=0.2))
            while True:
                new.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        with self._lock:
            cancelled, self._cancels = self._cancels, set()
        self._update_gauges()
        return ([(rq.req_id, rq.prompt, rq.max_new)
                 for rq in new if not rq.cancelled],
                cancelled, self._shutdown.is_set())

    def _deliver(self, req_id: int, token: Optional[int],
                 done: bool) -> None:
        with self._lock:
            rq = self._requests.get(req_id)
        if token is None:  # engine aborted the request
            # pop the reason even when the consumer is already gone, or
            # abort-vs-cancel races grow engine.abort_reasons forever
            reason = "aborted"
            reasons = getattr(self.engine, "abort_reasons", None)
            if reasons is not None:
                reason = reasons.pop(req_id, reason)
            if rq is None or rq.cancelled:
                return
            rq.out.put(_Abort(reason))
            llm_metrics.requests_counter().inc(
                tags={**self._tags, "outcome": "error"})
            with self._lock:
                self._requests.pop(req_id, None)
            return
        if rq is None or rq.cancelled:
            return
        now = time.monotonic()
        if rq.first_at is None:
            rq.first_at = now
            llm_metrics.ttft_histogram().observe(
                now - rq.enqueued_at, tags=self._tags)
        rq.n_tokens += 1
        rq.last_at = now
        llm_metrics.tokens_counter().inc(tags=self._tags)
        rq.out.put(token)
        if done:
            if rq.n_tokens >= 2:
                llm_metrics.tpot_histogram().observe(
                    (rq.last_at - rq.first_at) / (rq.n_tokens - 1),
                    tags=self._tags)
            llm_metrics.requests_counter().inc(
                tags={**self._tags, "outcome": "ok"})
            rq.out.put(_DONE)
            with self._lock:
                self._requests.pop(req_id, None)
                self._n_finished += 1

    def _run_continuous(self) -> None:
        """One serve_stream service loop for the replica's lifetime."""
        for req_id, token, done in self.engine.serve_stream(
                self._feed, self.default):
            self._deliver(req_id, token, done)

    def _run_waves(self) -> None:
        """Dense-engine fallback: coalesce queued requests into
        generate_stream waves (concurrency within a wave)."""
        try:
            first = self._queue.get(timeout=0.2)
        except queue.Empty:
            return
        wave = [first]
        while len(wave) < self.engine.max_batch * 4:
            try:
                wave.append(self._queue.get_nowait())
            except queue.Empty:
                break
        self._update_gauges()
        # group by generation config: the engine streams one config per run
        groups: Dict[Any, List[_Request]] = {}
        for rq in wave:
            if rq.cancelled:
                continue
            gen = dataclasses.replace(rq.gen_override or self.default,
                                      max_new_tokens=rq.max_new)
            groups.setdefault(gen, []).append(rq)
        for gen, items in groups.items():
            try:
                for idx, token in self.engine.generate_stream(
                        [rq.prompt for rq in items], gen):
                    self._deliver(items[idx].req_id, token, done=False)
            except Exception as e:  # noqa: BLE001 — report to this wave
                for rq in items:
                    rq.out.put(e)
                    with self._lock:
                        self._requests.pop(rq.req_id, None)
                continue
            # stream exhausted: everything this wave produced is out
            for rq in items:
                with self._lock:
                    alive = self._requests.pop(rq.req_id, None)
                if alive is not None and not rq.cancelled:
                    if rq.n_tokens >= 2:
                        llm_metrics.tpot_histogram().observe(
                            (rq.last_at - rq.first_at) / (rq.n_tokens - 1),
                            tags=self._tags)
                    llm_metrics.requests_counter().inc(
                        tags={**self._tags, "outcome": "ok"})
                    rq.out.put(_DONE)
                    self._n_finished += 1
