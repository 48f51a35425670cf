"""HTTP ingress proxy (reference: ray python/ray/serve/_private/proxy.py:1130
ProxyActor; HTTPProxy :761 — uvicorn/starlette there, aiohttp here).

Sharded data plane: N proxy shard actors share ONE
listen port via SO_REUSEPORT — the kernel spreads connections across
shards, so ingress scales with processes instead of one aiohttp loop.
The controller owns shard lifecycle (spawn, health, restart, route
pushes); shards never coordinate with each other on the request path.

Request paths, hottest first:

  * UNARY FAST PATH — the handler assigns a replica without blocking
    (router.try_assign_request), then awaits the reply ref via a
    memory-store completion callback: no executor hop, no parked thread
    per request. Cold starts (no replicas yet) fall back to the
    blocking assign on an executor thread.
  * STREAMING — a per-connection _StreamPump: one feeder thread pulls
    replica chunks (pre-encoded SSE frames for serve.llm — no per-chunk
    re-encoding anywhere) into a byte-bounded queue; the aiohttp writer
    drains it, and `stream.write`'s own flow control propagates client
    backpressure. When the queue holds more than `stream_buffer_bytes`,
    the FEEDER suspends — the replica-side generator pull stops instead
    of buffering unboundedly. Client disconnect closes the replica-side
    generator from the feeder thread (every shard, not just shard 0).
  * serve.llm apps get a PER-SHARD embedded LLMRouter (built from the
    app's ingress_flags) running against the shared replica set: token
    streams skip the router-deployment hop entirely and no cross-shard
    lock sits on the request path (shed bounds and session affinity are
    per shard; SO_REUSEPORT keeps a keep-alive client on one shard).

Routes: longest-matching route_prefix → the app's ingress deployment
handle. GET/POST bodies are decoded as JSON when possible, else passed
as raw bytes; responses likewise JSON-encoded unless already bytes/str.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private import deadlines as _deadlines
from ray_tpu_torch._private import tracing as _tracing

logger = logging.getLogger(__name__)

# Per-connection cap on bytes queued between the replica-side feeder and
# the client socket. Past it the feeder stops pulling the generator
# (backpressure to the engine) instead of buffering; writes resume the
# pull at half the cap.
DEFAULT_STREAM_BUFFER_BYTES = 256 * 1024


def default_num_shards() -> int:
    return max(1, min(4, os.cpu_count() or 1))


SERVE_REQUESTS_NAME = "ray_tpu_serve_requests_total"
_requests_metric = None


def _requests_counter():
    """Lazy singleton: the per-shard request-outcome counter feeding the
    serve availability SLO (health/slo_rules.json
    serve_availability_burn). Proxy shards are worker processes, so the
    core-worker metric pusher ships it to the GCS health store."""
    global _requests_metric
    if _requests_metric is None:
        from ray_tpu_torch.util.metrics import get_or_create_counter

        _requests_metric = get_or_create_counter(
            SERVE_REQUESTS_NAME,
            "Proxied serve requests by outcome (ok = 2xx/3xx, shed = "
            "typed pushback 429/503/typed-504, error = everything "
            "else).", ("outcome",))
    return _requests_metric


def _close_generator(gen) -> None:
    """Best-effort cancel of a replica-side streaming generator after the
    HTTP client disconnects (nobody will consume further chunks)."""
    try:
        close = getattr(gen, "close", None)
        if close is not None:
            close()
    except Exception:  # noqa: BLE001 — teardown must not raise
        logger.debug("generator close failed", exc_info=True)


def _request_deadline(headers) -> Optional[float]:
    """Map the client's patience onto a task deadline:
    `X-Request-Deadline` carries an ABSOLUTE unix time,
    `X-Request-Timeout-S` a relative budget in seconds. Work submitted
    for the request inherits it (ambient submission deadline), so an
    abandoned request stops consuming lease slots and decode steps at
    the next queue-pop instead of running to completion into the void."""
    raw = headers.get("X-Request-Deadline")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    raw = headers.get("X-Request-Timeout-S")
    if raw:
        try:
            import time

            return time.time() + float(raw)
        except ValueError:
            pass
    return None


def _retry_after_of(e: BaseException) -> Optional[str]:
    for exc in (e, getattr(e, "cause", None)):
        after = getattr(exc, "retry_after_s", None)
        if isinstance(after, (int, float)):
            return f"{max(0.0, after):.3f}"
    return None


def _http_status_of(e: BaseException) -> int:
    """Replica exceptions can carry an HTTP status (e.g. serve.llm's
    LLMOverloadedError.status_code = 429 for load shedding). Task errors
    arrive wrapped (RayTaskError subclassing the cause, with .cause the
    original), so check both levels; anything unmarked is a 500."""
    for exc in (e, getattr(e, "cause", None)):
        status = getattr(exc, "status_code", None)
        if isinstance(status, int) and 400 <= status < 600:
            return status
    if isinstance(e, (asyncio.TimeoutError, TimeoutError)):
        return 504  # client budget ran out awaiting the reply
    return 500


def _encode_chunk(chunk) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return (json.dumps(chunk) + "\n").encode()


class _StreamPump:
    """Bounded bridge between a blocking replica-chunk iterator and the
    asyncio writer. The feeder THREAD owns the iterator end to end
    (creation can block on routing, pulls block on the engine, and
    close-on-disconnect must not run on the event loop); the queue and
    byte budget live on the loop thread, so neither side takes a lock on
    the chunk path."""

    def __init__(self, loop: asyncio.AbstractEventLoop, make_iter,
                 max_bytes: int):
        self._loop = loop
        self._make_iter = make_iter
        self._max = max_bytes
        self._low = max(1, max_bytes // 2)
        # byte-budgeted, not item-bounded: _enqueue suspends the feeder
        # past max_bytes (the real bound for variable-size SSE frames)
        self._q: "asyncio.Queue" = asyncio.Queue()  # raylint: disable=unbounded-queue
        self._queued_bytes = 0  # touched on the loop thread only
        self._space = threading.Event()  # feeder waits; loop thread sets
        self._space.set()
        self._cancelled = False
        self._thread = threading.Thread(
            target=self._feed, name="serve-stream-feeder", daemon=True)
        self._thread.start()

    # -- feeder thread -------------------------------------------------------

    def _feed(self) -> None:
        it = None
        try:
            it = self._make_iter()
            for chunk in it:
                data = _encode_chunk(chunk)
                self._space.wait()
                if self._cancelled:
                    break
                self._loop.call_soon_threadsafe(self._enqueue, "chunk", data)
            else:
                self._loop.call_soon_threadsafe(self._enqueue, "end", None)
        except BaseException as e:  # noqa: BLE001 — reported in-band
            if not self._cancelled:
                try:
                    self._loop.call_soon_threadsafe(self._enqueue, "err", e)
                except RuntimeError:  # loop closed mid-teardown
                    pass
        finally:
            if self._cancelled and it is not None:
                _close_generator(it)

    # -- loop thread ---------------------------------------------------------

    def _enqueue(self, kind: str, data) -> None:
        if kind == "chunk":
            self._queued_bytes += len(data)
            if self._queued_bytes >= self._max:
                self._space.clear()
        self._q.put_nowait((kind, data))

    async def get(self):
        """Next (kind, data); coalesces every already-queued chunk into
        one bytes object (fewer writer wakeups + socket writes, zero
        added latency — only data that is ALREADY waiting coalesces)."""
        kind, data = await self._q.get()
        if kind != "chunk":
            return kind, data
        parts = [data]
        while not self._q.empty():
            k2, d2 = self._q.get_nowait()
            if k2 != "chunk":
                # re-queue the terminal marker for the next get()
                self._q.put_nowait((k2, d2))
                break
            parts.append(d2)
        out = b"".join(parts)
        self._queued_bytes -= len(out)
        if self._queued_bytes <= self._low and not self._space.is_set():
            self._space.set()
        return "chunk", out

    def cancel(self) -> None:
        """Client went away: stop the feeder and close the replica-side
        generator (on the feeder thread, off the event loop)."""
        self._cancelled = True
        self._space.set()


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 shard_index: int = 0, num_shards: int = 1,
                 stream_buffer_bytes: int = DEFAULT_STREAM_BUFFER_BYTES):
        self._host = host
        self._port = port
        self._shard_index = shard_index
        self._num_shards = num_shards
        self._stream_buffer_bytes = stream_buffer_bytes
        self._routes: Dict[str, Any] = {}  # route_prefix -> route entry
        self._routes_incarnation = 0  # newest controller incarnation seen
        self._llm_routers: Dict[str, Any] = {}  # app name -> LLMRouter
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._bind_error: Optional[BaseException] = None
        self._requests_served = 0
        self._replica_death_retries = 0
        self._thread = threading.Thread(
            target=self._serve_forever,
            name=f"serve-proxy-{shard_index}", daemon=True)
        self._thread.start()
        self.update_routes()

    def ready(self) -> str:
        self._started.wait(10)
        if self._bind_error is not None:
            raise RuntimeError(
                f"proxy shard {self._shard_index} failed to bind "
                f"{self._host}:{self._port}: {self._bind_error}")
        if not self._started.is_set():
            raise RuntimeError(
                f"proxy shard {self._shard_index} failed to start")
        return f"http://{self._host}:{self._port}"

    def ping(self) -> bool:
        """Controller liveness probe: the serving thread must be up."""
        return self._thread.is_alive() and self._started.is_set()

    def get_stats(self) -> Dict[str, Any]:
        return {
            "shard_index": self._shard_index,
            "num_shards": self._num_shards,
            "requests_served": self._requests_served,
            "replica_death_retries": self._replica_death_retries,
            "routes_incarnation": self._routes_incarnation,
            "routes": sorted(self._routes),
            "llm_apps": sorted(self._llm_routers),
        }

    def llm_metrics_snapshot(self):
        """Embedded per-shard LLM routers observe into THIS process's
        registry (shed counters); collect_llm_metrics scrapes shards
        alongside replicas."""
        from ray_tpu_torch.serve.llm import metrics as llm_metrics

        return llm_metrics.snapshot()

    def update_routes(self, incarnation: Optional[int] = None) -> None:
        """Pull the route table from the controller. `incarnation` is the
        pushing controller's incarnation: pushes older than the newest
        one this shard has seen are dropped (a zombie controller racing
        its recovered successor must not roll the routes back). A failed
        pull — controller dead or mid-recovery — KEEPS the cached routes:
        the data plane serves through the control-plane outage."""
        from ray_tpu_torch.serve.context import get_controller
        from ray_tpu_torch.serve.handle import DeploymentHandle

        if incarnation is not None:
            if incarnation < self._routes_incarnation:
                return
            self._routes_incarnation = incarnation
        try:
            controller = get_controller()
        except RuntimeError:
            return
        try:
            apps = ray_tpu_torch.get(controller.list_applications.remote(),
                               timeout=30.0)
        except Exception:  # noqa: BLE001 — controller down mid-pull
            logger.warning(
                "route pull failed (controller down?); keeping %d cached "
                "route(s)", len(self._routes))
            return
        routes = {}
        live_llm = set()
        for app_name, info in apps.items():
            handle = DeploymentHandle(info["ingress"], app_name)
            flags = info.get("ingress_flags") or {}
            llm_router = None
            if flags.get("llm_engine"):
                llm_router = self._ensure_llm_router(app_name, flags)
                live_llm.add(app_name)
            # one long-lived stream-enabled handle per route, so streaming
            # requests share the router (and its replica/queue-len cache)
            # instead of rebuilding one per request
            routes[info["route_prefix"]] = (
                handle, handle.options(stream=True), flags, llm_router)
        self._routes = routes
        for app_name in list(self._llm_routers):
            if app_name not in live_llm:
                router = self._llm_routers.pop(app_name)
                try:
                    router.shutdown()
                except Exception:  # noqa: BLE001 — teardown
                    pass

    def _ensure_llm_router(self, app_name: str, flags: Dict[str, Any]):
        """Per-shard serve.llm ingress: an LLMRouter instance running in
        this shard against the shared engine-replica set (config rides
        the app's ingress_flags from build_llm_app)."""
        router = self._llm_routers.get(app_name)
        if router is not None:
            return router
        from ray_tpu_torch.serve.handle import DeploymentHandle
        from ray_tpu_torch.serve.llm.router import LLMRouter

        cfg = flags.get("llm_config") or {}
        try:
            router = LLMRouter(
                DeploymentHandle(flags["llm_engine"], app_name),
                shed_queue_depth=cfg.get("shed_queue_depth", 64),
                session_ttl_s=cfg.get("session_ttl_s", 600.0),
                default_max_new_tokens=cfg.get("default_max_new_tokens", 64))
        except Exception:  # noqa: BLE001 — fall back to the handle path
            logger.exception("embedded llm router init failed for %r",
                             app_name)
            return None
        self._llm_routers[app_name] = router
        return router

    def _match_route(self, path: str):
        best = None
        for prefix, entry in self._routes.items():
            if path == prefix or path.startswith(
                    prefix.rstrip("/") + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix,) + entry
        return best

    # -- async reply resolution ----------------------------------------------

    def _await_ref(self, ref, timeout_s: float):
        """Future resolving to the ref's value WITHOUT parking a thread:
        a memory-store completion callback settles it on the loop. Values
        living in plasma/remote locations are materialized on an executor
        thread (their get can block on I/O); inline replies — the unary
        serving case — deserialize right on the loop."""
        from ray_tpu_torch._raylet import get_core_worker

        loop = self._loop
        fut = loop.create_future()
        cw = get_core_worker()

        def _settle_inline():
            if fut.done():
                return
            try:
                # entry is present: timeout=0 cannot wait
                fut.set_result(ray_tpu_torch.get(ref, timeout=0))
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                fut.set_exception(e)

        def _settle_executor():
            if fut.done():
                return

            def _get():
                try:
                    value = ray_tpu_torch.get(ref, timeout=timeout_s)
                    loop.call_soon_threadsafe(
                        lambda: None if fut.done()
                        else fut.set_result(value))
                except BaseException as e:  # noqa: BLE001
                    loop.call_soon_threadsafe(
                        lambda: None if fut.done()
                        else fut.set_exception(e))

            loop.run_in_executor(None, _get)

        def _on_ready(entry) -> None:
            # inline entries (serialized payload or cached value) resolve
            # on the loop; plasma/remote-location entries go to a thread
            inline = (entry.serialized is not None or entry.freed
                      or entry.value is not entry.__class__.value)
            try:
                loop.call_soon_threadsafe(
                    _settle_inline if inline else _settle_executor)
            except RuntimeError:  # loop closed mid-teardown
                pass

        cw.memory_store.add_callback(ref.object_id(), _on_ready)
        return asyncio.wait_for(fut, timeout_s)

    # -- server --------------------------------------------------------------

    def _serve_forever(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def handler(request: "web.Request") -> "web.Response":
            """Trace envelope around every request: ingest the client's
            `traceparent` (or mint one), run the route, stamp X-Trace-Id
            + traceparent on EVERY response — typed 429/503/504 sheds
            included — record the proxy.request span, and tail-force the
            trace on any error status so a user-visible failure is
            always traceable."""
            t_req = time.time()
            req_ctx = _tracing.ingest_traceparent(
                request.headers.get("traceparent"))
            resp = await _route_request(request, req_ctx)
            status = getattr(resp, "status", 500)
            if not getattr(resp, "prepared", False):
                # streaming responses stamped their headers pre-prepare
                resp.headers["X-Trace-Id"] = req_ctx.trace_id
                resp.headers["traceparent"] = req_ctx.traceparent()
            _tracing.record_span(
                "proxy.request", req_ctx, t_req, time.time(),
                span_id=req_ctx.span_id,
                proc=f"proxy:{self._shard_index}",
                attrs={"path": request.path, "method": request.method,
                       "status": status})
            if status >= 400:
                _tracing.force_trace(req_ctx.trace_id,
                                     f"http_{status}")
            # health plane: the serve availability SLO's
            # denominator — every proxied request gets exactly one
            # outcome here. "shed" = typed pushback the client can back
            # off on (never accepted); "error" = accepted work that
            # failed, which is what burns the availability objective.
            if status < 400:
                outcome = "ok"
            elif status in (429, 503) or (
                    status == 504
                    and resp.headers.get("X-Typed-Shed")):
                outcome = "shed"
            else:
                outcome = "error"
            _requests_counter().inc(tags={"outcome": outcome})
            return resp

        async def _route_request(request: "web.Request",
                                 req_ctx) -> "web.Response":
            match = self._match_route(request.path)
            if match is None:
                return web.Response(status=404, text="no matching route")
            prefix, handle, stream_handle, flags, llm_router = match
            self._requests_served += 1
            body = await request.read()

            if flags.get("asgi"):
                # forward the raw request; the ASGI app (e.g. FastAPI)
                # runs inside the replica and returns status/headers/body
                sub_path = request.path[len(prefix.rstrip("/")):] or "/"
                raw = {
                    "method": request.method,
                    "path": sub_path,
                    "query_string": request.query_string.encode(),
                    "headers": [[k, v] for k, v in request.headers.items()],
                    "body": body,
                }
                try:
                    resp = await self._unary(handle, raw)
                except Exception as e:  # noqa: BLE001 — surface as 500
                    logger.exception("asgi request failed")
                    return web.Response(status=500, text=str(e))
                if isinstance(resp, dict) and resp.get("__serve_http__"):
                    from multidict import CIMultiDict

                    # multidict preserves repeated names (e.g. Set-Cookie)
                    hdrs = CIMultiDict(
                        (k, v) for k, v in resp.get("headers", [])
                        if k.lower() not in
                        ("content-length", "transfer-encoding"))
                    return web.Response(
                        status=resp["status"], body=resp["body"],
                        headers=hdrs)
                return web.json_response(resp)

            arg: Any
            if body:
                try:
                    arg = json.loads(body)
                except (ValueError, UnicodeDecodeError):
                    arg = body
            else:
                arg = dict(request.query) if request.query else None

            # client-declared patience: ambient submission deadline for
            # every task submitted on behalf of this request
            deadline = _request_deadline(request.headers)

            if flags.get("streaming"):
                if llm_router is not None:
                    # per-shard serve.llm ingress: route + stream in the
                    # feeder thread, frames arrive pre-encoded from the
                    # engine replica. LLMRouter.__call__ is a GENERATOR
                    # function — calling it submits nothing — so the
                    # ambient deadline must cover the ITERATION (where
                    # the lazy routing + task submission actually run),
                    # not just the call. The wrapping generator holds the
                    # scope on the feeder thread for the stream's life
                    # (the feeder is dedicated to this one stream).
                    def make_iter(r=llm_router, a=arg, d=deadline,
                                  c=req_ctx):
                        def _gen():
                            # trace scope mirrors the deadline scope: the
                            # feeder thread is dedicated to this stream,
                            # so holding both for the iteration is safe
                            # and stamps every spec the router submits
                            with _deadlines.ambient_deadline(d), \
                                    _tracing.trace_scope(c):
                                yield from r(a)
                        return _gen()
                else:
                    def make_iter(h=stream_handle, a=arg, d=deadline,
                                  c=req_ctx):
                        # h.remote submits EAGERLY: scoping the call is
                        # enough to stamp the spec
                        with _deadlines.ambient_deadline(d), \
                                _tracing.trace_scope(c):
                            return iter(h.remote(a))

                return await self._stream(request, flags, make_iter,
                                          req_ctx=req_ctx)

            timeout_s = 60.0
            if deadline is not None:
                import time as _time

                remaining = deadline - _time.time()
                if remaining <= 0:
                    # refused before any work was submitted: typed shed
                    return web.Response(
                        status=504, headers={"X-Typed-Shed": "deadline"},
                        text="request deadline already passed")
                # grace beat past the task deadline: the worker's TYPED
                # drop-at-pop reply (fired AT the deadline) must beat this
                # await's own TimeoutError, or a cleanly-refused request
                # would read as an untyped (accepted-then-lost) failure
                timeout_s = min(timeout_s, remaining + 1.0)
            try:
                response = await self._unary(handle, arg,
                                             timeout_s=timeout_s,
                                             deadline=deadline,
                                             trace=req_ctx)
            except Exception as e:  # noqa: BLE001 — surface as status
                status = _http_status_of(e)
                if status >= 500 and status != 504:
                    logger.exception("request failed")
                headers = {}
                retry_after = _retry_after_of(e)
                if retry_after is not None:
                    headers["Retry-After"] = retry_after
                from ray_tpu_torch.exceptions import DeadlineExceededError

                if isinstance(e, DeadlineExceededError) or isinstance(
                        getattr(e, "cause", None), DeadlineExceededError):
                    # dropped at a queue-pop BEFORE execution started —
                    # shed, not lost; clients (and the drill's accounting)
                    # tell the two apart by this header. A bare
                    # TimeoutError 504 (accepted work that stalled) gets
                    # no header and counts as lost-accepted.
                    headers["X-Typed-Shed"] = "deadline"
                return web.Response(status=status, headers=headers,
                                    text=str(getattr(e, "cause", None) or e))
            if isinstance(response, bytes):
                return web.Response(body=response)
            if isinstance(response, str):
                return web.Response(text=response)
            return web.json_response(response)

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handler)
        # no per-request INFO access log: each line would be formatted,
        # pushed through the GCS LOG channel, and printed on the driver
        # console — a measurable per-request tax and pure spam at serving
        # rates (operators get request metrics from /metrics instead)
        runner = web.AppRunner(app, access_log=None)
        loop.run_until_complete(runner.setup())
        # One listen port for every shard: SO_REUSEPORT makes the kernel
        # spread connections across shard processes. ALWAYS set it, even
        # for a lone shard — ensure_http_proxies may grow the count
        # later, and Linux only balances when every socket on the port
        # opted in (a reuse_port-less first bind would EADDRINUSE every
        # later shard forever). Platforms without SO_REUSEPORT fall back
        # to a plain bind when (and only when) one shard is configured.
        try:
            site = web.TCPSite(runner, self._host, self._port,
                               reuse_port=True)
            loop.run_until_complete(site.start())
        except BaseException as e:  # noqa: BLE001 — surfaced by ready()
            if self._num_shards > 1:
                self._bind_error = e
                self._started.set()
                return
            try:
                site = web.TCPSite(runner, self._host, self._port)
                loop.run_until_complete(site.start())
            except BaseException as e2:  # noqa: BLE001
                self._bind_error = e2
                self._started.set()
                return
        self._started.set()
        loop.run_forever()

    async def _unary(self, handle, arg, timeout_s: float = 60.0,
                     max_attempts: int = 3, deadline: Optional[float] = None,
                     trace=None):
        """Unary request: non-blocking replica assignment + async reply
        await. Falls back to the blocking assign on an executor thread
        only when no replica is known yet (cold start / scale-from-0).

        A request whose REPLICA died under it (actor death, node loss —
        not a user exception) is re-assigned, bounded: unary serve calls
        are idempotent by contract, so a replica kill mid-request must
        not surface as a lost accepted request while other replicas are
        healthy. The dead replica leaves the router set within one
        long-poll latency; until then a retry can land on it again, hence
        the short backoff between attempts."""
        from ray_tpu_torch.exceptions import RayActorError

        loop = self._loop
        last_err: Optional[BaseException] = None
        for attempt in range(max_attempts):
            if attempt:
                await asyncio.sleep(0.05 * (2 ** attempt))
            resp = None
            try:
                # a KNOWN-dead replica raises at submit time (the router
                # releases + evicts it); an in-flight death surfaces on
                # the reply ref — both re-assign. The ambient deadline
                # wraps SUBMISSION only: the spec is stamped there, and
                # downstream queue-pops enforce it from then on. The
                # trace scope covers the same window (both are
                # thread-scoped: wrapping only synchronous submission
                # keeps concurrent requests on this loop from leaking
                # scopes across awaits).
                with _deadlines.ambient_deadline(deadline), \
                        _tracing.trace_scope(trace):
                    resp = handle.try_remote(arg)
                if resp is None:
                    def _blocking_remote(h=handle, a=arg, d=deadline,
                                         c=trace):
                        with _deadlines.ambient_deadline(d), \
                                _tracing.trace_scope(c):
                            return h.remote(a)

                    resp = await loop.run_in_executor(None, _blocking_remote)
                return await self._await_ref(resp._ref, timeout_s)
            except RayActorError as e:
                last_err = e
                self._replica_death_retries += 1
                if resp is not None and resp._router is not None:
                    # reply-time death: evict so the retry's power-of-two
                    # choice stops seeing the corpse as least-loaded
                    resp._router.notify_replica_death(resp._ref)
                continue
            finally:
                if resp is not None:
                    resp._done()
        raise last_err

    async def _stream(self, request, flags: Dict[str, Any], make_iter,
                      req_ctx=None):
        from aiohttp import web

        loop = self._loop
        pump = _StreamPump(loop, make_iter, self._stream_buffer_bytes)
        # Pull the FIRST chunk before committing the status: a replica
        # that rejects up front (load shed → 429, bad request → 400,
        # raise before the first yield → 5xx) must produce a real HTTP
        # error, not a 200 that truncates. Only failures AFTER the first
        # chunk are signaled in-band.
        kind, first = await pump.get()
        if kind == "err":
            logger.warning("streaming request rejected: %s", first)
            headers = {}
            retry_after = _retry_after_of(first)
            if retry_after is not None:
                headers["Retry-After"] = retry_after
            return web.Response(
                status=_http_status_of(first), headers=headers,
                text=str(getattr(first, "cause", None) or first))
        stream = web.StreamResponse()
        if req_ctx is not None:
            # stamped BEFORE prepare(): committed headers are immutable
            stream.headers["X-Trace-Id"] = req_ctx.trace_id
            stream.headers["traceparent"] = req_ctx.traceparent()
        if flags.get("sse"):
            stream.content_type = "text/event-stream"
            stream.headers["Cache-Control"] = "no-cache"
            stream.headers["X-Accel-Buffering"] = "no"
        stream.enable_chunked_encoding()
        try:
            await stream.prepare(request)
        except Exception:  # noqa: BLE001 — client gone pre-commit
            pump.cancel()
            raise

        try:
            while kind == "chunk":
                # stream.write awaits the transport's drain when the
                # client reads slowly — that suspension stops our queue
                # drain, fills the byte budget, and suspends the feeder's
                # generator pull: end-to-end backpressure with a bounded
                # buffer at every hop
                await stream.write(first)
                kind, first = await pump.get()
            if kind == "err":
                # status is already committed; signal the error in-band
                # instead of masking it as a clean end-of-stream
                logger.warning("streaming request failed mid-stream: %s",
                               first)
                await stream.write(f"\n[stream error] {first}\n".encode())
        except Exception:  # noqa: BLE001 — client disconnected mid-stream
            # stop the feeder and cancel the replica-side generator
            # (pump.cancel closes it on the feeder thread, off the loop)
            pump.cancel()
            return stream
        try:
            await stream.write_eof()
        except Exception:  # noqa: BLE001 — client gone at EOF
            pump.cancel()
        return stream
