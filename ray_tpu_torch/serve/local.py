"""An in-process stand-in for the serving stack (`ServingStack`'s entry
points), for a process where the runtime does not run.

Each replica is a thread that runs one port `PagedInferenceEngine`'s
`serve_stream` loop: a request's stream is a generator over its tokens,
and closing it early cancels the request in the engine. The handle sends
each request to the replica with the fewest requests outstanding. The
replicas share one card, so their engine work takes turns under one lock
(`card_lock`), which a replica lets go while it waits for requests: a CUDA
graph capture in one replica must not overlap another's CUDA calls, which
the default (global) capture mode refuses. The replicas' engines are built
by the app's `build_engine`, which may share one copy of the weights.

The stand-in measures the engines and the streaming token path, not the
runtime's router, actor calls or processes.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, List, Optional

ENGINE_SUFFIX = "_engine"


class _Ref:
    """A finished call's result, read by `LocalServingStack.get`."""

    def __init__(self, value):
        self.value = value


class LocalReplica:
    """One engine replica on a thread of this process."""

    def __init__(self, engine, default_config: Optional[dict],
                 card_lock: threading.Lock):
        from ray_tpu_torch.inference import GenerationConfig

        self.engine = engine
        self.gen = GenerationConfig(**(default_config or {}))
        self._card = card_lock
        self._inbox: "queue.Queue" = queue.Queue()
        self._cancels: "queue.Queue" = queue.Queue()
        self._outs: Dict[int, "queue.Queue"] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.finished = 0
        self.streamed: List[int] = []  # tokens of each finished request
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="local-llm-replica")
        self._thread.start()

    # -- the engine's side -----------------------------------------------------

    def _feed(self, block: bool):
        new = []
        while True:
            try:
                new.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        if not new and block and not self._stop.is_set():
            self._card.release()  # idle: the other replicas take the card
            try:
                new.append(self._inbox.get(timeout=0.01))
            except queue.Empty:
                pass
            finally:
                self._card.acquire()
        cancelled = []
        while True:
            try:
                cancelled.append(self._cancels.get_nowait())
            except queue.Empty:
                break
        return new, cancelled, self._stop.is_set() and not new

    def _run(self) -> None:
        it = self.engine.serve_stream(self._feed, self.gen)
        try:
            while True:
                with self._card:
                    item = next(it, None)
                if item is None:
                    return
                rid, tok, done = item
                with self._lock:
                    out = self._outs.get(rid)
                if out is not None:
                    out.put((tok, done))
        except BaseException as e:  # noqa: BLE001 — ends every open stream
            self.error = e
            with self._lock:
                outs = list(self._outs.values())
            for out in outs:
                out.put((None, True))

    # -- the caller's side -----------------------------------------------------

    def outstanding(self) -> int:
        with self._lock:
            return len(self._outs)

    def stream(self, request: Dict[str, Any]):
        """A generator over one request's tokens: {"prompt": [...],
        "max_new_tokens": n (the app's default if absent)}."""
        if self.error is not None:
            raise RuntimeError("the replica's engine loop failed") \
                from self.error
        rid = next(self._ids)
        out: "queue.Queue" = queue.Queue()
        with self._lock:
            self._outs[rid] = out
        self._inbox.put((rid, list(request["prompt"]),
                         request.get("max_new_tokens")))
        return self._tokens(rid, out)

    def _tokens(self, rid: int, out: "queue.Queue"):
        finished = False
        n = 0
        try:
            while True:
                tok, done = out.get()
                if tok is None:
                    reason = self.engine.abort_reasons.get(rid, self.error)
                    raise RuntimeError(f"request {rid} aborted: {reason}")
                n += 1
                yield tok
                if done:
                    finished = True
                    with self._lock:
                        self.finished += 1
                        self.streamed.append(n)
                    return
        finally:
            with self._lock:
                self._outs.pop(rid, None)
            if not finished:
                self._cancels.put(rid)

    def handle_request(self, method: str, args=(), kwargs=None):
        return getattr(self, method)(*args, **(kwargs or {}))

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"outstanding_requests": len(self._outs),
                    "finished_requests": self.finished,
                    "continuous_batching": True,
                    "engine": self.engine.stats()}

    def shutdown(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("a replica's engine loop did not drain")


class _RemoteMethod:
    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs) -> _Ref:
        return _Ref(self._fn(*args, **kwargs))


class _ReplicaHandle:
    def __init__(self, replica: LocalReplica):
        self.handle_request = _RemoteMethod(replica.handle_request)


class _Stream:
    def __init__(self, replicas: List[LocalReplica]):
        self._replicas = replicas

    def remote(self, request: Dict[str, Any]):
        rep = min(self._replicas, key=lambda r: r.outstanding())
        return rep.stream(request)


class LocalHandle:
    """The app's ingress handle: `options(method_name="stream_tokens",
    stream=True).remote(request)` gives the request's token stream."""

    def __init__(self, replicas: List[LocalReplica]):
        self.replicas = replicas

    def options(self, method_name: str = "stream_tokens",
                stream: bool = True) -> _Stream:
        if method_name != "stream_tokens" or not stream:
            raise ValueError("the stand-in serves stream_tokens streams only")
        return _Stream(self.replicas)


class _Controller:
    def __init__(self, stack: "LocalServingStack"):
        self.get_replica_handles = _RemoteMethod(stack._replica_handles)


class LocalServingStack:
    """`ServingStack`'s entry points in one process (see the module)."""

    def __init__(self):
        self.card_lock = threading.Lock()
        self.apps: Dict[str, List[LocalReplica]] = {}
        self._engine_names: Dict[str, str] = {}
        # every replica built, kept after shutdown for inspection
        self.replicas: List[LocalReplica] = []

    def init(self) -> None:
        pass

    def build_llm_app(self, build_engine, *, name: str = "llm",
                      num_replicas: int = 2,
                      default_config: Optional[dict] = None,
                      shed_queue_depth: int = 64, **_options) -> dict:
        """The app's description; `run` builds its replicas. Queue bounds
        and other router options have no stand-in."""
        return {"build_engine": build_engine, "name": name,
                "num_replicas": num_replicas,
                "default_config": dict(default_config or {})}

    def run(self, app: dict, name: str = "default") -> LocalHandle:
        replicas = [LocalReplica(app["build_engine"](), app["default_config"],
                                 self.card_lock)
                    for _ in range(app["num_replicas"])]
        self.apps[name] = replicas
        self.replicas += replicas
        self._engine_names[name] = app["name"] + ENGINE_SUFFIX
        return LocalHandle(replicas)

    def shutdown(self) -> None:
        apps, self.apps = self.apps, {}
        for replicas in apps.values():
            for r in replicas:
                r.shutdown()

    def get_actor(self, name: str) -> _Controller:
        if name != "SERVE_CONTROLLER":
            raise ValueError(f"the stand-in has no actor {name!r}")
        return _Controller(self)

    def _replica_handles(self, app: str, deployment: str):
        if self._engine_names.get(app) != deployment:
            raise ValueError(f"no deployment {deployment!r} in app {app!r}")
        return [_ReplicaHandle(r) for r in self.apps[app]]

    @staticmethod
    def get(ref: _Ref, timeout: Optional[float] = None):
        return ref.value
