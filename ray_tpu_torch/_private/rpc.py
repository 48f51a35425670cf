"""L1: RPC + pubsub transport.

Plays the role of the reference's gRPC wrappers (ray: src/ray/rpc/grpc_server.cc,
client_call.h) and long-poll pubsub (src/ray/pubsub/): every control-plane
boundary (GCS services, raylet lease protocol, worker task push, object
service) is a method on an `RpcServer`, and clients hold persistent
connections with request-id correlation. Transport is asyncio TCP with
length-prefixed pickle-5 frames whose large buffers travel OUT-OF-BAND as
raw scatter segments (see _frame_segments); good for localhost and DCN.
Data-plane payloads ride the same connections copy-free: a reply carrying a
SerializedObject writes its buffers from the shm arena straight to the
socket, and the receiver decodes arrays as views into one receive blob.

Also provides `EventLoopThread` — the per-component io_context equivalent of
the reference's instrumented asio loops (src/ray/common/asio/).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import socket
import threading
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import fault_injection as _fi

logger = logging.getLogger(__name__)

_REQUEST = 0
_REPLY_OK = 1
_REPLY_ERR = 2
_ONEWAY = 3

_handler_hist = None
_handler_hist_failed = False


def _rpc_handler_hist():
    """Per-method server handler latency histogram, created lazily so the
    transport keeps zero hard deps on the metrics layer (and processes
    that only run clients never register it)."""
    global _handler_hist, _handler_hist_failed
    if _handler_hist is None and not _handler_hist_failed:
        try:
            from ray_tpu_torch.util.metrics import get_or_create_histogram

            _handler_hist = get_or_create_histogram(
                "ray_tpu_rpc_handler_seconds",
                "Server-side RPC handler latency by method",
                tag_keys=("method",),
            )
        except Exception:  # noqa: BLE001 — never break the transport
            _handler_hist_failed = True
    return _handler_hist


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    """Peer unreachable. `maybe_delivered` distinguishes a request that
    MAY have reached the peer (connection died awaiting the reply — the
    peer might be executing it) from one that certainly did not (connect
    or frame-write failed): callers can retry the latter without
    consuming at-most-once retry budgets."""

    def __init__(self, msg: str, maybe_delivered: bool = True):
        super().__init__(msg)
        self.maybe_delivered = maybe_delivered


def _addr_str(addr: Tuple[str, int]) -> str:
    return f"{addr[0]}:{addr[1]}"


def parse_addr(addr: str) -> Tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread (asio io_context analogue)."""

    def __init__(self, name: str = "rt-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()

    def _run(self):
        import os
        prof_dir = os.environ.get("RT_LOOP_PROFILE_DIR")
        pr = None
        if prof_dir:
            # env-gated loop profiling (ray-tpu profile's in-process
            # cousin): dump per-loop cProfile stats at loop stop
            import cProfile

            pr = cProfile.Profile()
            pr.enable()
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()
        if pr is not None:
            pr.disable()
            name = self._thread.name.replace("/", "_")
            pr.dump_stats(os.path.join(
                prof_dir, f"loop-{name}-{os.getpid()}.prof"))

    def run_coro(self, coro: Awaitable, timeout: Optional[float] = None):
        """Run a coroutine on the loop from another thread; block for result."""
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self.loop:
            # Blocking on our own loop can never complete — the loop is
            # this very thread. Fail loudly instead of deadlocking the
            # whole transport (the serve long-poll starvation bug).
            coro.close()
            raise RuntimeError(
                "blocking run_coro() called from its own event-loop "
                "thread; use submit()/await instead")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def submit(self, coro: Awaitable):
        """Fire-and-forget a coroutine onto the loop."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        def _shutdown():
            tasks = [t for t in asyncio.all_tasks(self.loop)
                     if t is not asyncio.current_task(self.loop)]
            for task in tasks:
                task.cancel()

            async def _drain():
                await asyncio.gather(*tasks, return_exceptions=True)
                self.loop.stop()

            asyncio.ensure_future(_drain())

        if self.loop.is_running():
            self.loop.call_soon_threadsafe(_shutdown)
        self._thread.join(timeout=2.0)


# Out-of-band wire format (the copy-free wire path). Frame layout:
#   [4B inband len][4B buffer count][8B len per buffer][inband][buffers…]
# pickle-5 buffer_callback diverts large PickleBuffers (SerializedObject
# payloads, numpy arrays) out of the pickle stream; the writer scatters the
# raw memoryviews straight to the socket (no bytes() materialization, no
# re-pickle of array data) and the reader hands the decoder zero-copy
# views into ONE contiguous receive blob. Buffers below _OOB_MIN_BYTES stay
# in-band: per-buffer framing + scatter writes cost more than a tiny copy.
_OOB_MIN_BYTES = 4096


def _frame_segments(msg: Any) -> list:
    """Encode a message as an ordered segment list (scatter list): one
    header+inband bytes object followed by the raw out-of-band buffers."""
    bufs: list = []

    def _divert(b: pickle.PickleBuffer):
        try:
            raw = b.raw()
        except Exception:  # noqa: BLE001 — non-contiguous: keep in-band
            return True
        if raw.nbytes < _OOB_MIN_BYTES:
            return True  # in-band
        bufs.append(raw)
        return False  # out-of-band
    payload = pickle.dumps(msg, protocol=5, buffer_callback=_divert)
    head = bytearray()
    head += len(payload).to_bytes(4, "little")
    head += len(bufs).to_bytes(4, "little")
    for m in bufs:
        head += m.nbytes.to_bytes(8, "little")
    head += payload
    return [bytes(head), *bufs]


def _write_segments(writer: asyncio.StreamWriter, segments: list) -> None:
    # NOT writelines(): CPython's StreamWriter.writelines b"".join()s the
    # segments — the exact copy this format exists to avoid.
    for seg in segments:
        writer.write(seg)


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(8)
    length = int.from_bytes(header[:4], "little")
    n_bufs = int.from_bytes(header[4:8], "little")
    sizes = []
    if n_bufs:
        raw = await reader.readexactly(8 * n_bufs)
        sizes = [int.from_bytes(raw[i * 8:(i + 1) * 8], "little")
                 for i in range(n_bufs)]
    payload = await reader.readexactly(length)
    if not n_bufs:
        return pickle.loads(payload)
    blob = memoryview(await reader.readexactly(sum(sizes)))
    views, off = [], 0
    for n in sizes:
        views.append(blob[off:off + n])
        off += n
    # decoded values (numpy arrays, SerializedObject buffers) alias `blob`
    # — zero-copy receive; the blob lives as long as any of them does
    return pickle.loads(payload, buffers=views)


def _frame(msg: Any) -> bytes:
    """Flat single-buffer form of _frame_segments (tests/diagnostics)."""
    return b"".join(bytes(s) for s in _frame_segments(msg))


class RpcServer:
    """Asyncio TCP server dispatching named methods.

    Handlers are async callables `(payload) -> reply` registered by name.
    Runs on a caller-provided event loop (so one component = one loop thread
    serving many roles, like the reference's asio services).
    """

    def __init__(self, loop_thread: EventLoopThread, host: str = "127.0.0.1",
                 label: str = ""):
        self._lt = loop_thread
        self._host = host
        # chaos addressing: which component this endpoint serves
        # ("gcs" / "raylet" / "driver" / "worker"); see fault_injection.py
        self.label = label
        self._handlers: Dict[str, Callable[[Any], Awaitable[Any]]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.address: Optional[str] = None
        self._conn_lost_cb: Optional[Callable] = None
        self._conn_writers: set = set()

    def register(self, method: str, handler: Callable[[Any], Awaitable[Any]]):
        self._handlers[method] = handler

    def register_all(self, obj, prefix: str = ""):
        """Register every `handle_*` coroutine method of obj."""
        for name in dir(obj):
            if name.startswith("handle_"):
                self.register(prefix + name[len("handle_"):], getattr(obj, name))

    def on_connection_lost(self, cb: Callable[[Any], None]):
        """cb(peer_meta) invoked when a registered peer's connection drops."""
        self._conn_lost_cb = cb

    def start(self, port: int = 0) -> str:
        async def _start():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, port
            )
            sock = self._server.sockets[0]
            return sock.getsockname()[:2]

        host, bound_port = self._lt.run_coro(_start())
        self.address = f"{self._host}:{bound_port}"
        return self.address

    def stop(self):
        async def _stop():
            if self._server is not None:
                self._server.close()
            # Close ESTABLISHED connections too — BEFORE wait_closed():
            # Server.close() only stops the listener, and since 3.12
            # wait_closed() blocks until every connection handler exits,
            # so it must come after the writers are closed. Without this,
            # clients keep writing into zombie connections forever (a
            # restarted server at the same address never hears from them).
            for w in list(self._conn_writers):
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass
            await asyncio.sleep(0.05)  # let the transports flush FINs
            if self._server is not None:
                try:
                    await asyncio.wait_for(self._server.wait_closed(), 1.0)
                except asyncio.TimeoutError:
                    pass

        try:
            self._lt.run_coro(_stop(), timeout=2.0)
        except Exception:
            pass

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer_meta: Dict[str, Any] = {}
        write_lock = asyncio.Lock()
        self._conn_writers.add(writer)
        try:
            while True:
                msg = await _read_frame(reader)
                kind, msg_id, method, payload = msg
                if method == "_register_peer":
                    peer_meta.update(payload)
                    async with write_lock:
                        _write_segments(writer, _frame_segments(
                            (_REPLY_OK, msg_id, None, None)))
                        await writer.drain()
                    continue
                handler = self._handlers.get(method)
                if handler is None:
                    if kind == _REQUEST:
                        async with write_lock:
                            _write_segments(writer, _frame_segments(
                                (_REPLY_ERR, msg_id, None,
                                 RpcError(f"no handler {method}"))))
                            await writer.drain()
                    continue
                asyncio.ensure_future(
                    self._dispatch(handler, kind, msg_id, method, payload,
                                   writer, write_lock, peer_meta)
                )
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            logger.exception("rpc server connection error")
        finally:
            self._conn_writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass
            if peer_meta and self._conn_lost_cb is not None:
                try:
                    self._conn_lost_cb(peer_meta)
                except Exception:
                    logger.exception("connection-lost callback failed")

    @staticmethod
    def _peer_id(peer_meta: Dict[str, Any], writer) -> str:
        pid = peer_meta.get("label") or peer_meta.get("worker_id")
        if pid:
            return str(pid)
        peername = writer.get_extra_info("peername")
        return _addr_str(peername) if peername else ""

    async def _dispatch(self, handler, kind, msg_id, method, payload, writer,
                        write_lock, peer_meta=None):
        t0 = time.monotonic()
        try:
            if _fi.PLAN is not None:
                peer_id = self._peer_id(peer_meta or {}, writer)
                act = await _fi.intercept(
                    _fi.SITE_BEFORE_EXECUTE, method=method, label=self.label,
                    peer=peer_id)
                if act == "drop":
                    return  # request lost before the handler: no reply ever
                if act == "disconnect":
                    # the request arrived but the connection dies before
                    # anything executes (peer crash between accept and
                    # dispatch)
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001
                        pass
                    return
                if act == "duplicate":
                    # redelivery: the handler runs an EXTRA time (reply
                    # discarded) — flushes out non-idempotent handlers
                    try:
                        await handler(payload)
                    except Exception:  # noqa: BLE001 — injected duplicate
                        pass
            reply = await handler(payload)
            try:
                hist = _rpc_handler_hist()
                if hist is not None:
                    hist.observe(time.monotonic() - t0,
                                 tags={"method": method})
            except Exception:  # noqa: BLE001 — a metrics failure must not
                pass           # turn a successful reply into _REPLY_ERR
            if kind == _REQUEST:
                frame = _frame_segments((_REPLY_OK, msg_id, None, reply))
        except Exception as e:
            if kind == _REQUEST:
                try:
                    frame = _frame_segments((_REPLY_ERR, msg_id, None, e))
                except Exception:
                    frame = _frame_segments(
                        (_REPLY_ERR, msg_id, None, RpcError(str(e))))
            else:
                logger.exception("error in oneway handler %s", method)
                return
        if kind == _REQUEST:
            if _fi.PLAN is not None:
                try:
                    act = await _fi.intercept(
                        _fi.SITE_AFTER_REPLY, method=method, label=self.label,
                        peer=self._peer_id(peer_meta or {}, writer))
                except Exception:  # noqa: BLE001 — injected "error" after the
                    act = "drop"   # handler ran == the reply is lost
                if act == "drop":
                    return  # handler executed, reply lost: the at-most-once
                            # ambiguity every owner/GCS retry path must survive
                if act == "disconnect":
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001
                        pass
                    return
                if act == "duplicate":
                    # the reply frame arrives twice: the client's request-id
                    # correlation must drop the second copy
                    try:
                        async with write_lock:
                            _write_segments(writer, frame)
                            await writer.drain()
                    except (ConnectionResetError, BrokenPipeError):
                        pass
            try:
                async with write_lock:
                    _write_segments(writer, frame)
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass


class RpcClient:
    """Persistent connection to an RpcServer with request-id correlation.

    Thread-safe sync facade (`call`, `send`) over the owning EventLoopThread;
    async variants for use on the loop itself. Lazily connects; `call` raises
    ConnectionLost when the peer is gone (callers implement retry policy, like
    the reference's retryable gRPC clients).
    """

    def __init__(self, address: str, loop_thread: EventLoopThread,
                 peer_meta: Optional[dict] = None, label: str = ""):
        self.address = address
        self._lt = loop_thread
        self._peer_meta = peer_meta
        # chaos addressing (fault_injection.py): `label` names the local
        # component; `local_id` (settable once known) is its own address,
        # used to match node-pair partitions.
        self.label = label
        self.local_id = label
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._msg_ids = itertools.count()
        self._connect_lock: Optional[asyncio.Lock] = None
        self._closed = False

    async def _ensure_connected(self):
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            host, port = parse_addr(self.address)
            self._reader, self._writer = await asyncio.open_connection(host, port)
            sock = self._writer.get_extra_info("socket")
            if sock is not None:
                # detect silently-dead peers (killed process, lost host) in
                # ~9s: idle 3s, then 3 probes 2s apart
                try:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
                    for opt, val in (("TCP_KEEPIDLE", 3),
                                     ("TCP_KEEPINTVL", 2),
                                     ("TCP_KEEPCNT", 3)):
                        if hasattr(socket, opt):  # Linux names; mac differs
                            sock.setsockopt(socket.IPPROTO_TCP,
                                            getattr(socket, opt), val)
                except OSError:
                    pass
            asyncio.ensure_future(self._read_loop(self._reader))
            if self._peer_meta:
                await self._call_async_locked("_register_peer", self._peer_meta)

    async def _read_loop(self, reader: asyncio.StreamReader):
        try:
            while True:
                kind, msg_id, _method, payload = await _read_frame(reader)
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == _REPLY_OK:
                    fut.set_result(payload)
                else:
                    fut.set_exception(payload)
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, OSError):
            pass
        finally:
            self._fail_pending(ConnectionLost(f"connection to {self.address} lost"))
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            self._writer = None

    def _fail_pending(self, exc: Exception):
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def _call_async_locked(self, method: str, payload: Any):
        msg_id = next(self._msg_ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        _write_segments(self._writer,
                        _frame_segments((_REQUEST, msg_id, method, payload)))
        await self._writer.drain()
        return await fut

    async def call_async(self, method: str, payload: Any = None,
                         timeout: Optional[float] = None):
        if self._closed:
            raise ConnectionLost("client closed", maybe_delivered=False)
        act = None
        if _fi.PLAN is not None:
            # may sleep (delay), raise ConnectionLost (error/partition), or
            # return a frame action applied below; zero work with no plan
            act = await _fi.intercept(
                _fi.SITE_CLIENT_REQUEST, method=method, label=self.label,
                peer=self.address, local_id=self.local_id)
        try:
            await self._ensure_connected()
        except OSError as e:
            raise ConnectionLost(f"cannot connect to {self.address}: {e}",
                                 maybe_delivered=False)
        msg_id = next(self._msg_ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        if act != "drop":  # "drop": frame never hits the wire — the caller
            try:           # waits on silence, exactly like network loss
                frame = _frame_segments((_REQUEST, msg_id, method, payload))
                _write_segments(self._writer, frame)
                if act == "duplicate":
                    _write_segments(self._writer, frame)  # executed twice
                await self._writer.drain()
                if act == "disconnect":
                    self._writer.close()  # reply can never arrive: pending
                    # futures fail ConnectionLost(maybe_delivered=True)
            except (ConnectionResetError, BrokenPipeError, AttributeError):
                self._pending.pop(msg_id, None)
                # maybe_delivered stays True: TCP gives no delivery receipt —
                # the full frame may have reached (and started executing on)
                # the peer before the local write/drain observed the reset.
                # Only a CONNECT failure (above) proves non-delivery.
                raise ConnectionLost(f"connection to {self.address} lost")
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            # Without this, a reply that never comes (peer wedged, chaos
            # "drop") leaks the pending entry for the connection's whole
            # life. A late reply after the pop is ignored by the read
            # loop's fut-is-gone check.
            self._pending.pop(msg_id, None)
            raise

    async def send_async(self, method: str, payload: Any = None):
        """One-way message (no reply)."""
        if self._closed:
            raise ConnectionLost("client closed", maybe_delivered=False)
        act = None
        if _fi.PLAN is not None:
            act = await _fi.intercept(
                _fi.SITE_CLIENT_REQUEST, method=method, label=self.label,
                peer=self.address, local_id=self.local_id)
        try:
            await self._ensure_connected()
        except OSError as e:
            raise ConnectionLost(f"cannot connect to {self.address}: {e}",
                                 maybe_delivered=False)
        if act == "drop":
            return  # oneway frame lost in flight: sender never knows
        try:
            frame = _frame_segments(
                (_ONEWAY, next(self._msg_ids), method, payload))
            _write_segments(self._writer, frame)
            if act == "duplicate":
                _write_segments(self._writer, frame)
            await self._writer.drain()
            if act == "disconnect":
                self._writer.close()
        except (ConnectionResetError, BrokenPipeError, AttributeError):
            raise ConnectionLost(f"connection to {self.address} lost")

    # ---- sync facades (callable from any non-loop thread) ----
    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None):
        from ray_tpu_torch._private.config import CONFIG
        t = timeout if timeout is not None else CONFIG.rpc_call_timeout_s
        return self._lt.run_coro(self.call_async(method, payload, timeout=t), timeout=t + 5)

    def call_future(self, method: str, payload: Any = None,
                    timeout: Optional[float] = None):
        """Pipelined call: enqueue the request and return a
        concurrent.futures.Future for the reply. The connection already
        multiplexes by request id, so N calls in flight cost one round
        trip of latency instead of N (burst actor registration relies on
        this)."""
        from ray_tpu_torch._private.config import CONFIG
        t = timeout if timeout is not None else CONFIG.rpc_call_timeout_s
        return self._lt.submit(self.call_async(method, payload, timeout=t))

    def send(self, method: str, payload: Any = None):
        self._lt.run_coro(self.send_async(method, payload), timeout=10)

    def close(self):
        self._closed = True

        async def _close():
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            self._fail_pending(ConnectionLost("client closed"))

        try:
            self._lt.run_coro(_close(), timeout=2.0)
        except Exception:
            pass


class ClientPool:
    """Cache of RpcClients by address (one persistent connection per peer)."""

    def __init__(self, loop_thread: EventLoopThread, peer_meta: Optional[dict] = None,
                 label: str = ""):
        self._lt = loop_thread
        self._peer_meta = peer_meta
        self.label = label
        self.local_id = label  # set to the owning endpoint's address once bound
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def set_local_id(self, local_id: str):
        """Stamp chaos-partition identity on the pool and existing clients
        (called once the owning component knows its own address)."""
        with self._lock:
            self.local_id = local_id
            for client in self._clients.values():
                client.local_id = local_id

    def get(self, address: str) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
            if client is None or client._closed:
                client = RpcClient(address, self._lt, peer_meta=self._peer_meta,
                                   label=self.label)
                client.local_id = self.local_id
                self._clients[address] = client
            return client

    def invalidate(self, address: str):
        with self._lock:
            client = self._clients.pop(address, None)
        if client is not None:
            client.close()

    def close_all(self):
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()


def find_free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_until(predicate: Callable[[], bool], timeout: float, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()
