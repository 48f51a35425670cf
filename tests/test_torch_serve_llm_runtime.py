"""The port's serve.llm end to end on the port's own runtime, case by case
as tests/test_serve_llm.py holds the JAX package's (all but its gRPC
case, which waits for the port's gRPC proxy): continuous-batching engine
replicas over the port's PagedInferenceEngine behind the token-streaming
router, concurrent streams balanced over the replicas, session affinity,
429 load shedding through the handle and the HTTP proxy, SSE, the
TTFT/TPOT metrics, a dropped stream freeing its engine slot and the
owner's stream state, autoscaling on the engines' queue depth, and a
disconnect on every proxy shard cancelling its stream.

The engines run the tiny fp32 config on the CPU; their build
(`inference.benchmarks.PagedEngineBuilder`) carries the weights to each
replica by value.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private.rpc import find_free_port
from ray_tpu_torch.inference.benchmarks import PagedEngineBuilder
from ray_tpu_torch.models import llama

HTTP_PORT = find_free_port()


def tiny_config(**kw):
    return dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32, **kw)


def builder(cfg, **engine):
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return PagedEngineBuilder(cfg, "cpu", engine, params=params)


@pytest.fixture(scope="module")
def llm_cluster():
    rt.init(num_cpus=4)
    serve.start()
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(scope="module")
def llm_handle(llm_cluster):
    """One 2-replica serving app shared by the module's tests."""
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(
        builder(tiny_config(), max_batch=4, max_len=128, block_size=16,
                decode_chunk=4),
        name="llm", num_replicas=2, default_config={"max_new_tokens": 8},
        shed_queue_depth=64)
    handle = serve.run(app, name="llm", route_prefix="/llm",
                       http_port=HTTP_PORT)
    warm = [threading.Thread(target=lambda i=i: list(
        handle.options(method_name="stream_tokens", stream=True).remote(
            {"prompt": [1 + i, 2, 3]}))) for i in range(4)]
    for t in warm:
        t.start()
    for t in warm:
        t.join()
    return handle


def _stream(handle, prompt, max_new=8, session=None):
    req = {"prompt": prompt, "max_new_tokens": max_new}
    if session is not None:
        req["session_id"] = session
    return handle.options(method_name="stream_tokens",
                          stream=True).remote(req)


def _engine_stats(app, deployment):
    controller = rt.get_actor("SERVE_CONTROLLER")
    reps = rt.get(controller.get_replica_handles.remote(app, deployment))
    return [rt.get(r.handle_request.remote("get_stats", (), {}), timeout=30)
            for r in reps]


def test_e2e_concurrent_streams_interleave_and_balance(llm_handle):
    """Eight concurrent streams over 2 replicas: the streams overlap, the
    engines batch them, both replicas serve, and the TTFT/TPOT series
    reach prometheus_text() after collection."""
    from ray_tpu_torch.serve.llm import collect_llm_metrics
    from ray_tpu_torch.util.metrics import prometheus_text

    before = llm_handle.get_router_stats.remote().result(timeout_s=30)
    n = 8
    first_at, done_at, outs = [None] * n, [None] * n, [None] * n
    # every stream submitted before any is consumed: the engines see 8
    # near-simultaneous requests whatever the consumer threads' order
    gens = [_stream(llm_handle, [1 + i, 5, 9, 2], max_new=24)
            for i in range(n)]

    def consume(i):
        toks = []
        for tok in gens[i]:
            if first_at[i] is None:
                first_at[i] = time.monotonic()
            toks.append(tok)
        done_at[i] = time.monotonic()
        outs[i] = toks

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o is not None and len(o) == 24 for o in outs), outs
    assert min(first_at) < min(done_at)
    peaks = [s["engine"]["peak_active"]
             for s in _engine_stats("llm", "llm_engine")]
    assert sum(peaks) >= 4, f"engines never batched: peaks {peaks}"
    stats = llm_handle.get_router_stats.remote().result(timeout_s=30)
    delta = {rid: stats["assigned_total"].get(rid, 0)
             - before["assigned_total"].get(rid, 0)
             for rid in stats["assigned_total"]}
    assert len([r for r, c in delta.items() if c > 0]) >= 2, delta
    assert collect_llm_metrics() >= 2
    text = prometheus_text()
    for series in ("ray_tpu_llm_ttft_seconds_count",
                   "ray_tpu_llm_tpot_seconds_count"):
        lines = [ln for ln in text.splitlines() if ln.startswith(series)]
        assert lines, f"missing {series} in prometheus_text()"
        assert any(float(ln.rsplit(" ", 1)[1]) > 0 for ln in lines), lines
    assert "ray_tpu_llm_tokens_generated_total" in text
    assert "ray_tpu_llm_batch_occupancy" in text


def test_pushed_load_leaves_out_the_routers_own_requests():
    """The controller's ongoing count of a replica includes the router's
    own requests. A count sampled while the router's own request ran, and
    pushed after it ended, charges the replica nothing; a request of
    another router still counts; a push without the sample's age counts
    whole."""
    import random

    from ray_tpu_torch.serve.llm.router import LLMRouter

    r = object.__new__(LLMRouter)
    r._lock = threading.Lock()
    r._have_replicas = threading.Event()
    r._rng = random.Random(0)
    r._deployment, r._shed_queue_depth, r._shed_total = "llm_engine", 64, 0
    r._replicas, r._sessions, r._assigned_total = [], {}, {}
    r._base_load, r._out_tokens, r._out_requests, r._own_log = {}, {}, {}, {}

    def push(metrics, sampled_at=None):
        ages = ({} if sampled_at is None else
                {rid: time.monotonic() - sampled_at for rid in metrics})
        r._apply_update({"replicas": [("a", None), ("b", None)],
                         "metrics": metrics, "metrics_age_s": ages})
        return r._base_load

    push({})
    rid, _ = r._choose(None, 24)
    other = "b" if rid == "a" else "a"
    time.sleep(0.01)
    sampled_at = time.monotonic()  # the router's request is in flight
    time.sleep(0.01)
    assert push({rid: 1, other: 0}, sampled_at) == {rid: 0, other: 0}
    r._release(rid, 0)
    assert push({rid: 1, other: 0}, sampled_at) == {rid: 0, other: 0}
    assert push({rid: 2, other: 1}, sampled_at) == {rid: 1, other: 1}
    assert push({rid: 1, other: 0}) == {rid: 1, other: 0}
    # an idle replica pushed as busy by a stale count no longer repels
    # the streams: both replicas take some of eight sequential requests
    push({rid: 1, other: 0}, sampled_at)
    chosen = set()
    for _ in range(8):
        got, _ = r._choose(None, 24)
        r._release(got, 0)
        chosen.add(got)
    assert chosen == {"a", "b"}


def test_unary_generate_and_determinism(llm_handle):
    out1 = llm_handle.generate.remote(
        {"prompt": [3, 1, 4], "max_new_tokens": 6}).result(timeout_s=60)
    out2 = llm_handle.generate.remote(
        {"prompt": [3, 1, 4], "max_new_tokens": 6}).result(timeout_s=60)
    assert out1["n"] == 6 and len(out1["tokens"]) == 6
    assert out1["tokens"] == out2["tokens"]  # greedy by default


def test_session_affinity_sticks_to_one_replica(llm_handle):
    before = llm_handle.get_router_stats.remote().result(timeout_s=30)
    for _ in range(4):
        assert len(list(_stream(llm_handle, [7, 7, 7], max_new=4,
                                session="affine-1"))) == 4
    after = llm_handle.get_router_stats.remote().result(timeout_s=30)
    delta = {rid: after["assigned_total"].get(rid, 0)
             - before["assigned_total"].get(rid, 0)
             for rid in after["assigned_total"]}
    assert len([r for r, c in delta.items() if c > 0]) == 1, delta
    assert after["sessions"] >= 1


def test_http_sse_stream(llm_handle):
    """Tokens reach an HTTP client as Server-Sent Events through the
    proxy's chunked path."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{HTTP_PORT}/llm",
        data=json.dumps({"prompt": [2, 4, 6], "max_new_tokens": 5}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        body = r.read().decode()
    events = [ln[len("data: "):] for ln in body.splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events if e != "[DONE]"]
    assert len([p["token"] for p in parsed if "token" in p]) == 5
    usage = json.loads(events[-2])["usage"]
    assert usage["completion_tokens"] == 5
    assert usage["prompt_tokens"] == 3


def test_router_sheds_with_429_past_queue_bound(llm_cluster):
    """Past the aggregate queue bound the router fails fast with 429:
    through the handle (a typed error) and through the HTTP proxy (the
    status code)."""
    from ray_tpu_torch.serve.llm import build_llm_app

    app = build_llm_app(
        builder(tiny_config(), max_batch=2, max_len=128, block_size=16,
                decode_chunk=2),
        name="llm_tight", num_replicas=1,
        default_config={"max_new_tokens": 64}, shed_queue_depth=2)
    handle = serve.run(app, name="llm_tight", route_prefix="/llm_tight",
                       http_port=HTTP_PORT)
    assert len(list(_stream(handle, [1, 2], max_new=4))) == 4

    n = 10
    results = [None] * n

    def issue(i):
        try:
            results[i] = len(list(_stream(handle, [1 + i, 2], max_new=64)))
        except Exception as e:  # noqa: BLE001 — expected for shed ones
            results[i] = e

    threads = [threading.Thread(target=issue, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    shed = [r for r in results if isinstance(r, Exception)]
    assert [r for r in results if isinstance(r, int)], results
    assert shed, f"queue bound never shed: {results}"
    assert all(getattr(e, "status_code", None) == 429 for e in shed), shed
    stats = handle.get_router_stats.remote().result(timeout_s=30)
    assert stats["shed_total"] >= len(shed)

    def http_issue(i, codes):
        req = urllib.request.Request(
            f"http://127.0.0.1:{HTTP_PORT}/llm_tight",
            data=json.dumps({"prompt": [1 + i, 3],
                             "max_new_tokens": 64}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()
                codes[i] = r.status
        except urllib.error.HTTPError as e:
            codes[i] = e.code

    codes = [None] * n
    threads = [threading.Thread(target=http_issue, args=(i, codes))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert 429 in codes, f"no 429 through the proxy: {codes}"
    assert 200 in codes, f"every HTTP request shed: {codes}"
    serve.delete("llm_tight")


def test_dropped_stream_frees_engine_slot_and_owner_state(llm_handle):
    """Closing a stream mid-flight cancels the chain (router -> engine),
    frees the engine's slot and KV blocks, and releases the owner's
    generator bookkeeping."""
    from ray_tpu_torch._raylet import get_core_worker

    cw = get_core_worker()

    def slots_free():
        stats = _engine_stats("llm", "llm_engine")
        return (all(s["outstanding_requests"] == 0 for s in stats)
                and all(s["engine"]["active_slots"] == 0 for s in stats))

    deadline = time.monotonic() + 30
    while not slots_free():
        assert time.monotonic() < deadline, "engine busy before the test"
        time.sleep(0.2)

    gens_before = set(cw._generators.keys())
    gen = _stream(llm_handle, [9, 8, 7], max_new=100)
    it = iter(gen)
    assert isinstance(next(it), int)
    new_tasks = set(cw._generators.keys()) - gens_before
    assert len(new_tasks) == 1  # the router stream this driver owns
    gen.close()  # the client walks away mid-stream

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if (not (set(cw._generators.keys()) & new_tasks)) and slots_free():
            return
        time.sleep(0.2)
    raise AssertionError(
        f"leak after close(): owner generators "
        f"{set(cw._generators.keys()) & new_tasks}, "
        f"engine busy={not slots_free()}")


def test_release_generator_frees_unconsumed_items(llm_cluster):
    """close() on an ObjectRefGenerator of the port's runtime drops the
    owner's _generators entry and the unconsumed return objects."""
    from ray_tpu_torch._raylet import get_core_worker

    @rt.remote
    def stream(n):
        for i in range(n):
            yield i

    cw = get_core_worker()
    gens_before = set(cw._generators.keys())
    refs_before = cw.reference_counter.num_tracked()
    g = stream.options(num_returns="streaming").remote(64)
    it = iter(g)
    assert rt.get(next(it)) == 0
    (task_id,) = set(cw._generators.keys()) - gens_before
    deadline = time.monotonic() + 10
    while cw._generators[task_id].reported < 8:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    g.close()
    assert task_id not in cw._generators
    deadline = time.monotonic() + 10
    while cw.reference_counter.num_tracked() > refs_before + 2:
        assert time.monotonic() < deadline, (
            f"unconsumed stream items still tracked: "
            f"{cw.reference_counter.num_tracked()} vs {refs_before}")
        time.sleep(0.05)


def test_autoscaler_uses_engine_queue_depth(llm_cluster):
    """A replica that reports an admission backlog through
    get_autoscaling_metrics() scales up with no ongoing requests."""

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 2})
    class Backlogged:
        def get_autoscaling_metrics(self):
            return {"queue_depth": 6}

        def __call__(self, _x=None):
            return "ok"

    serve.run(Backlogged.bind(), name="backlog_app")
    try:
        deadline = time.monotonic() + 30
        st = None
        while time.monotonic() < deadline:
            st = serve.status()["backlog_app"]["deployments"]["Backlogged"]
            if st["target_replicas"] == 3:  # ceil(6 / 2)
                return
            time.sleep(0.2)
        raise AssertionError(f"the queue depth never scaled it: {st}")
    finally:
        serve.delete("backlog_app")


def test_disconnect_mid_stream_closes_generator_on_every_shard(
        llm_cluster):
    """A client that disconnects mid-stream cancels the replica's stream
    on every proxy shard: raw sockets, one an attempt, until the kernel's
    SO_REUSEPORT hashing has reached every shard; then the engine's slots
    and blocks drain. A model wider than tiny(), so that a stream is
    still decoding when the disconnect lands."""
    import socket

    from ray_tpu_torch.serve.llm import build_llm_app

    cfg = llama.LlamaConfig(vocab_size=128, d_model=256, n_layers=4,
                            n_heads=8, n_kv_heads=4, d_head=32, d_ff=512,
                            max_seq_len=512, dtype=torch.float32)
    app = build_llm_app(
        builder(cfg, max_batch=4, max_len=512, block_size=16,
                decode_chunk=4),
        name="llm_slow", num_replicas=1,
        default_config={"max_new_tokens": 450}, shed_queue_depth=64)
    serve.run(app, name="llm_slow", route_prefix="/llm_slow",
              http_port=HTTP_PORT, http_shards=2)
    controller = rt.get_actor("SERVE_CONTROLLER")
    shards = rt.get(controller.get_http_proxy_handles.remote())
    assert len(shards) >= 2, "a sharded proxy expected"

    def shard_served():
        return {i: rt.get(s.get_stats.remote(),
                          timeout=30)["requests_served"]
                for i, s in shards.items()}

    def drained(deadline_s=30.0):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            stats = _engine_stats("llm_slow", "llm_slow_engine")
            if (all(s["outstanding_requests"] == 0 for s in stats)
                    and all(s["engine"]["active_slots"] == 0
                            for s in stats)
                    and all(s["engine"]["available_blocks"]
                            == s["engine"]["n_blocks"] - 1
                            for s in stats)):
                return True
            time.sleep(0.2)
        return False

    assert drained(), "engine busy before the test started"
    finished_before = sum(s["finished_requests"] for s in
                          _engine_stats("llm_slow", "llm_slow_engine"))
    hit_shards, n_streams = set(), 0
    for attempt in range(24):
        before = shard_served()
        conn = socket.create_connection(("127.0.0.1", HTTP_PORT),
                                        timeout=30)
        body = json.dumps({"prompt": [9, 9, 1 + attempt],
                           "max_new_tokens": 450}).encode()
        conn.sendall(
            b"POST /llm_slow HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode()
            + b"\r\n\r\n" + body)
        buf = b""
        while b"data:" not in buf:  # the first SSE byte, then walk away
            chunk = conn.recv(4096)
            assert chunk, f"stream closed early: {buf!r}"
            buf += chunk
        assert b" 200 " in buf.split(b"\r\n", 1)[0]
        conn.close()
        n_streams += 1
        after = shard_served()
        hit_shards |= {i for i in after if after[i] > before.get(i, 0)}
        if len(hit_shards) == len(shards) and n_streams >= 4:
            break
    assert hit_shards == set(shards), hit_shards
    assert drained(), _engine_stats("llm_slow", "llm_slow_engine")
    finished_after = sum(s["finished_requests"] for s in
                         _engine_stats("llm_slow", "llm_slow_engine"))
    # some streams were cancelled mid-flight (a finished one counts)
    assert finished_after - finished_before < n_streams
    serve.delete("llm_slow")


def test_paged_engine_serve_stream_dynamic_admission():
    """The port's engine alone: a request that arrives mid-generation joins
    the running batch; a cancel frees its slot and blocks; the dynamic
    path gives the one-shot batch path's tokens."""
    from ray_tpu_torch.inference import GenerationConfig

    eng = builder(tiny_config(), max_batch=4, max_len=64, block_size=8,
                  decode_chunk=2)()
    step = {"n": 0}

    def feed(_block):
        step["n"] += 1
        if step["n"] == 1:
            return [("A", [1, 2, 3], 8), ("C", [9, 9], 20)], (), False
        if step["n"] == 3:
            return [("B", [4, 5], 6)], ("C",), False
        return [], (), step["n"] > 4

    out, order = {}, []
    for rid, tok, _done in eng.serve_stream(
            feed, GenerationConfig(max_new_tokens=8)):
        assert tok is not None, eng.abort_reasons
        out.setdefault(rid, []).append(tok)
        order.append(rid)
    assert len(out["A"]) == 8 and len(out["B"]) == 6
    assert len(out.get("C", [])) < 20  # cancelled mid-stream
    assert min(i for i, r in enumerate(order) if r == "B") < max(
        i for i, r in enumerate(order) if r == "A")
    assert sorted(eng.free_slots) == [0, 1, 2, 3]
    assert eng.available_blocks() == eng.n_blocks - 1
    assert eng.generate([[1, 2, 3]],
                        GenerationConfig(max_new_tokens=8))[0] == out["A"]
