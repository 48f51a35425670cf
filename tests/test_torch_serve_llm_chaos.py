"""The port's serve.llm under replica death, case by case as
tests/test_serve_llm_chaos.py holds the JAX package's: a stream whose
engine replica dies before its first token reaches the client fails over
and completes; one whose replica dies mid-decode ends with the typed
LLMReplicaUnavailableError (a replay would repeat tokens the client has
consumed); in both the router's accounting for the dead replica is
released, and the surviving engines leak no ref-counted KV blocks. The
replicas are worker processes of the port's runtime, killed for real
(`ray_tpu_torch.kill`). The engines run the tiny fp32 config on the CPU.
"""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm import LLMReplicaUnavailableError
from test_torch_serve_llm_runtime import builder, tiny_config


@pytest.fixture(scope="module")
def llm_handle():
    rt.init(num_cpus=4)
    serve.start()
    from ray_tpu_torch.serve.llm import build_llm_app

    # 3 replicas: each kill test downs one and still leaves a failover
    # target; the controller starts replacements in the background
    app = build_llm_app(
        builder(tiny_config(), max_batch=4, max_len=512, block_size=16,
                decode_chunk=4),
        name="llm", num_replicas=3, default_config={"max_new_tokens": 8},
        shed_queue_depth=64)
    handle = serve.run(app, name="llm")
    for i in range(3):
        list(handle.options(method_name="stream_tokens", stream=True)
             .remote({"prompt": [1 + i, 2, 3], "max_new_tokens": 4}))
    yield handle
    serve.shutdown()
    rt.shutdown()


def _stats(handle):
    return handle.get_router_stats.remote().result(timeout_s=30)


def _replica_handles():
    """rid -> engine replica actor handle, from the controller's long-poll
    table (the router's own source)."""
    controller = rt.get_actor("SERVE_CONTROLLER")
    update = rt.get(controller.listen_for_change.remote(
        "llm#llm_engine", -1, timeout=1.0), timeout=30)
    return dict(update["replicas"])


def _wait_replicas(handle, n, timeout=90.0):
    """Until the router lists exactly the controller's `n` replicas and
    each answers: a replica an earlier test killed is gone from both and
    replaced, so no assignment below fails over from it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        listed = _replica_handles()
        if (sorted(_stats(handle)["replicas"]) == sorted(listed)
                and len(listed) == n):
            try:
                rt.get([h.handle_request.remote("get_stats", (), {})
                        for h in listed.values()], timeout=10)
                return True
            except Exception:  # noqa: BLE001 — a dead one, not yet dropped
                pass
        time.sleep(0.5)
    return False


def _served_by(before, after):
    grew = [rid for rid in after if after[rid] > before.get(rid, 0)]
    assert len(grew) == 1, (before, after)
    return grew[0]


def _stream(handle, request):
    return handle.options(method_name="stream_tokens",
                          stream=True).remote(request)


def test_pre_first_token_failover_completes_stream(llm_handle):
    """A replica dead at assignment time (session affinity pins to it, the
    router has not heard yet): the stream fails over and completes."""
    assert _wait_replicas(llm_handle, 3)
    before = _stats(llm_handle)["assigned_total"]
    request = {"prompt": [5, 6, 7], "max_new_tokens": 6,
               "session_id": "chaos-a"}
    assert len(list(_stream(llm_handle, request))) == 6
    rid = _served_by(before, _stats(llm_handle)["assigned_total"])
    handles = _replica_handles()
    assert rid in handles, (rid, list(handles))
    rt.kill(handles[rid])  # the worker process dies; the router learns late

    assert len(list(_stream(llm_handle, request))) == 6
    stats = _stats(llm_handle)
    assert sum(stats["outstanding_requests"].values()) == 0
    assert all(v == 0 for v in stats["outstanding_tokens"].values()), stats


def test_mid_decode_kill_raises_typed_error_and_frees_accounting(llm_handle):
    """A replica killed mid-decode after tokens were consumed: the typed
    LLMReplicaUnavailableError, the accounting freed, and the next request
    served by a survivor."""
    assert _wait_replicas(llm_handle, 3)
    before = _stats(llm_handle)["assigned_total"]
    it = iter(_stream(llm_handle, {"prompt": [9, 8, 7],
                                   "max_new_tokens": 400}))
    got = [next(it), next(it)]  # first tokens are out: no silent replay
    assert all(isinstance(t, int) for t in got)
    rid = _served_by(before, _stats(llm_handle)["assigned_total"])
    rt.kill(_replica_handles()[rid])

    with pytest.raises(Exception) as err:
        for _ in it:
            pass
    assert "LLMReplicaUnavailable" in type(err.value).__name__ + str(
        err.value), err.value

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        stats = _stats(llm_handle)
        if (sum(stats["outstanding_requests"].values()) == 0
                and all(v == 0
                        for v in stats["outstanding_tokens"].values())):
            break
        time.sleep(0.2)
    else:
        raise AssertionError(f"accounting not freed: {stats}")
    assert len(list(_stream(llm_handle, {"prompt": [3, 2, 1],
                                         "max_new_tokens": 5}))) == 5


def test_replica_kill_mid_stream_leaks_no_refcounted_blocks(llm_handle):
    """Streams sharing a cached prefix (blocks at refcount > 1) are in
    flight when one replica dies: every surviving engine drains to no
    active slot with its whole pool allocatable again, and the prefix
    cache recorded hits. The prefix is warmed under one session, so that
    its replica holds it and serves two of the streams; a replica other
    than that one is killed (the JAX test warms two requests over three
    replicas and kills the first, which may be the one that cached it)."""
    assert _wait_replicas(llm_handle, 3)
    controller = rt.get_actor("SERVE_CONTROLLER")

    def engine_stats():
        reps = rt.get(controller.get_replica_handles.remote("llm",
                                                            "llm_engine"))
        out = []
        for r in reps:
            try:
                out.append(rt.get(
                    r.handle_request.remote("get_stats", (), {}),
                    timeout=30))
            except Exception:  # noqa: BLE001 — the killed one
                pass
        return out

    shared = [6] * 48  # 3 blocks of 16: a shared prefix of several blocks
    before = _stats(llm_handle)["assigned_total"]
    for i in range(2):
        list(_stream(llm_handle, {"prompt": shared + [20 + i],
                                  "max_new_tokens": 4,
                                  "session_id": "prefix"}))
    holder = _served_by(before, _stats(llm_handle)["assigned_total"])
    its = [iter(_stream(llm_handle, {
        "prompt": shared + [1 + i], "max_new_tokens": 300,
        **({"session_id": "prefix"} if i < 2 else {})}))
        for i in range(4)]
    for it in its:
        next(it)  # all four streams live
    victims = [h for rid, h in _replica_handles().items() if rid != holder]
    assert victims, "no replica beside the prefix's"
    rt.kill(victims[0])

    for it in its:  # typed 503s allowed, hangs are not
        try:
            for _ in it:
                pass
        except Exception as e:  # noqa: BLE001
            assert "LLMReplicaUnavailable" in type(e).__name__ + str(e), e

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        stats = engine_stats()
        if stats and all(
                s["outstanding_requests"] == 0
                and s["engine"]["active_slots"] == 0
                and s["engine"]["available_blocks"]
                == s["engine"]["n_blocks"] - 1
                for s in stats):
            break
        time.sleep(0.5)
    else:
        raise AssertionError(f"ref-counted blocks leaked after the kill: "
                             f"{engine_stats()}")
    assert any(s["engine"]["prefix_cache"]["hit_requests"] > 0
               for s in engine_stats())


def test_typed_error_carries_http_status():
    assert LLMReplicaUnavailableError.status_code == 503
