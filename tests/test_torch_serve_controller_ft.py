"""Serve's control-plane fault tolerance in the port, case by case as
tests/test_serve_controller_ft.py holds the JAX package's: the controller
checkpointed in the port's GCS KV, live replicas adopted after a crash,
the data plane serving while the controller is down, the checkpoint's
schema read forward, every mutator writing through the checkpoint, and
stale-incarnation pushes refused by the router.

* crash -> recover ADOPTS: a controller killed crash-style restarts in
  place (same named actor, max_restarts=-1), loads its GCS-KV checkpoint
  and re-resolves live replicas and proxy shards by name: replica PIDs
  are identical before and after, deployments and routes intact, HTTP
  served through the outage.
* the data plane never depends on a live controller: long-poll failures
  degrade to paced re-resolve over cached replica sets, never to errors.
* the checkpoint envelope is schema-versioned and decodes forward.
"""

import http.client
import pickle
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve import context as serve_ctx
from ray_tpu_torch.serve._private import controller as controller_mod

@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture
def serve_instance(runtime):
    serve.start()
    yield
    serve.shutdown()


def _recovery_info(timeout=5.0):
    c = serve_ctx.get_controller()
    return rt.get(c.get_recovery_info.remote(), timeout=timeout)


def _wait_for_incarnation(n: int, timeout: float = 60.0) -> dict:
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            last = _recovery_info()
            if last["incarnation"] >= n:
                return last
        except Exception:  # noqa: BLE001 — controller mid-restart
            pass
        time.sleep(0.2)
    raise TimeoutError(
        f"controller never reached incarnation {n} (last: {last})")


def _free_port() -> int:
    from ray_tpu_torch._private.rpc import find_free_port

    return find_free_port()


# -- crash -> recover e2e -----------------------------------------------------

def test_controller_crash_recovery_adopts_replicas(serve_instance):
    """The tentpole e2e: kill the controller under HTTP traffic; the
    restarted incarnation must adopt the live replicas (same PIDs, no
    fresh actors), rebuild routes, and the proxy must serve through the
    whole outage with zero failed requests."""

    @serve.deployment(num_replicas=2)
    def whoami(v=None):
        import os

        return os.getpid()

    port = _free_port()
    handle = serve.run(whoami.bind(), name="adopt", http_port=port,
                       http_shards=1)
    pids_before = {handle.remote().result(timeout_s=30)
                   for _ in range(20)}
    assert len(pids_before) == 2  # both replicas serving

    info0 = _recovery_info()
    assert info0["incarnation"] == 1
    assert info0["checkpoints_written"] > 0  # write-through, not a timer
    app_info_before = rt.get(
        serve_ctx.get_controller().get_app_info.remote("adopt"),
        timeout=10)

    # continuous HTTP load through the kill + recovery window
    errors, oks = [], [0]
    stop = threading.Event()

    def _traffic():
        while not stop.is_set():
            try:
                conn = http.client.HTTPConnection(f"127.0.0.1:{port}",
                                                  timeout=10)
                conn.request("GET", "/adopt")
                resp = conn.getresponse()
                resp.read()
                if resp.status == 200:
                    oks[0] += 1
                else:
                    errors.append(resp.status)
                conn.close()
            except Exception as e:  # noqa: BLE001 — counted as failure
                errors.append(repr(e))
            time.sleep(0.05)

    t = threading.Thread(target=_traffic, daemon=True)
    t.start()
    try:
        time.sleep(0.5)
        # crash-style kill: unintended death -> GCS restart FSM
        rt.kill(serve_ctx.get_controller(), no_restart=False)
        info = _wait_for_incarnation(2)
        time.sleep(1.0)  # keep measuring past the recovery edge
    finally:
        stop.set()
        t.join(timeout=10)

    # nonstop data plane: zero failed requests through the outage
    assert not errors, f"requests failed during controller outage: " \
                       f"{errors[:5]} ({len(errors)} total)"
    assert oks[0] > 5

    # adoption, not restart: same replica actors, same PIDs
    assert info["adopted_replicas"] == 2
    assert info["restarted_replicas"] == 0
    pids_after = {handle.remote().result(timeout_s=30)
                  for _ in range(20)}
    assert pids_after == pids_before

    # control-plane state intact and live again: deployments visible,
    # the app record (incl. ingress_flags — what proxy shards rebuild
    # their ASGI/streaming/LLM routing from) identical, and a redeploy
    # (scale to 3) still reconciles
    st = serve.status()
    assert st["adopt"]["deployments"]["whoami"]["replicas"] == 2
    app_info_after = rt.get(
        serve_ctx.get_controller().get_app_info.remote("adopt"),
        timeout=10)
    assert app_info_after == app_info_before
    serve.run(whoami.options(num_replicas=3).bind(), name="adopt",
              http_port=port, http_shards=1)
    deadline = time.time() + 60
    while time.time() < deadline:
        if serve.status()["adopt"]["deployments"]["whoami"][
                "replicas"] == 3:
            break
        time.sleep(0.2)
    assert {handle.remote().result(timeout_s=30)
            for _ in range(30)} > pids_before  # grew, old PIDs kept


def test_recovered_controller_reconciles_missing_replicas(serve_instance):
    """A replica that died DURING the controller outage is not
    adoptable: recovery must count it lost and the reconcile loop must
    replace it (normal path), while the surviving replica is adopted."""

    @serve.deployment(num_replicas=2)
    def echo(v=None):
        return "ok"

    serve.run(echo.bind(), name="gap")
    controller = serve_ctx.get_controller()
    replicas = rt.get(
        controller.get_replica_handles.remote("gap", "echo"), timeout=30)
    assert len(replicas) == 2
    rt.kill(controller, no_restart=False)
    rt.kill(replicas[0])  # dies while the control plane is down
    info = _wait_for_incarnation(2)
    assert info["adopted_replicas"] + info["restarted_replicas"] == 2
    assert info["restarted_replicas"] >= 1
    handle = serve.get_app_handle("gap")
    deadline = time.time() + 60
    while time.time() < deadline:
        st = serve.status()["gap"]["deployments"]["echo"]
        if st["replicas"] == 2:
            break
        time.sleep(0.2)
    assert serve.status()["gap"]["deployments"]["echo"]["replicas"] == 2
    assert handle.remote().result(timeout_s=30) == "ok"


def test_adopts_replica_still_initializing(serve_instance):
    """A controller crash overlapping a slow replica __init__ (LLM
    compile, minutes in production) must re-adopt the STARTING replica
    with a fresh init deadline — never kill it because its health probe
    is queued behind the still-running constructor."""
    from ray_tpu_torch.serve._private.controller import REPLICA_NAME_PREFIX

    @serve.deployment(num_replicas=1)
    class Slow:
        def __init__(self):
            import time as _t

            _t.sleep(6.0)

        def __call__(self, v=None):
            import os

            return os.getpid()

    serve.run(Slow.bind(), name="slowinit")  # first replica ready
    # scale to 2 (same version: target change only) — the new replica
    # sits in STARTING for ~6s of user __init__
    serve.run(Slow.options(num_replicas=2).bind(), name="slowinit")
    starting_name = REPLICA_NAME_PREFIX + "slowinit#Slow#1"
    deadline = time.time() + 30
    actor_before = None
    while time.time() < deadline:
        try:
            actor_before = rt.get_actor(starting_name)
            break
        except ValueError:
            time.sleep(0.1)
    assert actor_before is not None
    rt.kill(serve_ctx.get_controller(), no_restart=False)
    info = _wait_for_incarnation(2)
    assert info["adopted_replicas"] == 2  # incl. the STARTING one
    assert info["restarted_replicas"] == 0
    deadline = time.time() + 60
    while time.time() < deadline:
        st = serve.status()["slowinit"]["deployments"]["Slow"]
        if st["replicas"] == 2:
            break
        time.sleep(0.2)
    assert serve.status()["slowinit"]["deployments"]["Slow"][
        "replicas"] == 2
    # SAME actor finished its original init — adopted, not replaced
    actor_after = rt.get_actor(starting_name)
    assert actor_after._actor_id == actor_before._actor_id


# -- nonstop data plane while the controller is DOWN --------------------------

def test_traffic_flows_while_controller_down(serve_instance):
    """Regression for the router's graceful degradation: a dead
    controller (no restart coming) must not error client requests or
    evict cached replicas — listen_for_change failures pace out via
    BackoffPolicy and the cached replica set keeps serving."""

    @serve.deployment(num_replicas=2)
    def echo(v=None):
        return "ok"

    handle = serve.run(echo.bind(), name="ctl_down")
    assert handle.remote().result(timeout_s=30) == "ok"
    rt.kill(serve_ctx.get_controller())  # terminal: stays dead
    time.sleep(1.0)  # let the long-poll loops start failing
    for _ in range(20):
        assert handle.remote().result(timeout_s=10) == "ok"


# -- checkpoint envelope schema -----------------------------------------------

def test_checkpoint_schema_forward_compat():
    """An OLD envelope (version 1, missing every field added later)
    decodes and restores: every restore-path read uses a default.
    Foreign, torn, and FUTURE-versioned blobs are refused whole."""
    old = {
        "schema": controller_mod.CKPT_SCHEMA,
        "version": 1,
        "incarnation": 3,
        "apps": {"a": {"ingress": "d", "route_prefix": "/",
                       "deployments": ["d"], "ingress_flags": {}}},
        # v1-era minimal deployment record: no proxy/versions keys at all
        "deployments": {"a#d": {"app": "a", "name": "d",
                                "config": {"num_replicas": 1},
                                "replicas": []}},
    }
    env = controller_mod.decode_checkpoint(
        pickle.dumps(old, protocol=5))
    assert env is not None
    assert env["incarnation"] == 3
    assert env.get("proxy") is None  # reader must default this
    assert env.get("versions") is None

    # unknown future fields ride along without breaking the decode
    fwd = dict(old, some_future_field={"x": 1})
    assert controller_mod.decode_checkpoint(pickle.dumps(fwd)) is not None

    # refusals: garbage, foreign schema, NEWER version
    assert controller_mod.decode_checkpoint(b"") is None
    assert controller_mod.decode_checkpoint(b"garbage") is None
    assert controller_mod.decode_checkpoint(
        pickle.dumps({"schema": "other", "version": 1})) is None
    assert controller_mod.decode_checkpoint(pickle.dumps(
        {"schema": controller_mod.CKPT_SCHEMA,
         "version": controller_mod.CKPT_VERSION + 1})) is None


def test_old_envelope_restores_into_live_controller(serve_instance):
    """The forward-compat claim end to end: plant a v1-minimal envelope
    in the GCS KV, start a controller, and watch it restore the app and
    reconcile the (empty) replica set up to target."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.experimental.internal_kv import internal_kv_put

    def hello(v=None):
        return "hi"

    old = {
        "schema": controller_mod.CKPT_SCHEMA,
        "version": 1,
        "incarnation": 7,
        "apps": {"legacy": {"ingress": "hello", "route_prefix": "/",
                            "deployments": ["hello"],
                            "ingress_flags": {}}},
        "deployments": {"legacy#hello": {
            "app": "legacy", "name": "hello",
            "config": {"name": "hello",
                       "callable": ser.dumps_function(hello),
                       "num_replicas": 1},
            "target_num_replicas": 1,
            "replicas": [],
        }},
    }
    # the running controller (incarnation 1) is about to be replaced:
    # kill it terminally, plant the envelope, start a fresh one
    rt.kill(serve_ctx.get_controller())
    serve_ctx.clear_controller_cache()
    internal_kv_put(controller_mod.CKPT_KEY,
                    pickle.dumps(old, protocol=5),
                    namespace=controller_mod.CKPT_NAMESPACE)
    serve_ctx.get_controller(create=True)
    info = _recovery_info()
    assert info["incarnation"] == 8  # bumped past the envelope's 7
    handle = serve.get_app_handle("legacy")
    assert handle.remote().result(timeout_s=60) == "hi"


# -- the write-through rule --------------------------------------------------

def test_controller_mutators_route_through_checkpoint():
    """Controller state mutations MUST go through the `_checkpoint`
    write-through helper (or carry a `# serve-ckpt: exempt` annotation
    explaining why their state rebuilds elsewhere) — a mutation path
    that skips it silently widens the recovery gap. Mechanical check:
    every method known to mutate checkpointed state either calls
    self._checkpoint(...) or is annotated exempt."""
    import inspect

    mutators = [
        "deploy_application",   # apps + deployment configs
        "delete_application",   # apps
        "ensure_http_proxies",  # proxy config
        "_start_proxy_shard",   # proxy shard set
        "_start_replica",       # replica set grows
        "_check_starting",      # STARTING -> RUNNING promotion
        "_drain_replica",       # RUNNING -> DRAINING
        "_reap_draining",       # replica set shrinks
        "_reconcile",           # dead removal + scale-down
        "_autoscale",           # target count
        "preempt_node",         # drain bookkeeping (event-log rebuilt)
        "shutdown",             # checkpoint deletion (exempt)
    ]
    for name in mutators:
        src = inspect.getsource(
            getattr(controller_mod.ServeController, name))
        assert ("self._checkpoint(" in src
                or "serve-ckpt: exempt" in src), (
            f"ServeController.{name} mutates controller state without "
            f"routing through the _checkpoint write-through helper "
            f"(or a '# serve-ckpt: exempt' annotation)")


# -- stale-push (zombie incarnation) rejection --------------------------------

def test_router_rejects_stale_incarnation_pushes(runtime):
    """A long-poll reply from an OLDER controller incarnation must not
    roll the router's replica set back after a newer incarnation's push
    was applied (zombie controller racing its recovered successor)."""

    class ScriptedController:
        """Replays scripted listen_for_change replies in order, then
        parks (timeout replies with the last script entry)."""

        def __init__(self, script):
            self._script = list(script)
            self._idx = 0

        def listen_for_change(self, key, last_version, timeout=30.0):
            import time as _time

            if self._idx >= len(self._script):
                _time.sleep(0.2)
                return self._script[-1]
            reply = self._script[self._idx]
            self._idx += 1
            return reply

        def ping(self):
            return "pong"

    from ray_tpu_torch.serve._private.router import Router

    fresh = {"version": 5, "incarnation": 2,
             "replicas": [("r1", None), ("r2", None)], "metrics": {}}
    stale = {"version": 9, "incarnation": 1,  # zombie: older incarnation
             "replicas": [("dead", None)], "metrics": {}}
    ctl = rt.remote(ScriptedController).options(
        max_concurrency=8).remote([fresh, stale, fresh])
    router = Router(ctl, "d", "a")
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            with router._scheduler._lock:
                ids = sorted(r for r, _ in router._scheduler._replicas)
            if ids == ["r1", "r2"] and router._incarnation == 2:
                break
            time.sleep(0.05)
        # give the stale push a chance to (wrongly) land
        time.sleep(0.5)
        with router._scheduler._lock:
            ids = sorted(r for r, _ in router._scheduler._replicas)
        assert ids == ["r1", "r2"], \
            f"stale incarnation-1 push overwrote the replica set: {ids}"
        assert router._incarnation == 2
    finally:
        router.stop()
        rt.kill(ctl)
