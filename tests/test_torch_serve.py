"""The port's Serve (`ray_tpu_torch.serve`) on the port's own runtime, case
by case as tests/test_serve.py holds the JAX package's: deployments and
handles, composition, status and delete, redeploys (rolled to new code,
reconfigured in place), health-check options, `@serve.batch`,
`@serve.multiplexed`, the replica context, the HTTP proxy, config-file
deploys, the handle and HTTP microbenchmarks; and the gRPC ingress, which
the port does not have yet, refused with NotImplementedError.

One runtime for the module (`ray_tpu_torch.init`, never beside the JAX
runtime); each test deletes its applications. Deployments are defined
inside the tests, so that they travel to the replicas by value.
"""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private.rpc import find_free_port


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    serve.start()
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def serve_instance(runtime):
    serve.start()
    yield
    try:
        for app in list(serve.status()):
            serve.delete(app)
    except RuntimeError:  # a test shut serve down
        pass


def _deployments():
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    @serve.deployment
    def double(x):
        return x * 2

    @serve.deployment
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting

        def __call__(self, name):
            return f"{self.greeting}, {name}!"

    @serve.deployment
    class Calc:
        def add(self, a, b):
            return a + b

        def mul(self, a, b):
            return a * b

    @serve.deployment
    class AsyncD:
        async def __call__(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x + 100

    return {
        "class": (Echo.bind(), lambda h: h.remote({"k": 1}).result()
                  == {"echo": {"k": 1}}),
        "function": (double.bind(), lambda h: h.remote(21).result() == 42),
        "init_args": (Greeter.bind("Hello"),
                      lambda h: h.remote("world").result()
                      == "Hello, world!"),
        "methods": (Calc.bind(), lambda h: (h.add.remote(2, 3).result(),
                                            h.mul.remote(2, 3).result())
                    == (5, 6)),
        "async": (AsyncD.bind(), lambda h: h.remote(1).result() == 101),
    }


@pytest.mark.parametrize("kind", ["class", "function", "init_args",
                                  "methods", "async"])
def test_a_deployment_answers(serve_instance, kind):
    app, answers = _deployments()[kind]
    handle = serve.run(app, name=f"{kind}_app")
    assert answers(handle)


def test_num_replicas_and_status(serve_instance):
    @serve.deployment(num_replicas=2)
    class D:
        def __call__(self, x):
            import os

            return os.getpid()

    serve.run(D.bind(), name="multi")
    st = serve.status()
    assert st["multi"]["deployments"]["D"]["target_replicas"] == 2
    handle = serve.get_app_handle("multi")
    pids = {handle.remote(None).result() for _ in range(10)}
    assert len(pids) >= 1  # pow-2 may favor an idle replica


def test_composition(serve_instance):
    @serve.deployment
    class Adder:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Ingress:
        def __init__(self, adder):
            self.adder = adder

        def __call__(self, x):
            return self.adder.remote(x).result() * 10

    handle = serve.run(Ingress.bind(Adder.bind()), name="compose")
    assert handle.remote(4).result() == 50


def test_long_poll_pushes_scale_down_fast(serve_instance):
    """Routers learn replica-set changes by long-poll push: a scale-down
    reaches the router within a second (the controller's reconcile tick
    plus one RPC)."""

    @serve.deployment(num_replicas=3)
    class D:
        def __call__(self, x):
            return x

    handle = serve.run(D.bind(), name="lp_app")
    assert handle.remote(1).result() == 1
    sched = handle._router._scheduler
    deadline = time.monotonic() + 10.0
    while len(sched._replicas) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(sched._replicas) == 3

    t0 = time.monotonic()
    serve.run(D.options(num_replicas=1).bind(), name="lp_app",
              _blocking=False)
    while len(sched._replicas) != 1:
        if time.monotonic() - t0 > 5.0:
            raise AssertionError(
                f"router still sees {len(sched._replicas)} replicas")
        time.sleep(0.005)
    dt = time.monotonic() - t0
    assert dt < 1.0, f"scale-down took {dt*1e3:.0f}ms to reach the router"


def test_replica_failure_recovery(serve_instance):
    @serve.deployment(num_replicas=1)
    class Fragile:
        def __call__(self, x):
            return "ok"

    serve.run(Fragile.bind(), name="fragile")
    controller = rt.get_actor("SERVE_CONTROLLER")
    replicas = rt.get(
        controller.get_replica_handles.remote("fragile", "Fragile"))
    assert len(replicas) == 1
    rt.kill(replicas[0])
    # the reconcile loop notices the dead replica and starts a new one
    deadline = time.time() + 30
    handle = serve.get_app_handle("fragile")
    while time.time() < deadline:
        try:
            assert handle.remote(None).result(timeout_s=5) == "ok"
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("replica was not restarted")


def test_serve_batch(serve_instance):
    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def handle_batch(self, items):
            return [len(items)] * len(items)

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(Batched.bind(), name="batched")
    # four concurrent requests coalesce into batches
    responses = [handle.remote(i) for i in range(4)]
    sizes = [r.result() for r in responses]
    assert max(sizes) >= 2


def test_multiplexed(serve_instance):
    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return {"model": model_id, "loaded_at": time.time()}

        def __call__(self, req):
            model = self.get_model(req["model_id"])
            return model["model"]

    handle = serve.run(MultiModel.bind(), name="mux")
    assert handle.remote({"model_id": "a"}).result() == "a"
    assert handle.remote({"model_id": "b"}).result() == "b"


def test_http_proxy(serve_instance):
    import requests

    @serve.deployment
    class Api:
        def __call__(self, body):
            return {"got": body}

    # an ephemeral port: the proxy binds SO_REUSEPORT, and a stale
    # listener on a fixed port would take a share of the connections
    port = find_free_port()
    serve.run(Api.bind(), name="http_app", route_prefix="/api",
              http_port=port)
    r = requests.post(f"http://127.0.0.1:{port}/api", json={"x": 1},
                      timeout=10)
    assert r.status_code == 200
    assert r.json() == {"got": {"x": 1}}


def test_delete_application(serve_instance):
    @serve.deployment
    def f(x):
        return x

    serve.run(f.bind(), name="to_delete")
    assert "to_delete" in serve.status()
    serve.delete("to_delete")
    assert "to_delete" not in serve.status()


def test_serve_schema_deploy(serve_instance, tmp_path):
    """A config-file deploy (`serve/schema.py`) with a per-deployment
    override."""
    import json as _json

    from ray_tpu_torch.serve.schema import ServeDeploySchema, deploy_config

    cfg = {
        "applications": [{
            "name": "schema-app",
            "import_path": "tests.torch_serve_test_app:app",
            "route_prefix": "/sch",
            "deployments": [{"name": "Doubler", "num_replicas": 2}],
        }]
    }
    path = tmp_path / "serve.json"
    path.write_text(_json.dumps(cfg))
    schema = ServeDeploySchema.parse_file(str(path))
    assert schema.applications[0].deployments[0].num_replicas == 2
    handles = deploy_config(schema)
    h = handles["schema-app"]
    assert h.double.remote(21).result(timeout_s=60) == 42
    dep = serve.status()["schema-app"]["deployments"]["Doubler"]
    assert dep["target_replicas"] == 2


def test_serve_schema_rejects_unknown_fields():
    from ray_tpu_torch.serve.schema import ServeApplicationSchema

    with pytest.raises(ValueError):
        ServeApplicationSchema.from_dict(
            {"import_path": "x:y", "bogus": 1})


def test_get_replica_context(serve_instance):
    """A replica can read its app, deployment and replica identity;
    outside a replica the call raises."""

    @serve.deployment
    class WhoAmI:
        def __call__(self):
            ctx = serve.get_replica_context()
            return (ctx.app_name, ctx.deployment, ctx.replica_tag,
                    ctx.servable_object is self)

    handle = serve.run(WhoAmI.bind(), name="ctxapp")
    app, dep, tag, is_self = handle.remote().result()
    assert app == "ctxapp"
    assert dep == "WhoAmI"
    assert "WhoAmI" in tag
    assert is_self
    with pytest.raises(RuntimeError, match="replica"):
        serve.get_replica_context()


def test_redeploy_rolls_replicas_to_new_code(serve_instance):
    """Redeploying changed code replaces replicas one at a time with a +1
    surge: the new code takes over, and every request during the roll
    succeeds."""

    def make_app(tag):
        @serve.deployment(num_replicas=2)
        class Svc:
            def __call__(self, _x=None):
                return tag

        return Svc.bind()

    handle = serve.run(make_app("v1"), name="roll_app")
    assert handle.remote(None).result(timeout_s=60) == "v1"

    serve.run(make_app("v2"), name="roll_app")
    deadline = time.monotonic() + 60
    saw_v2 = False
    while time.monotonic() < deadline:
        out = handle.remote(None).result(timeout_s=30)
        assert out in ("v1", "v2")
        if out == "v2":
            saw_v2 = True
            outs = {handle.remote(None).result(timeout_s=30)
                    for _ in range(8)}
            if outs == {"v2"}:
                return
        time.sleep(0.2)
    assert saw_v2, "new version never served within 60s"
    raise AssertionError("old-version replicas still serving after 60s")


def test_redeploy_same_code_reconfigures_in_place(serve_instance):
    """A user_config-only redeploy reconfigures the live replica (the same
    pid before and after)."""
    import os as _os

    @serve.deployment(user_config={"factor": 2})
    class Mul:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return (x * self.factor, _os.getpid())

    handle = serve.run(Mul.bind(), name="cfg_app")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        out, pid1 = handle.remote(10).result(timeout_s=30)
        if out == 20:
            break
        time.sleep(0.1)
    assert out == 20

    serve.run(Mul.options(user_config={"factor": 5}).bind(), name="cfg_app")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        out, pid2 = handle.remote(10).result(timeout_s=30)
        if out == 50:
            assert pid2 == pid1, "replica was restarted, not reconfigured"
            return
        time.sleep(0.1)
    raise AssertionError(f"user_config change never applied (last={out})")


def test_per_deployment_health_check_options(serve_instance):
    """A replica whose health check keeps failing is replaced at the
    deployment's own health-check period."""

    @serve.deployment(health_check_period_s=0.3, health_check_timeout_s=1.0)
    class Flaky:
        def __init__(self):
            self.fail = False

        def check_health(self):
            if self.fail:
                raise RuntimeError("unhealthy")

        def poison(self):
            self.fail = True
            return "poisoned"

        def __call__(self, _x=None):
            import os

            return os.getpid()

    handle = serve.run(Flaky.bind(), name="hc_app")
    pid1 = handle.remote(None).result(timeout_s=60)
    assert handle.poison.remote().result(timeout_s=30) == "poisoned"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            pid2 = handle.remote(None).result(timeout_s=10)
            if pid2 != pid1:
                return
        except Exception:
            pass  # mid-replacement
        time.sleep(0.3)
    raise AssertionError("unhealthy replica was never replaced")


@pytest.mark.parametrize("how", ["run", "config"])
def test_the_grpc_ingress_is_not_ported_yet(serve_instance, how):
    """`serve.run(grpc_port=...)` and a config's `grpc_options` raise
    NotImplementedError, and deploy nothing."""
    from ray_tpu_torch.serve.schema import ServeDeploySchema, deploy_config

    @serve.deployment
    def f(x=None):
        return x

    with pytest.raises(NotImplementedError, match="gRPC proxy"):
        if how == "run":
            serve.run(f.bind(), name="grpc_app", grpc_port=find_free_port())
        else:
            deploy_config(ServeDeploySchema.from_dict({
                "applications": [{
                    "name": "grpc_app",
                    "import_path": "tests.torch_serve_test_app:app"}],
                "grpc_options": {"port": find_free_port()}}))
    assert "grpc_app" not in serve.status()


def test_serve_benchmarks_produce_sane_numbers(runtime):
    """The handle and HTTP microbenchmarks and the router's cost over a raw
    actor call (`serve.benchmarks.run_serve_benchmarks`), on a serve of
    their own: they start it and shut it down, so this test runs last."""
    from ray_tpu_torch.serve.benchmarks import run_serve_benchmarks

    serve.shutdown()  # its HTTP proxy on a port of the benchmark's own
    out = run_serve_benchmarks(n_requests=40, http_port=find_free_port())
    assert out["serve_handle"]["rps"] > 50
    assert out["serve_http"]["rps"] > 20
    assert out["serve_handle"]["p50_ms"] < 1000
    assert "overhead_ms" in out["router_probe_overhead"]
