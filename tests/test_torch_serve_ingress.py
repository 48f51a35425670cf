"""The port's Serve ingress, case by case as tests/test_serve_ingress.py
holds the JAX package's: a generator deployment streamed through a handle
and as chunked HTTP, and an ASGI app (hand-written, and FastAPI where it
is installed) served through `@serve.ingress`; and the sustained-load
HTTP benchmark. One runtime of the port for the module; the proxy needs
`aiohttp`.
"""

import json
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private.rpc import find_free_port


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture
def serve_shutdown(runtime):
    yield
    serve.shutdown()


def _http_get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_streaming_handle(serve_shutdown):
    @serve.deployment
    def counter(n):
        for i in range(int(n)):
            yield i * 10

    handle = serve.run(counter.bind(), name="stream_h",
                       route_prefix="/stream_h")
    assert list(handle.options(stream=True).remote(4)) == [0, 10, 20, 30]


def test_streaming_http_chunks(serve_shutdown):
    @serve.deployment
    def gen(arg):
        for i in range(3):
            yield {"i": i}

    serve.run(gen.bind(), name="stream_app", route_prefix="/gen",
              http_port=(port := find_free_port()))
    status, body = _http_get(f"http://127.0.0.1:{port}/gen")
    assert status == 200
    lines = [json.loads(ln) for ln in body.decode().splitlines() if ln]
    assert lines == [{"i": 0}, {"i": 1}, {"i": 2}]


def test_asgi_ingress_minimal_app(serve_shutdown):
    """A hand-written ASGI app (no framework) served via @serve.ingress."""

    async def tiny_asgi(scope, receive, send):
        assert scope["type"] == "http"
        event = await receive()
        body = event.get("body", b"")
        payload = json.dumps({
            "path": scope["path"],
            "method": scope["method"],
            "echo": body.decode() if body else None,
        }).encode()
        await send({"type": "http.response.start", "status": 201,
                    "headers": [(b"content-type", b"application/json"),
                                (b"x-custom", b"yes")]})
        await send({"type": "http.response.body", "body": payload})

    @serve.deployment
    @serve.ingress(tiny_asgi)
    class Api:
        pass

    serve.run(Api.bind(), name="asgi_app", route_prefix="/api",
              http_port=(port := find_free_port()))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/hello?x=1", data=b"ping",
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 201
        assert r.headers["x-custom"] == "yes"
        out = json.loads(r.read())
    assert out["path"] == "/hello"
    assert out["method"] == "POST"
    assert out["echo"] == "ping"


def test_fastapi_ingress(serve_shutdown):
    fastapi = pytest.importorskip("fastapi")

    app = fastapi.FastAPI()

    @app.get("/hello")
    def hello():
        return {"msg": "hi"}

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass

    serve.run(Api.bind(), name="fastapi_app", route_prefix="/f",
              http_port=(port := find_free_port()))
    status, body = _http_get(f"http://127.0.0.1:{port}/f/hello")
    assert status == 200
    assert json.loads(body) == {"msg": "hi"}


def test_sustained_benchmark_finds_a_rate_it_holds(runtime):
    """`run_sustained_benchmark`'s search over open-loop offered load
    through the sharded proxy, at a p99 bound a loaded CPU host meets:
    a held rate, with its latencies and the proxy's shard count."""
    from ray_tpu_torch.serve.benchmarks import run_sustained_benchmark

    out = run_sustained_benchmark(target_p99_ms=2000.0, duration_s=0.5,
                                  num_shards=2, num_replicas=1,
                                  http_port=find_free_port())
    res = out["serve_http_sustained"]
    assert res["rps"] > 0 and res["p99_ms"] <= 2000.0
    assert res["num_shards"] == 2 and res["num_replicas"] == 1
    assert "target_unreachable" not in res
