"""The port's serving benchmarks against the JAX package's, over the
runtime's serve.llm on the CPU.

`benchmark_serving` and `run_prefix_ttft_benchmark` of `ray_tpu` and of
`ray_tpu_torch` run on one `ray_tpu.init` (the runtime's
`LLMEngineReplica` over each package's paged engine, the port's from the
JAX weights converted, fp32): the same result keys, the same request and
token counts (n_requests * max_new_tokens, counted on the client's
streams), and equal prefix-cache counters. The in-process stand-in of the
stack streams the replica's greedy tokens; a stack that lacks an entry
point a benchmark calls raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tpu
from ray_tpu import serve
from ray_tpu.inference.benchmarks import benchmark_serving as j_serving
from ray_tpu.models import llama as jl
from ray_tpu.serve.benchmarks import run_prefix_ttft_benchmark as j_prefix
from ray_tpu.serve.llm import build_llm_app
from ray_tpu.serve.llm.engine import LLMEngineReplica
from ray_tpu_torch.inference.benchmarks import benchmark_serving
from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy
from ray_tpu_torch.serve import (LocalServingStack, ServingStack,
                                 run_prefix_ttft_benchmark)
from ray_tpu_torch.serve.benchmarks import cpu_config

SERVING = dict(num_replicas=2, n_requests=8, arrival_rate_hz=20.0,
               max_new_tokens=6, prompt_len=8)
PREFIX = dict(n_requests=6, shared_prefix_len=64, tail_len=8)


def runtime_stack():
    return ServingStack(
        init=lambda: ray_tpu.init(num_cpus=4, ignore_reinit_error=True),
        run=serve.run, shutdown=serve.shutdown, build_llm_app=build_llm_app,
        get_actor=ray_tpu.get_actor, get=ray_tpu.get)


class _Counted:
    """A handle whose streams append their token counts to `counts`."""

    def __init__(self, handle, counts):
        self._handle, self._counts = handle, counts

    def options(self, **kw):
        inner = self._handle.options(**kw)
        counts = self._counts

        class _Stream:
            @staticmethod
            def remote(request):
                def tokens():
                    gen = inner.remote(request)
                    n = 0
                    try:
                        for tok in gen:
                            n += 1
                            yield tok
                    finally:
                        counts.append(n)
                        gen.close()
                return tokens()

        return _Stream()


@pytest.fixture
def runtime(monkeypatch):
    """The runtime with `serve.run` counting each stream's tokens; -> the
    counts."""
    counts = []
    run = serve.run
    monkeypatch.setattr(serve, "run", lambda app, **kw: _Counted(
        run(app, **kw), counts))
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    yield counts
    ray_tpu.shutdown()


def converted(jcfg, tcfg):
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    return params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def test_benchmark_serving_matches_the_jax_package(runtime):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    want = j_serving(jcfg, **SERVING)
    ref_counts = list(runtime)
    runtime.clear()
    got = benchmark_serving(tcfg, stack=runtime_stack(), device="cpu",
                            params=converted(jcfg, tcfg), **SERVING)
    assert _keys(got) == _keys(want)
    n, new = SERVING["n_requests"], SERVING["max_new_tokens"]
    warm = 2 * SERVING["num_replicas"]
    assert got["detail"]["n_requests"] == want["detail"]["n_requests"] == n
    assert sorted(runtime) == sorted(ref_counts) == [new] * (warm + n)
    assert sum(runtime[-n:]) == n * new
    for k in ("num_replicas", "arrival_rate_hz", "max_new_tokens"):
        assert got["detail"][k] == want["detail"][k]
    assert got["detail"]["platform"] == want["detail"]["platform"] == "cpu"
    assert got["value"] > 0 and got["detail"]["tokens_per_sec"] > 0


def test_prefix_ttft_matches_the_jax_package(runtime):
    want = j_prefix(**PREFIX)["llm_prefix_ttft"]
    cfg = dataclasses.replace(cpu_config(), dtype=torch.float32)
    jcfg = jl.LlamaConfig(vocab_size=512, d_model=256, n_layers=4,
                          n_heads=8, n_kv_heads=4, d_head=32, d_ff=512,
                          max_seq_len=1024)
    got = run_prefix_ttft_benchmark(
        stack=runtime_stack(), device="cpu", config=cfg,
        params=converted(jcfg, cfg), **PREFIX)["llm_prefix_ttft"]
    assert _keys(got) == _keys(want)
    for k in ("hit_requests", "miss_requests", "hit_tokens", "evictions"):
        assert got["cache"][k] == want["cache"][k], k
    assert got["cache"]["hit_requests"] >= PREFIX["n_requests"]
    assert got["cache"]["miss_requests"] >= PREFIX["n_requests"]
    assert got["cache"]["evictions"] > 0  # the pool of 4 * 8 blocks fills
    assert (got["shared_prefix_len"], got["n_requests"]) == (
        want["shared_prefix_len"], want["n_requests"])


def test_the_stand_in_streams_the_replica_tokens():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    params = converted(jcfg, tcfg)
    engine = dict(max_batch=4, max_len=128, block_size=16, decode_chunk=4,
                  device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9] * 20, [9] * 20 + [3], [8] * 40]
    replica = LLMEngineReplica(
        lambda: PagedInferenceEngine(params, tcfg, **engine),
        default_config={"max_new_tokens": 8})
    try:
        want = [list(replica.generate_stream(p)) for p in prompts]
    finally:
        replica.shutdown()
        replica._thread.join(timeout=30)
    stack = LocalServingStack()
    app = stack.build_llm_app(
        lambda: PagedInferenceEngine(params, tcfg, **engine), name="llm",
        num_replicas=2, default_config={"max_new_tokens": 8})
    stream = stack.run(app, name="llm").options(method_name="stream_tokens",
                                                stream=True)
    try:
        got = [list(stream.remote({"prompt": p})) for p in prompts]
        short = stream.remote({"prompt": prompts[0], "max_new_tokens": 3})
        assert list(short) == want[0][:3]
        cut = stream.remote({"prompt": prompts[4]})
        assert next(iter(cut)) == want[4][0]
        cut.close()  # cancels the request in its engine
        replicas = stack.apps["llm"]
        stats = [r.get_stats() for r in replicas]
    finally:
        stack.shutdown()
    assert got == want and all(len(s) == 8 for s in got)
    assert sum(s["finished_requests"] for s in stats) == len(prompts) + 1
    assert not any(r._thread.is_alive() for r in replicas)


def _stack(**missing):
    """A ServingStack whose entry points all do nothing, but `missing`."""
    fields = dict(init=lambda: None, run=lambda *a, **k: None,
                  shutdown=lambda: None,
                  build_llm_app=lambda *a, **k: None,
                  get_actor=lambda name: None, get=lambda *a, **k: None)
    fields.update(missing)
    return ServingStack(**fields)


# Without a stack the benchmarks run on the port's own serve
# (tests/test_torch_serve_llm_runtime.py); a stack without the entry points
# a benchmark calls raises, naming them.
@pytest.mark.parametrize("call", [
    lambda: benchmark_serving(stack=_stack(build_llm_app=None),
                              device="cpu"),
    lambda: run_prefix_ttft_benchmark(stack=_stack(get_actor=None, get=None),
                                      device="cpu"),
    lambda: run_prefix_ttft_benchmark(stack=_stack(run=None), device="cpu")],
    ids=["serving", "prefix", "prefix-without-run"])
def test_a_call_without_a_stack_raises(call):
    with pytest.raises(TypeError, match="stack has no"):
        call()


def test_chip_smoke_phase_r_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only r` with the card stubbed (as
    tests/test_torch_flash_sm90.py rehearses main()): the serving
    benchmarks on the port's own serve over the port's runtime (one faked
    card, each engine replica a `num_gpus` actor in its own process), on
    the reference's CPU prefix configuration (fp32) in place of Llama-3-8B,
    which reaches the replicas as a value; (r-1) at 8 requests, (r-2) at
    its defaults; every request's stream, the drained engines, one
    prompt's tokens from a replica against the driver's copy, each replica
    process's KV gauge and phase histogram checked; no flash kernel
    launched; the [phases] line; the last line is the ok object."""
    import json
    import os

    from ray_tpu_torch._private.accelerators import nvidia
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    cfg = dataclasses.replace(cpu_config(), dtype=torch.float32)
    monkeypatch.setattr(tl.LlamaConfig, "llama3_8b", staticmethod(
        lambda: cfg))
    monkeypatch.setattr(smoke, "SERVING_BENCH", dict(
        num_replicas=2, n_requests=8, arrival_rate_hz=20.0,
        max_new_tokens=12, prompt_len=8))
    fake = nvidia.GpuInfo(1, ("NVIDIA H100 80GB HBM3",), (85899345920,))
    monkeypatch.setattr(smoke, "RUNTIME_INIT", dict(
        num_cpus=4, resources={"GPU": 1}, _gpu_info=fake))
    # the replicas ask for their share of the faked card, as on the card
    from ray_tpu_torch.inference import benchmarks as ib
    monkeypatch.setattr(ib, "replica_options",
                        lambda dev, n: {"num_gpus": 1.0 / n})
    # the phase puts the checkout on PYTHONPATH for its workers
    monkeypatch.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
    assert smoke.main(["--only", "r"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[r-0] (NVIDIA H100 80GB HBM3, 700.00 W) a prefill wave",
                "[r-1] (NVIDIA H100 80GB HBM3, 700.00 W) benchmark_serving "
                "on the port's serve",
                "[r-1] (NVIDIA H100 80GB HBM3, 700.00 W) one 40-token prompt",
                "[r-2]", "[r-3]", "[phases] seconds by phase {'a': "):
        assert any(line.startswith(tag) for line in lines), tag
    assert any(line.startswith("[r] launches of the flash kernels") and
               "'flash_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0" in line
               for line in lines)
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    out = json.loads(lines[-2])["serving_bench"]
    assert out["serving"]["detail"]["n_requests"] == 8
    assert len(out["tokens"]) == 12
    assert out["replica_flash_launches"] == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert len(out["requests_by_replica"]) == 2
    assert all(n > 0 for n in out["requests_by_replica"])
    assert out["prefix"]["cache"]["hit_requests"] >= 6
    assert out["prefix"]["hit_over_cold"] < 1
    assert set(out["phase_report"]) == {"profiler", "steps", "fracs"}
    assert out["phases_observed"] > 0
    assert set(out["prefill_ms"]) == {"456@0", "8@448"}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
