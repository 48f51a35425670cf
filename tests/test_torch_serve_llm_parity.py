"""The port's serve.llm on the port's runtime against the JAX package's
serve.llm on the JAX runtime, and the serving benchmarks' default stack.

The same prompts go through JAX `serve.llm` over the JAX paged engine on
`ray_tpu.init`, then through the port's `serve.llm` over the port's paged
engine on `ray_tpu_torch.init`, with the JAX weights converted by
`models/convert.py` (tiny, fp32): every stream's greedy tokens are equal.
The two runtimes run one after the other, never at once. Without a
`stack=`, `benchmark_serving` and `run_prefix_ttft_benchmark` run on the
port's own serve.
"""

import threading

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.inference.paged_engine import PagedInferenceEngine as JPaged
from ray_tpu_torch.inference.benchmarks import PagedEngineBuilder
from test_torch_paged_engine import tiny_models

ENGINE = dict(max_batch=4, max_len=128, block_size=16, decode_chunk=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9] * 20, [9] * 20 + [3], [8] * 40]


def _streams(api, serve, build_llm_app, build):
    """Each prompt's stream through a 1-replica serve.llm app of `build`,
    one after another, then all at once (one thread each); the runtime is
    started and stopped here."""
    api.init(num_cpus=4)
    try:
        app = build_llm_app(build, name="llm", num_replicas=1,
                            default_config={"max_new_tokens": 8})
        stream = serve.run(app, name="llm").options(
            method_name="stream_tokens", stream=True)
        alone = [list(stream.remote({"prompt": p})) for p in PROMPTS]
        together = [None] * len(PROMPTS)

        def call(i):
            together[i] = list(stream.remote({"prompt": PROMPTS[i],
                                              "max_new_tokens": 6}))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        serve.shutdown()
    finally:
        api.shutdown()
    return alone, together


def test_the_port_serve_llm_streams_the_jax_serve_llm_tokens():
    from ray_tpu import serve as jserve
    from ray_tpu.serve.llm import build_llm_app as jbuild_llm_app
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_app

    jcfg, tcfg, jp, tp = tiny_models()
    want, want_together = _streams(
        ray_tpu, jserve, jbuild_llm_app, lambda: JPaged(jp, jcfg, **ENGINE))
    got, got_together = _streams(
        rt, serve, build_llm_app,
        PagedEngineBuilder(tcfg, "cpu", ENGINE, params=tp))
    assert got == want
    assert all(len(s) == 8 for s in got)
    # all at once the batches may form otherwise; greedy tokens do not
    # depend on them
    assert got_together == want_together == [s[:6] for s in got]


def test_the_benchmarks_default_to_the_port_s_serve():
    """No `stack=`: both benchmarks start the port's runtime and its serve
    (`serve.default_stack()`), and answer every request."""
    import dataclasses

    import torch

    from ray_tpu_torch.inference.benchmarks import benchmark_serving
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.benchmarks import run_prefix_ttft_benchmark

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    try:
        res = benchmark_serving(cfg, device="cpu", num_replicas=2,
                                n_requests=4, arrival_rate_hz=20.0,
                                max_new_tokens=4)
        pre = run_prefix_ttft_benchmark(
            n_requests=2, shared_prefix_len=32, device="cpu",
            config=dataclasses.replace(cfg, max_seq_len=128))
        assert rt.is_initialized()
    finally:
        rt.shutdown()
    assert res["detail"]["n_requests"] == 4 and res["value"] > 0
    assert res["detail"]["platform"] == "cpu"
    pc = pre["llm_prefix_ttft"]["cache"]
    assert pc["hit_requests"] >= 2 and pc["miss_requests"] >= 2
