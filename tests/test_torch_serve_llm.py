"""serve.llm over the port: `LLMEngineReplica` (built locally, outside
serve) with a `build_engine` that returns ray_tpu_torch's
PagedInferenceEngine on the CPU streams the same greedy tokens as the same
replica over the JAX engine. The replica is the JAX package's; the port
engine only has to speak its interface (serve_stream, abort_reasons,
stats, the slot and prefix counters)."""

import threading

import pytest

from ray_tpu.inference.paged_engine import PagedInferenceEngine as JPaged
from ray_tpu.serve.llm.engine import LLMEngineReplica
from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
from test_torch_paged_engine import one_thread, tiny_models  # noqa: F401

ENGINE = dict(max_batch=4, max_len=128, block_size=16, decode_chunk=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9] * 20, [9] * 20 + [3], [8] * 40]


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _replica(build):
    return LLMEngineReplica(build, default_config={"max_new_tokens": 8})


def _serve(replica):
    """Each prompt's stream in turn, then all of them at once (one thread
    each, unary); -> (streams, concurrent results)."""
    try:
        streams = [list(replica.generate_stream(p)) for p in PROMPTS]
        together = [None] * len(PROMPTS)

        def call(i):
            together[i] = replica.generate(PROMPTS[i], max_new_tokens=6)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = replica.get_stats()
    finally:
        replica.shutdown()
        replica._thread.join(timeout=30)
    assert not replica._thread.is_alive()
    return streams, together, stats


def test_replica_over_the_port_streams_the_jax_tokens(tiny):
    jcfg, tcfg, jp, tp = tiny
    port, port_together, stats = _serve(_replica(
        lambda: PagedInferenceEngine(tp, tcfg, device="cpu", **ENGINE)))
    ref, ref_together, _ = _serve(_replica(lambda: JPaged(jp, jcfg,
                                                          **ENGINE)))
    assert port == ref
    assert all(len(s) == 8 for s in port)
    # All at once the batches may form differently; greedy tokens do not
    # depend on them, and each equals the first 6 of its lone stream.
    assert port_together == ref_together == [s[:6] for s in port]
    assert stats["continuous_batching"] is True
    assert stats["engine"]["prefix_cache"]["hit_requests"] > 0
    assert stats["finished_requests"] == 2 * len(PROMPTS)
