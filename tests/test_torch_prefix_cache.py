"""ray_tpu_torch's prefix cache (content-addressed, ref-counted KV blocks)
against the JAX package's.

The cases of tests/test_prefix_cache.py, each run on the JAX engine and on
the port's with the same script (see `run_both` in
tests/test_torch_paged_engine.py): greedy streams identical; after every
decode wave the same block tables, lengths, prefix statistics and
preemptions; at the end the same free list, LRU order and content index.
Each case's own invariants are then checked on the port's engine.
"""

import pytest

from ray_tpu_torch.inference import GenerationConfig
from test_torch_paged_engine import one_thread, run_both, tiny_models  # noqa: F401

BLOCK = 16


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _kw(**kw):
    return {"max_batch": 4, "max_len": 128, "block_size": BLOCK,
            "decode_chunk": 4, **kw}


def _one_by_one(prompts, max_new):
    """Each prompt its own generate call, in order."""
    return lambda eng, gen_cls: [
        eng.generate([p], gen_cls(max_new_tokens=max_new))[0]
        for p in prompts]


def _assert_fully_reclaimed(eng):
    assert sorted(eng.free_slots) == list(range(eng.max_batch))
    assert eng.available_blocks() == eng.n_blocks - 1
    assert not eng.block_ref, eng.block_ref
    assert not eng.slot_blocks
    assert not eng.slot_tokens


def test_caching_on_off_identical_outputs(tiny):
    """Greedy outputs token-for-token identical with the cache cold, warm
    (prefix hits) and disabled, the copy-on-write case included."""
    shared = [3] * (2 * BLOCK + 5)
    prompts = [shared + [7, 8], shared + [9], [5] * (2 * BLOCK),
               [5] * (2 * BLOCK), [11, 4, 8]]
    warm, warm_out = run_both(tiny, _one_by_one(prompts, 10), **_kw())
    assert warm.prefix_stats["hit_requests"] >= 2
    cold, cold_out = run_both(tiny, _one_by_one(prompts, 10),
                              **_kw(enable_prefix_cache=False))
    assert warm_out == cold_out
    assert cold.prefix_stats["hit_requests"] == 0
    _assert_fully_reclaimed(warm)


def test_shared_blocks_freed_only_on_last_release(tiny):
    """Two live requests sharing a cached prefix hold its blocks at
    refcount 2; one cancelling drops them to 1; the last release parks
    them in the cache LRU."""
    shared = [7] * (2 * BLOCK)

    def script(eng, gen_cls):
        step = {"n": 0}

        def feed(_block):
            step["n"] += 1
            if step["n"] == 1:
                return [("P", shared + [9], 4)], (), False
            if step["n"] == 2:
                return [("A", shared + [1], 24),
                        ("B", shared + [2], 24)], (), False
            if step["n"] == 5:
                return [], ("A",), False
            return [], (), step["n"] > 8

        out, both = {}, None
        for rid, tok, _done in eng.serve_stream(feed, gen_cls(
                max_new_tokens=24)):
            assert tok is not None, eng.abort_reasons
            out.setdefault(rid, []).append(tok)
            if (len(out.get("A", [])) >= 1 and len(out.get("B", [])) >= 1
                    and both is None):
                # both followers decoding: the 2 prefix blocks are shared
                both = sorted(b for b, r in eng.block_ref.items() if r == 2)
                assert len(both) == 2, eng.block_ref
                assert not set(both) & (set(eng.cached_lru)
                                        | set(eng.free_blocks))
        return out, both

    eng, (out, shared_blocks) = run_both(tiny, script, **_kw())
    assert shared_blocks is not None
    assert len(out["B"]) == 24
    assert len(out.get("A", [])) < 24
    for b in shared_blocks:
        assert eng.block_ref.get(b) is None
        assert b in eng.cached_lru
    _assert_fully_reclaimed(eng)


def test_copy_on_write_preserves_cached_blocks(tiny):
    """A full-prompt match writes its sampling position into a COPY; the
    cached original keeps serving later identical prompts."""
    prompt = [5] * (2 * BLOCK)
    div = prompt[:BLOCK] + [9] * BLOCK

    def script(eng, gen_cls):
        gen = gen_cls(max_new_tokens=8)
        outs, cows = [], []
        for p in (prompt, prompt, prompt, div):
            outs.append(eng.generate([p], gen)[0])
            cows.append(eng.prefix_stats["cow_copies"])
        return outs, cows

    eng, (outs, cows) = run_both(tiny, script, **_kw())
    assert cows[:2] == [0, 1]
    assert outs[0] == outs[1] == outs[2]
    cold = run_both(tiny, _one_by_one([div], 8),
                    **_kw(enable_prefix_cache=False))[1]
    assert outs[3] == cold[0]
    _assert_fully_reclaimed(eng)


def test_eviction_under_pressure_still_admits(tiny):
    """A pool whose free list is exhausted by cached blocks evicts (LRU) to
    admit new requests; evicted content re-admits with identical output."""
    prompts = [[i] * (2 * BLOCK + 3) for i in range(1, 7)] + [
        [1] * (2 * BLOCK + 3)]
    eng, outs = run_both(tiny, _one_by_one(prompts, 6),
                         **_kw(max_batch=2, n_blocks=13))
    assert all(len(o) == 6 for o in outs)
    assert eng.prefix_stats["evictions"] > 0
    assert outs[-1] == outs[0]
    _assert_fully_reclaimed(eng)


def test_preempted_request_readmits_via_cache(tiny):
    """Recompute-preemption releases blocks through the cache, so the
    victim's re-admission is a prefix hit, and the output matches a roomy
    pool."""
    prompts = [[2, 4, 6], [1, 3, 5], [7, 8, 9]]

    def script(eng, gen_cls):
        return eng.generate(prompts, gen_cls(max_new_tokens=24))

    _, expected = run_both(tiny, script, **_kw(n_blocks=40, block_size=8))
    tight, got = run_both(tiny, script, **_kw(n_blocks=9, block_size=8))
    assert got == expected
    assert tight.preemptions > 0
    assert tight.prefix_stats["hit_requests"] > 0
    _assert_fully_reclaimed(tight)


def test_disabled_cache_keeps_flat_accounting(tiny):
    p = [4] * (3 * BLOCK)
    eng, outs = run_both(tiny, _one_by_one([p, p], 6),
                         **_kw(enable_prefix_cache=False))
    assert outs[0] == outs[1]
    assert eng.prefix_stats == {
        "hit_requests": 0, "miss_requests": 2, "hit_tokens": 0,
        "evictions": 0, "bytes_saved": 0, "cow_copies": 0}
    assert not eng.hash_index and not eng.cached_lru
    assert len(eng.free_blocks) == eng.n_blocks - 1


def test_sampled_paged_generation_is_seeded_and_in_vocab(tiny):
    """jax.random's draws cannot be reproduced in torch: sampled streams are
    held to being seeded, repeatable and in the vocabulary."""
    _, tcfg, _, tp = tiny
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

    gen = GenerationConfig(max_new_tokens=6, temperature=1.5, top_k=20,
                           top_p=0.9)
    runs = [PagedInferenceEngine(tp, tcfg, device="cpu", **_kw()).generate(
        [[3, 4], [5] * (BLOCK + 2)], gen) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < tcfg.vocab_size for o in runs[0] for t in o)
