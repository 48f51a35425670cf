"""ray_tpu_torch's paged KV cache and PagedInferenceEngine against the JAX
package's.

The cases of tests/test_paged_engine.py (and the engine-level serve_stream
case of tests/test_serve_llm.py), each run on the JAX engine and on the
port's with the same script, the tiny fp32 config and the same weights
(carried across with `convert.params_from_jax_numpy`). Logits agree to
rtol = atol = 2e-4 (fp32, summation order only); greedy streams are
identical; after every decode wave the two engines hold the same block
tables, lengths, prefix statistics, preemptions and block-pool counts, and
at the end the same free list, LRU order and content index.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import GenerationConfig as JGen
from ray_tpu.inference.paged_engine import PagedInferenceEngine as JPaged
from ray_tpu.models import llama as jl
from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


def tiny_models():
    """(JAX config, port config, JAX params, port params): tiny, fp32,
    vocab 128, no remat, as tests/test_paged_engine.py builds it."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are tiny, and where test workers
    share the cores a pool of every core in each makes the run slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def snapshot(eng):
    """What must agree between the engines after a decode wave."""
    rep = eng.kv_block_report()
    return {"table": eng.block_table.tolist(),
            "lengths": eng.lengths.tolist(),
            "prefix_stats": dict(eng.prefix_stats),
            "preemptions": eng.preemptions,
            "counts": {k: rep[k] for k in (
                "free_blocks", "cached_blocks", "active_blocks",
                "active_slots", "peak_active", "bytes_per_token")}}


def final_state(eng):
    return {**snapshot(eng), "free": list(eng.free_blocks),
            "lru": list(eng.cached_lru), "index": dict(eng.hash_index),
            "refs": dict(eng.block_ref), "slots": sorted(eng.free_slots),
            "aborts": dict(eng.abort_reasons)}


def watch_waves(eng):
    """-> a list that gets snapshot(eng) after every decode wave (each
    engine records a wave in its profiler once its slots are released)."""
    snaps, prof = [], eng.profiler

    class Watch:
        def record_step(self, *args, **kwargs):
            prof.record_step(*args, **kwargs)
            snaps.append(snapshot(eng))

        def report(self, *args, **kwargs):
            return prof.report(*args, **kwargs)

    eng.profiler = Watch()
    return snaps


# The JAX engine's jitted programs of the first engine built, by config.
# They close over the engine's model function and config only (the pool and
# every other state are arguments), so later engines of the same config
# take them over, and a shape compiled once is not compiled again.
_JAX_PROGRAMS = {}


def jax_engine(jp, jcfg, **kw):
    eng = JPaged(jp, jcfg, **kw)
    programs = _JAX_PROGRAMS.setdefault(jcfg, (
        eng._prefill_batch, eng._decode, eng._copy_blocks))
    eng._prefill_batch, eng._decode, eng._copy_blocks = programs
    return eng


def run_both(tiny, script, **kw):
    """script(engine, GenerationConfig class) on the JAX engine and on the
    port's, built with the same keywords; asserts equal results, equal
    snapshots after every wave and equal final states; -> (port engine,
    result)."""
    jcfg, tcfg, jp, tp = tiny
    runs = []
    for eng, gen_cls in ((jax_engine(jp, jcfg, **kw), JGen),
                         (PagedInferenceEngine(tp, tcfg, device="cpu", **kw),
                          GenerationConfig)):
        waves = watch_waves(eng)
        out = script(eng, gen_cls)
        runs.append((out, waves, final_state(eng), eng))
    (j_out, j_waves, j_final, _), (t_out, t_waves, t_final, eng) = runs
    assert t_out == j_out
    assert t_waves == j_waves
    assert t_final == j_final
    return eng, t_out


def generate(prompts, max_new, **gen_kw):
    return lambda eng, gen_cls: eng.generate(
        prompts, gen_cls(max_new_tokens=max_new, **gen_kw))


@pytest.mark.parametrize("table, offsets, n_valid", [
    ([[1, 2, 3, 4], [5, 6, 7, 8]], (0, 0), (12, 12)),
    # scrambled, non-monotone tables
    ([[7, 2, 5, 1], [3, 8, 4, 6]], (0, 0), (12, 12)),
    # padded tails at offsets (a prefix hit's prefill): invalid positions
    # go to the scratch block
    ([[7, 2, 5, 1], [3, 8, 4, 6]], (8, 3), (9, 4)),
])
def test_paged_forward_matches_dense_cache_and_jax(tiny, table, offsets,
                                                  n_valid):
    """Prefill and one decode step through the paged pool: the port against
    the port's dense cache and against the JAX paged path, logits and the
    pool."""
    jcfg, tcfg, jp, tp = tiny
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12))
    lens = np.asarray(offsets)
    valid = np.arange(12)[None] < np.asarray(n_valid)[:, None]
    table = np.asarray(table)
    # What the offsets stand for: positions below them hold earlier tokens.
    head = rng.integers(0, tcfg.vocab_size, (2, max(offsets)))

    pool = tl.init_paged_kv_cache(tcfg, 9, 8, device="cpu")
    dense = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    jpool = jl.init_paged_kv_cache(jcfg, 9, 8)
    zero = np.zeros(2, np.int64)
    if max(offsets):
        head_valid = np.arange(head.shape[1])[None] < lens[:, None]
        tl.forward_with_paged_cache(tp, torch.from_numpy(head), pool,
                                    torch.from_numpy(table),
                                    torch.from_numpy(zero), tcfg,
                                    valid=torch.from_numpy(head_valid))
        _, jpool = jl.forward_with_paged_cache(
            jp, jnp.asarray(head), jpool, jnp.asarray(table),
            jnp.asarray(zero, jnp.int32), jcfg, valid=jnp.asarray(head_valid))
        for row in range(2):  # the dense cache, row by row, unpadded
            tl.forward_with_cache(
                tp, torch.from_numpy(head[row:row + 1, :lens[row]]),
                {n: c[:, row:row + 1] for n, c in dense.items()},
                torch.zeros(1, dtype=torch.int64), tcfg)
    p_logits, pool = tl.forward_with_paged_cache(
        tp, torch.from_numpy(toks), pool, torch.from_numpy(table),
        torch.from_numpy(lens), tcfg, valid=torch.from_numpy(valid))
    j_logits, jpool = jl.forward_with_paged_cache(
        jp, jnp.asarray(toks), jpool, jnp.asarray(table),
        jnp.asarray(lens, jnp.int32), jcfg, valid=jnp.asarray(valid))
    d_logits = []
    for row in range(2):
        out, _ = tl.forward_with_cache(
            tp, torch.from_numpy(toks[row:row + 1, :n_valid[row]]),
            {n: c[:, row:row + 1] for n, c in dense.items()},
            torch.from_numpy(lens[row:row + 1]), tcfg)
        d_logits.append(out[0])
    for row in range(2):
        n = n_valid[row]
        np.testing.assert_allclose(p_logits[row, :n].numpy(),
                                   d_logits[row].numpy(), **TOL)
        np.testing.assert_allclose(p_logits[row, :n].numpy(),
                                   np.asarray(j_logits)[row, :n], **TOL)
    # The pool outside the scratch block (which holds whichever invalid
    # row the scatter wrote last) equals JAX's.
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name][:, 1:].numpy(),
                                   np.asarray(jpool[name])[:, 1:], **TOL)

    # one decode step on top: the pool is only read, then written once
    nxt = p_logits[np.arange(2), np.asarray(n_valid) - 1].argmax(-1)
    pos = lens + np.asarray(n_valid)
    p2, pool = tl.forward_with_paged_cache(
        tp, nxt[:, None], pool, torch.from_numpy(table),
        torch.from_numpy(pos), tcfg)
    j2, jpool = jl.forward_with_paged_cache(
        jp, jnp.asarray(nxt.numpy()[:, None], jnp.int32), jpool,
        jnp.asarray(table), jnp.asarray(pos, jnp.int32), jcfg)
    d2 = torch.stack([tl.forward_with_cache(
        tp, nxt[row:row + 1, None],
        {n: c[:, row:row + 1] for n, c in dense.items()},
        torch.from_numpy(pos[row:row + 1]), tcfg)[0][0, 0]
        for row in range(2)])
    np.testing.assert_allclose(p2[:, 0].numpy(), d2.numpy(), **TOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(j2), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name][:, 1:].numpy(),
                                   np.asarray(jpool[name])[:, 1:], **TOL)


def test_paged_pool_starts_at_zero_and_scratch_stays_finite(tiny):
    """Block 0 is read at every masked position of a gather: it starts at
    zero, and the invalid rows written there are finite."""
    _, tcfg, _, tp = tiny
    pool = tl.init_paged_kv_cache(tcfg, 5, 8, device="cpu")
    assert all(bool((x == 0).all()) for x in pool.values())
    toks = torch.tensor([[3, 4, 5, 6, 7, 8, 9, 10]])
    valid = torch.arange(8)[None] < 3
    logits, pool = tl.forward_with_paged_cache(
        tp, toks, pool, torch.tensor([[2, 0, 0, 0]]), torch.zeros(1,
                                                              dtype=int),
        tcfg, valid=valid)
    assert bool(torch.isfinite(logits).all())
    assert all(bool(torch.isfinite(x).all()) for x in pool.values())
    assert all(bool((x[:, 1] == 0).all() and (x[:, 3:] == 0).all())
               for x in pool.values())


def test_paged_engine_greedy_matches_dense_engine(tiny):
    _, tcfg, _, tp = tiny
    prompts = [[1, 5, 9, 2], [3, 3, 7], [11, 4, 8, 2, 6]]
    dense = InferenceEngine(tp, tcfg, max_batch=2, max_len=64, device="cpu")
    expected = dense.generate(prompts, GenerationConfig(max_new_tokens=12))
    _, got = run_both(tiny, generate(prompts, 12), max_batch=2, max_len=64,
                      block_size=8)
    assert got == expected


def test_eight_concurrent_streams_small_pool(tiny):
    """>= 8 concurrent ragged streams through a pool HALF the dense
    reservation."""
    prompts = [[1 + i] * (3 + 5 * (i % 4)) for i in range(12)]
    eng, out = run_both(tiny, generate(prompts, 10), max_batch=8,
                        max_len=64, block_size=8)
    assert eng.n_blocks - 1 < 8 * (64 // 8)
    assert len(out) == 12 and all(len(o) == 10 for o in out)
    assert eng.available_blocks() == eng.n_blocks - 1
    assert sorted(eng.free_slots) == list(range(8))


def test_preemption_by_recomputation(tiny):
    """A pool too small for all admitted requests preempts the youngest
    (recompute) and still produces exactly the tokens a roomy pool
    produces."""
    prompts = [[2, 4, 6], [1, 3, 5], [7, 8, 9]]
    kw = dict(max_batch=4, max_len=64, block_size=8)
    roomy, expected = run_both(tiny, generate(prompts, 24), n_blocks=40,
                               **kw)
    assert roomy.preemptions == 0
    tight, got = run_both(tiny, generate(prompts, 24), n_blocks=9, **kw)
    assert tight.preemptions > 0, "tight pool never preempted"
    assert got == expected
    assert tight.available_blocks() == tight.n_blocks - 1


def test_lone_request_shrinks_chunk_instead_of_preempting(tiny):
    eng, out = run_both(tiny, generate([[1, 2, 3]], 16), max_batch=2,
                        max_len=64, block_size=8, n_blocks=5,
                        decode_chunk=16)
    assert len(out[0]) == 16
    assert eng.preemptions == 0


def serve(feed_script):
    """A serve_stream script: feed_script(step) -> (new, cancelled, stop)
    at the step-th poll. -> [(req_id, token, done), ...]."""
    def script(eng, gen_cls):
        step = {"n": 0}

        def feed(_block):
            step["n"] += 1
            return feed_script(step["n"])

        return list(eng.serve_stream(feed, gen_cls(max_new_tokens=8)))
    return script


def test_serve_stream_dynamic_admission(tiny):
    """A request arriving mid-generation joins the running batch;
    cancellation frees its slot and blocks; everything is reclaimed
    (tests/test_serve_llm.py's engine-level case)."""
    def feed(n):
        if n == 1:
            return [("A", [1, 2, 3], 8), ("C", [9, 9], 20)], (), False
        if n == 3:
            return [("B", [4, 5], 6)], ("C",), False
        return [], (), n > 4

    eng, events = run_both(tiny, serve(feed), max_batch=4, max_len=64,
                           block_size=8, decode_chunk=2)
    out, order = {}, []
    for rid, tok, _done in events:
        assert tok is not None
        out.setdefault(rid, []).append(tok)
        order.append(rid)
    assert len(out["A"]) == 8 and len(out["B"]) == 6
    assert len(out.get("C", [])) < 20
    assert min(i for i, r in enumerate(order) if r == "B") < max(
        i for i, r in enumerate(order) if r == "A")
    assert sorted(eng.free_slots) == [0, 1, 2, 3]
    assert eng.available_blocks() == eng.n_blocks - 1
    assert eng.generate([[1, 2, 3]],
                        GenerationConfig(max_new_tokens=8))[0] == out["A"]


def test_serve_stream_aborts_what_it_cannot_serve(tiny):
    """An empty prompt, one beyond max_len and one no pool could hold are
    aborted with their reasons; the others are served."""
    def feed(n):
        if n == 1:
            return [("empty", [], None), ("long", [1] * 64, None),
                    ("huge", [2] * 40, None), ("ok", [3, 4], 5)], (), False
        return [], (), True

    eng, events = run_both(tiny, serve(feed), max_batch=2, max_len=64,
                           block_size=8, n_blocks=4)
    aborted = {rid for rid, tok, done in events if tok is None}
    assert aborted == {"empty", "long", "huge"}
    assert sum(1 for rid, tok, _ in events if rid == "ok") == 5
    assert set(eng.abort_reasons) == aborted


def test_stats_and_kv_block_report(tiny):
    eng, _ = run_both(tiny, generate([[1, 2, 3], [4, 5]], 6), max_batch=2,
                      max_len=64, block_size=8)
    stats = eng.stats()
    assert stats["prefix_cache"]["enabled"] is True
    assert stats["device_phases"]["steps"] >= 1
    assert "device_execute_frac" in stats["device_phases"]
    rep = eng.kv_block_report()
    assert (rep["free_blocks"] + rep["cached_blocks"] + rep["active_blocks"]
            == eng.n_blocks - 1)
    from ray_tpu_torch._private import kv_registry
    assert any(r is not None and r["n_blocks"] == eng.n_blocks
               for r in kv_registry.report_all())
