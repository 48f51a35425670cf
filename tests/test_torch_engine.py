"""ray_tpu_torch InferenceEngine and sampling against the JAX package's.

Greedy token streams from the port's engine must equal the JAX engine's on
the tiny fp32 config with the same weights (carried across with
`convert.params_from_jax_numpy`). The scheduling cases of
tests/test_inference.py are run on the port too. Sampling is held on the
kept support (jax.random's draws cannot be reproduced) and exactly in greedy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import GenerationConfig as JGen
from ray_tpu.inference import InferenceEngine as JEngine
from ray_tpu.inference import sampling as jsampling
from ray_tpu.models import llama as jl
from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
from ray_tpu_torch.inference.sampling import filter_logits, sample_token
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _engine(tiny, **kw):
    _, tcfg, _, tp = tiny
    return InferenceEngine(tp, tcfg, device="cpu", **kw)


def _jax_engine(tiny, **kw):
    jcfg, _, jp, _ = tiny
    return JEngine(jp, jcfg, **kw)


@pytest.mark.parametrize("kw, prompts, max_new", [
    # one same-bucket wave: prefill and the whole decode in one run
    (dict(max_batch=4, max_len=64), [[3, 17, 42, 9], [5, 7], [1, 1, 1]], 7),
    # mixed buckets and more requests than slots: waves, decode_chunk caps
    (dict(max_batch=2, max_len=256, prefill_buckets=(8, 64, 256)),
     [[3, 1, 4], [9] * 40, [2, 7], [5] * 70, [1, 2, 3, 4, 5], [8] * 10], 5),
    (dict(max_batch=3, max_len=48, decode_chunk=4),
     [[i + 1, i + 2, i + 3] for i in range(7)], 9),
])
def test_greedy_streams_match_jax(tiny, kw, prompts, max_new):
    """The (request, token) stream, in order, equals the JAX engine's."""
    ref = list(_jax_engine(tiny, **kw).generate_stream(
        prompts, JGen(max_new_tokens=max_new)))
    out = list(_engine(tiny, **kw).generate_stream(
        prompts, GenerationConfig(max_new_tokens=max_new)))
    assert [(int(r), int(t)) for r, t in ref] == out


def test_greedy_engine_matches_naive_decode(tiny):
    _, tcfg, _, tp = tiny
    prompt, n_new = [3, 17, 42, 9], 6
    seq = list(prompt)
    for _ in range(n_new):
        logits = tl.forward(tp, torch.tensor([seq]), tcfg)
        seq.append(int(torch.argmax(logits[0, -1])))
    out = _engine(tiny, max_batch=2, max_len=64).generate(
        [prompt], GenerationConfig(max_new_tokens=n_new))
    assert out[0] == seq[len(prompt):]


def test_continuous_batching_many_requests(tiny):
    """More requests than slots: slots are recycled; every request gets
    exactly max_new_tokens tokens; results do not depend on the batch."""
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    eng = _engine(tiny, max_batch=2, max_len=64)
    out = eng.generate(prompts, GenerationConfig(max_new_tokens=4))
    assert all(len(o) == 4 for o in out)
    assert sorted(eng.free_slots) == [0, 1]
    for i, p in enumerate(prompts):
        solo = _engine(tiny, max_batch=1, max_len=64).generate(
            [p], GenerationConfig(max_new_tokens=4))
        assert solo[0] == out[i], f"request {i} differs under batching"


def test_eos_frees_slot(tiny):
    probe = _engine(tiny, max_batch=1, max_len=64).generate(
        [[5, 6, 7]], GenerationConfig(max_new_tokens=1))
    eos = probe[0][0]
    eng = _engine(tiny, max_batch=1, max_len=64)
    out = eng.generate([[5, 6, 7]],
                       GenerationConfig(max_new_tokens=16, eos_token_id=eos))
    assert out[0] == [eos]
    assert eng.free_slots == [0]


def test_prefill_bucketing(tiny):
    eng = _engine(tiny, max_batch=1, max_len=256, prefill_buckets=(8, 32, 256))
    assert [eng._bucket_for(n) for n in (5, 8, 9, 250)] == [8, 8, 32, 256]
    with pytest.raises(ValueError):
        eng._bucket_for(257)
    p = [7] * 20
    out = eng.generate([p], GenerationConfig(max_new_tokens=3))
    other = _engine(tiny, max_batch=1, max_len=256, prefill_buckets=(64, 256))
    assert other.generate([p], GenerationConfig(max_new_tokens=3)) == out


def test_mixed_bucket_prompts_match_solo_runs(tiny):
    prompts = [[3, 1, 4], [9] * 40, [2, 7], [5] * 70]
    kw = dict(max_len=256, prefill_buckets=(8, 64, 256))
    out = _engine(tiny, max_batch=4, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=4))
    for i, p in enumerate(prompts):
        solo = _engine(tiny, max_batch=1, **kw).generate(
            [p], GenerationConfig(max_new_tokens=4))
        assert solo[0] == out[i]


def test_eos_admits_waiting_request(tiny):
    """An EOS that frees the only slot admits the waiting request, and the
    stream equals the JAX engine's."""
    eos = _engine(tiny, max_batch=1, max_len=64).generate(
        [[5, 6, 7]], GenerationConfig(max_new_tokens=1))[0][0]
    kw = dict(max_batch=1, max_len=64, decode_chunk=4)
    eng = _engine(tiny, **kw)
    prompts = [[5, 6, 7], [1, 2, 3]]
    out = eng.generate(prompts,
                       GenerationConfig(max_new_tokens=16, eos_token_id=eos))
    assert out[0][-1] == eos
    assert len(out[1]) >= 1
    assert eng.free_slots == [0]
    ref = _jax_engine(tiny, **kw).generate(
        prompts, JGen(max_new_tokens=16, eos_token_id=eos))
    assert ref == out


def test_max_len_caps_generation(tiny):
    """A slot stops when its length reaches max_len - 1, as in JAX."""
    prompts = [[4] * 20, [2] * 3]
    kw = dict(max_batch=2, max_len=32)
    ref = _jax_engine(tiny, **kw).generate(prompts, JGen(max_new_tokens=30))
    out = _engine(tiny, **kw).generate(prompts,
                                       GenerationConfig(max_new_tokens=30))
    assert out == ref and len(out[0]) == 32 - 1 - 20 + 1


def test_sampled_generation_is_seeded_and_in_vocab(tiny):
    gen = GenerationConfig(max_new_tokens=6, temperature=1.5, top_k=20,
                           top_p=0.9)
    prompts = [[3, 4], [5, 6, 7]]
    a = _engine(tiny, max_batch=2, max_len=64).generate(prompts, gen)
    b = _engine(tiny, max_batch=2, max_len=64).generate(prompts, gen)
    assert a == b
    assert all(0 <= t < 128 for o in a for t in o)


def test_greedy_sampling_matches_jax():
    logits = np.random.default_rng(0).standard_normal((16, 300)).astype(
        np.float32)
    ref = np.asarray(jsampling.sample_token(jnp.asarray(logits),
                                            jax.random.PRNGKey(0)))
    out = sample_token(torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("temperature, top_k, top_p", [
    (1.0, 1, 1.0), (1.0, 3, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.5),
    (2.0, 0, 0.9), (1.0, 4, 0.8), (1.0, 0, 0.01), (1.0, 0, 0.999),
])
def test_top_k_top_p_support_matches_jax(monkeypatch, temperature, top_k,
                                          top_p):
    """The logits the JAX sampler hands to jax.random.categorical keep the
    same tokens as the port's filter. Row 0 has ties at the k-th value,
    which top-k keeps."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 12)).astype(np.float32) * 3
    logits[0] = [5, 4, 4, 4, 3, 3, 1, 0, 0, -1, -2, -3]
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                           temperature=temperature, top_k=top_k, top_p=top_p)
    kept = filter_logits(torch.from_numpy(logits) / temperature, top_k, top_p)
    np.testing.assert_array_equal(torch.isfinite(kept).numpy(),
                                  np.isfinite(seen["logits"]))
    draws = torch.stack([
        sample_token(torch.from_numpy(logits),
                     torch.Generator().manual_seed(s), temperature=temperature,
                     top_k=top_k, top_p=top_p) for s in range(50)])
    assert bool(torch.isfinite(kept.gather(1, draws.T)).all())


def test_sampling_ops():
    logits = torch.tensor([[1.0, 5.0, 2.0, 0.5]])
    assert int(sample_token(logits)[0]) == 1
    g = torch.Generator().manual_seed(0)
    assert int(sample_token(logits, g, temperature=5.0, top_k=1)[0]) == 1
    assert int(sample_token(logits, g, temperature=1.0, top_p=0.01)[0]) == 1
    toks = {int(sample_token(logits, torch.Generator().manual_seed(i),
                             temperature=2.0)[0]) for i in range(20)}
    assert toks.issubset({0, 1, 2, 3}) and len(toks) > 1
