"""The repaired dense decode of ray_tpu_torch against the JAX package.

`_decode_full` (the port's `FusedDecode` loop) must give the token block
and the executed-step count of the JAX engine's fused `lax.while_loop` on
the same cache and inputs, early exits included, while reading the device
at most once every SYNC_EVERY steps and once at the end. The repaired
cache attention (the cache contracted as stored, fp32 accumulation) must
agree with its fp32-copy plain version.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import InferenceEngine as JEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
from ray_tpu_torch.inference.engine import SYNC_EVERY
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy

PROMPTS = [[3, 17, 42, 9, 5], [5, 7], [1, 1, 1, 2]]
MAX_LEN = 32
MAX_STEPS = 24  # the JAX loop's out buffer: one compile serves every case


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


# The first JAX engine's jitted programs; they close over its model
# function and config only, so later engines of the same config take them
# over and a shape compiled once is not compiled again.
_JAX_PROGRAMS = []


def _jax_engine(jp, jcfg):
    eng = JEngine(jp, jcfg, max_batch=4, max_len=MAX_LEN)
    if not _JAX_PROGRAMS:
        _JAX_PROGRAMS.extend((eng._prefill_batch, eng._decode_full))
    eng._prefill_batch, eng._decode_full = _JAX_PROGRAMS
    return eng


def _prefilled(tiny, budget, lengths=None):
    """Both engines with PROMPTS prefilled into slots 0..2 (slot 3 free), and
    the decode inputs: (jax engine, jax cache, port engine, inputs)."""
    jcfg, tcfg, jp, tp = tiny
    prompts = PROMPTS if lengths is None else [
        [(7 * i + j) % 128 for j in range(n)] for i, n in enumerate(lengths)]
    jeng = _jax_engine(jp, jcfg)
    teng = InferenceEngine(tp, tcfg, max_batch=4, max_len=MAX_LEN,
                           device="cpu")
    n = len(prompts)
    toks = np.zeros((n, MAX_LEN), np.int64)
    lens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    slots = np.arange(n)
    cache, j_first = jeng._prefill_batch(
        jp, jeng.cache, jnp.asarray(toks, jnp.int32),
        jnp.asarray(slots, jnp.int32), jnp.asarray(lens, jnp.int32),
        jax.random.PRNGKey(1))
    t_first = teng._prefill_batch(torch.from_numpy(toks),
                                  torch.from_numpy(slots),
                                  torch.from_numpy(lens), GenerationConfig())
    np.testing.assert_array_equal(np.asarray(j_first), t_first.numpy())
    tok0 = np.zeros((4, 1), np.int64)
    tok0[:n, 0] = t_first.numpy()
    lens0 = np.zeros(4, np.int64)
    lens0[:n] = lens
    bud0 = np.zeros(4, np.int64)
    bud0[:n] = budget
    act0 = (bud0 > 0) & (lens0 + 1 < MAX_LEN)
    act0[n:] = False
    return jeng, cache, teng, (tok0, lens0, bud0, act0)


def _decode_both(tiny, budget, n_steps, eos, lengths=None):
    jcfg, _, jp, _ = tiny
    jeng, cache, teng, (tok0, lens0, bud0, act0) = _prefilled(tiny, budget,
                                                              lengths)
    _, j_out, j_exec = jeng._decode_full(
        jp, cache, jnp.asarray(tok0, jnp.int32), jnp.asarray(lens0, jnp.int32),
        jnp.asarray(bud0, jnp.int32), jnp.asarray(act0), jax.random.PRNGKey(2),
        jnp.int32(n_steps), jnp.int32(eos), max_steps=MAX_STEPS)
    t_out, t_exec = teng._decode_full(
        torch.from_numpy(tok0), torch.from_numpy(lens0),
        torch.from_numpy(bud0), torch.from_numpy(act0), n_steps, eos,
        GenerationConfig())
    return np.asarray(j_out), int(j_exec), t_out, t_exec


@pytest.mark.parametrize("budget, n_steps, eos, lengths", [
    ((20, 20, 20), 12, -1, None),   # every step runs
    ((5, 9, 0), 12, -1, None),      # budgets end it early: 9 of 12
    ((2, 3, 1), 20, -1, None),      # early, before the first host check
    ((20, 20, 20), 16, None, None),  # an EOS ends a slot (found below)
    ((30, 30, 30), 24, -1, (28, 20, 6)),  # the cache's end stops slot 0
])
def test_decode_full_matches_jax_fused_decode(tiny, budget, n_steps, eos,
                                             lengths):
    if eos is None:  # a token slot 0 emits at step 3
        eos = int(_decode_both(tiny, budget, n_steps, -1)[2][3, 0])
    j_out, j_exec, t_out, t_exec = _decode_both(tiny, budget, n_steps, eos,
                                                lengths)
    assert t_exec == j_exec
    np.testing.assert_array_equal(t_out[:t_exec], j_out[:j_exec])
    # Rows past `executed` are never read; they stay as they were: 0.
    assert not t_out[t_exec:].any()
    if budget == (5, 9, 0):
        assert t_exec == 9


@pytest.mark.parametrize("n_steps", [1, 7, 8, 9, 17, 24])
def test_decode_full_reads_the_device_once_every_k_steps(tiny, monkeypatch,
                                                        n_steps):
    """At most ceil(n_steps / SYNC_EVERY) + 1 reads of a tensor's value per
    call, counted on every way a tensor reaches the host."""
    _, _, teng, (tok0, lens0, bud0, act0) = _prefilled(tiny, (30, 30, 30))
    reads = {"n": 0}

    def counting(name):
        original = getattr(torch.Tensor, name)

        def wrapper(self, *args, **kwargs):
            reads["n"] += 1
            return original(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, wrapper)

    for name in ("__bool__", "item", "__int__", "__float__", "__index__",
                 "cpu", "tolist", "numpy"):
        counting(name)
    out, executed = teng._decode_full(
        torch.from_numpy(tok0), torch.from_numpy(lens0),
        torch.from_numpy(bud0), torch.from_numpy(act0), n_steps, -1,
        GenerationConfig())
    monkeypatch.undo()
    assert executed == n_steps
    assert reads["n"] <= math.ceil(n_steps / SYNC_EVERY) + 1, reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repaired_cache_attention_matches_the_fp32_copy(dtype):
    """_decode_attention and _cached_attention against their plain versions
    (the cache copied to fp32): fp32 to summation order, bf16 to a bf16
    ulp of the output."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=dtype)
    g = torch.Generator().manual_seed(0)
    b, t, h, kv, d = 3, 40, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    k_cache, v_cache = randn(b, t, kv, d), randn(b, t, kv, d)
    lengths = torch.tensor([39, 20, 6])
    q, k, v = randn(b, 1, h, d), randn(b, 1, kv, d), randn(b, 1, kv, d)
    got = tl._decode_attention(q, k, v, k_cache, v_cache, lengths, cfg)
    want = tl._decode_attention_plain(q, k, v, k_cache, v_cache, lengths, cfg)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got, want, **tol)
    q_block = randn(b, 5, h, d)
    got = tl._cached_attention(q_block, k_cache, v_cache, lengths - 5, cfg)
    want = tl._cached_attention_plain(q_block, k_cache, v_cache, lengths - 5,
                                      cfg)
    torch.testing.assert_close(got, want, **tol)
