"""ray_tpu_torch Llama against the JAX package's Llama, on the CPU.

Weights come from the JAX `llama.init` and are carried across with
`convert.params_from_jax_numpy` (torch cannot reproduce `jax.random`);
tokens come from numpy with a seed. The port runs with device="cpu", where
attention takes the flash kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax_numpy

# fp32 on both sides, the same arithmetic in another order (blocked
# attention, another matmul library): the bound tests/test_inference.py
# uses between the cache path and the full forward.
TOL = dict(rtol=2e-4, atol=2e-4)


def _configs(dtype=np.float32, vocab=128):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=vocab),
                               dtype=jnp.dtype(dtype), remat=False)
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=vocab),
        dtype=torch.float32 if dtype == np.float32 else torch.bfloat16)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs()
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("name", ["llama3_8b", "tiny", "small_1b"])
def test_configs_match_jax(name):
    jcfg, tcfg = getattr(jl.LlamaConfig, name)(), getattr(
        tl.LlamaConfig, name)()
    for field in dataclasses.fields(tcfg):
        if field.name != "dtype":
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert tcfg.num_params() == jcfg.num_params()
    assert tl.flops_per_token(tcfg, 2048) == jl.flops_per_token(jcfg, 2048)


@pytest.mark.parametrize("name", ["llama3_8b", "tiny"])
def test_param_shapes_match_jax_init(name):
    jcfg, tcfg = getattr(jl.LlamaConfig, name)(), getattr(
        tl.LlamaConfig, name)()
    shapes = jax.eval_shape(lambda k: jl.init(jcfg, k), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert tl.param_shapes(tcfg) == want


def test_init_fan_in_scaling():
    _, tcfg = _configs()
    p = tl.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    c = tcfg
    assert torch.equal(p["final_norm"], torch.ones(c.d_model))
    assert torch.equal(p["layers"]["attn_norm"], torch.ones(c.n_layers,
                                                            c.d_model))
    for w, fan_in in [(p["embed"], c.d_model), (p["layers"]["wq"], c.d_model),
                      (p["layers"]["wo"], c.n_heads * c.d_head),
                      (p["layers"]["w_down"], c.d_ff),
                      (p["lm_head"], c.d_model)]:
        # std of >= 16k normal draws is within 3% of its value.
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.03
    again = tl.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["wk"], p["layers"]["wk"])


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9))
    np.testing.assert_allclose(
        tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-5, atol=1e-6)
    # Angles reach 4096 rad, where fp32 sin/cos of two libraries differ by
    # a few ulps of the angle.
    np.testing.assert_allclose(
        tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0),
        np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        rtol=1e-4, atol=1e-4)


def test_forward_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens((2, 12), tcfg.vocab_size)
    ref = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    out = tl.forward(tp, torch.from_numpy(toks), tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 12, 128)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_forward_with_cache_matches_jax(tiny):
    """Prefill 8 tokens, then decode 4 one by one: logits and the cache."""
    jcfg, tcfg, jp, tp = tiny
    toks = _tokens((2, 12), tcfg.vocab_size, seed=2)
    jc = jl.init_kv_cache(jcfg, 2, 32)
    tc = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    a, jc = jl.forward_with_cache(jp, jnp.asarray(toks[:, :8]), jc,
                                  jnp.zeros(2, jnp.int32), jcfg)
    b, tc = tl.forward_with_cache(tp, torch.from_numpy(toks[:, :8]), tc,
                                  torch.zeros(2, dtype=torch.int64), tcfg)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for i in range(8, 12):
        a, jc = jl.forward_with_cache(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                      jnp.full(2, i, jnp.int32), jcfg)
        b, tc = tl.forward_with_cache(tp, torch.from_numpy(toks[:, i:i + 1]),
                                      tc, torch.full((2,), i), tcfg)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_cache_parity_with_full_forward(tiny):
    """The port's own prefill+decode logits match its full forward."""
    _, tcfg, _, tp = tiny
    toks = torch.from_numpy(_tokens((2, 12), tcfg.vocab_size, seed=3))
    full = tl.forward(tp, toks, tcfg)
    cache = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    logits, cache = tl.forward_with_cache(tp, toks[:, :8], cache,
                                          torch.zeros(2, dtype=torch.int64),
                                          tcfg)
    np.testing.assert_allclose(logits.numpy(), full[:, :8].numpy(), **TOL)
    for i in range(8, 12):
        step, cache = tl.forward_with_cache(tp, toks[:, i:i + 1], cache,
                                            torch.full((2,), i), tcfg)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                   **TOL)


def test_decode_at_full_cache_writes_nothing(tiny):
    """A row whose length is already the cache size drops its write, as
    JAX's mode="drop" scatter does; other rows write at their length."""
    _, tcfg, _, tp = tiny
    cache = tl.init_kv_cache(tcfg, 2, 4, device="cpu")
    cache["k"].fill_(3.0)
    before = cache["k"].clone()
    tl.forward_with_cache(tp, torch.tensor([[5], [6]]), cache,
                          torch.tensor([4, 1]), tcfg)
    assert torch.equal(cache["k"][:, 0], before[:, 0])
    assert not torch.equal(cache["k"][:, 1, 1], before[:, 1, 1])
    assert torch.equal(cache["k"][:, 1, 2:], before[:, 1, 2:])


def test_forward_bf16_matches_jax():
    """bf16 weights and activations: the two frameworks round at the same
    cast points but compute some elementwise ops (silu, the residual adds)
    at other internal precisions, so logits differ by about 1% of their
    norm at two layers; a wrong mask or layout differs by ~100%."""
    jcfg, tcfg = _configs(dtype=jnp.bfloat16)
    jp = jl.init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(jax.device_get(jp), tcfg, device="cpu")
    toks = _tokens((2, 24), tcfg.vocab_size, seed=5)
    ref = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    out = tl.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 3e-2


def test_convert_is_exact_for_bf16_and_checks_shapes():
    jcfg, tcfg = _configs(dtype=jnp.bfloat16)
    tree = jax.device_get(jl.init(jcfg, jax.random.PRNGKey(1)))
    tp = params_from_jax_numpy(tree, tcfg, device="cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["wq"].float().numpy(),
                                  tree["layers"]["wq"].astype(np.float32))
    tree["layers"]["wo"] = tree["layers"]["wo"][:1]
    with pytest.raises(ValueError, match="layers/wo"):
        params_from_jax_numpy(tree, tcfg, device="cpu")
