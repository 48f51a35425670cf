"""The port's ViT, T5 and MLP against the JAX package's, on the CPU, and
the converter's round trip of every model family.

Same numpy inputs through `ray_tpu.models.{vit,t5,mlp}` and
`ray_tpu_torch.models.{vit,t5,mlp}` in fp32, weights from the JAX `init`
carried across by `convert.params_from_jax_numpy`: logits to FWD_TOL,
losses and gradients to the training bounds of tests/test_torch_train.py,
T5's greedy tokens and the MLP's accuracy exactly.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import mixtral as jmx
from ray_tpu.models import mlp as jmlp
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mixtral as tmx
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import t5 as tt5
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import (adamw_state_from_jax_numpy,
                                          params_from_jax_numpy)
from ray_tpu_torch.train.optim import tree_leaves, tree_map

FWD_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4
VOCAB = 128


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, dtype=np.float32)}


def _assert_trees_close(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def _port_loss_and_grads(loss_fn, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _check_loss_and_grads(jloss_fn, tloss_fn, jparams, tparams, batch):
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(tloss_fn, tparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, jax.device_get(jgrads))


# -- ViT ---------------------------------------------------------------------

# ViT-B/16's image and patch (196 patches and the CLS row) at tiny width.
VIT = dict(image_size=224, patch_size=16, d_model=64, n_layers=2,
           n_heads=4, d_ff=128, num_classes=10)


def _vit_configs(**kw):
    jcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32, **kw)
    tcfg = tvit.ViTConfig(**VIT, dtype=torch.float32, **kw)
    return jcfg, tcfg


def _vit_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, 224, 224, 3)).astype(
        np.float32), "labels": rng.integers(0, 10, b)}


def test_vit_forward_matches_jax():
    jcfg, tcfg = _vit_configs(remat=False)
    jparams = jax.device_get(jvit.init(jcfg, jax.random.PRNGKey(0)))
    batch = _vit_batch()
    want = jax.jit(partial(jvit.forward, config=jcfg))(
        jparams, jnp.asarray(batch["images"]))
    params = params_from_jax_numpy(jparams, tcfg, device="cpu")
    with torch.no_grad():
        got = tvit.forward(params, torch.from_numpy(batch["images"]), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(batch["images"]), tcfg).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(batch["images"]), jcfg)))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_vit_loss_and_grads_match_jax(policy):
    jcfg, tcfg = _vit_configs(remat=True, remat_policy=policy)
    jparams = jax.device_get(jvit.init(jcfg, jax.random.PRNGKey(1)))
    _check_loss_and_grads(
        partial(jvit.loss_fn, config=jcfg),
        partial(tvit.loss_fn, config=tcfg), jparams,
        params_from_jax_numpy(jparams, tcfg, device="cpu"), _vit_batch(3))


# -- T5 ----------------------------------------------------------------------

def _t5_configs(**kw):
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=VOCAB), **kw)
    tcfg = dataclasses.replace(tt5.T5Config.tiny(vocab_size=VOCAB), **kw)
    return jcfg, tcfg


def _t5_batch(seed=0, b=3, s=20, t=12):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, VOCAB, (b, s))
    src[0, 15:] = 0  # padding, masked out of every attention over it
    src[2, 7:] = 0
    tgt = rng.integers(3, VOCAB, (b, t))
    tgt[:, 0] = 1
    tgt[1, 9:] = 0  # padded labels
    return {"src": src, "tgt": tgt}


@pytest.fixture(scope="module")
def t5_params():
    jcfg, _ = _t5_configs()
    return jax.device_get(jt5.init(jcfg, jax.random.PRNGKey(0)))


def test_t5_forward_matches_jax(t5_params):
    jcfg, tcfg = _t5_configs()
    batch = _t5_batch()
    want = jax.jit(partial(jt5.forward, config=jcfg))(
        t5_params, jnp.asarray(batch["src"]), jnp.asarray(batch["tgt"]))
    params = params_from_jax_numpy(t5_params, tcfg, device="cpu")
    with torch.no_grad():
        got = tt5.forward(params, torch.from_numpy(batch["src"]),
                          torch.from_numpy(batch["tgt"]), tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 12, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots"),
                                          (True, "full")])
def test_t5_loss_and_grads_match_jax(t5_params, remat, policy):
    jcfg, tcfg = _t5_configs(remat=remat, remat_policy=policy)
    _check_loss_and_grads(
        partial(jt5.loss_fn, config=jcfg), partial(tt5.loss_fn, config=tcfg),
        t5_params, params_from_jax_numpy(t5_params, tcfg, device="cpu"),
        _t5_batch(seed=1))


def test_t5_greedy_decode_matches_jax(t5_params):
    jcfg, tcfg = _t5_configs()
    src = _t5_batch(seed=2)["src"]
    want = np.asarray(jt5.greedy_decode(t5_params, jnp.asarray(src), jcfg,
                                        max_len=16))
    params = params_from_jax_numpy(t5_params, tcfg, device="cpu")
    got = tt5.greedy_decode(params, torch.from_numpy(src), tcfg, max_len=16)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_greedy_decode_stops_rows_at_eos(t5_params, monkeypatch):
    """A row that emits eos (2) gets pad (0) from then on, and the loop
    ends once every row has: a decoder scripted to emit eos at step 1 in
    row 0 and at step 3 in the others is called three times."""
    _, tcfg = _t5_configs()
    params = params_from_jax_numpy(t5_params, tcfg, device="cpu")
    script = torch.tensor([[2, 7, 7, 7, 7], [5, 6, 2, 7, 7], [5, 5, 2, 7, 7]])
    calls = []

    def decoder(params, enc, src_mask, tgt, config):
        calls.append(tgt.clone())
        return torch.nn.functional.one_hot(
            script[:, :tgt.shape[1]], VOCAB).float()

    monkeypatch.setattr(tt5, "forward_decoder", decoder)
    src = torch.from_numpy(_t5_batch(seed=2)["src"])
    got = tt5.greedy_decode(params, src, tcfg, max_len=5)
    assert got.tolist() == [[1, 2, 0, 0, 0], [1, 5, 6, 2, 0],
                            [1, 5, 5, 2, 0]]
    assert len(calls) == 3


# -- MLP ---------------------------------------------------------------------

def _mlp_batch(seed=0, b=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, 784)).astype(np.float32),
            "y": rng.integers(0, 10, b)}


def test_mlp_loss_grads_and_accuracy_match_jax():
    jcfg, tcfg = jmlp.MLPConfig(), tmlp.MLPConfig()
    jparams = jax.device_get(jmlp.init(jcfg, jax.random.PRNGKey(0)))
    params = params_from_jax_numpy(jparams, tcfg, device="cpu")
    batch = _mlp_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            tmlp.forward(params, tb["x"], tcfg).numpy(),
            np.asarray(jmlp.forward(jparams, jb["x"], jcfg)), rtol=FWD_TOL,
            atol=FWD_TOL)
        assert float(tmlp.accuracy(params, tb, tcfg)) == float(
            jmlp.accuracy(jparams, jb, jcfg))
    _check_loss_and_grads(partial(jmlp.loss_fn, config=jcfg),
                          partial(tmlp.loss_fn, config=tcfg), jparams,
                          params, batch)


# -- The converter, every family ---------------------------------------------

FAMILIES = {
    "llama": lambda: (jl.LlamaConfig.tiny(vocab_size=VOCAB), jl,
                      tl.LlamaConfig.tiny(vocab_size=VOCAB), tl),
    "mixtral": lambda: (jmx.MixtralConfig.tiny(vocab_size=VOCAB), jmx,
                        tmx.MixtralConfig.tiny(vocab_size=VOCAB), tmx),
    "vit": lambda: (jvit.ViTConfig.tiny(), jvit, tvit.ViTConfig.tiny(),
                    tvit),
    "t5": lambda: (jt5.T5Config.tiny(vocab_size=VOCAB), jt5,
                   tt5.T5Config.tiny(vocab_size=VOCAB), tt5),
    "mlp": lambda: (jmlp.MLPConfig(hidden=(32, 16)), jmlp,
                    tmlp.MLPConfig(hidden=(32, 16)), tmlp),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_round_trips_every_family(family):
    """JAX init -> numpy -> the port and back: every leaf in the JAX
    layout and the config's dtype, equal to the last bit (bf16 too, where
    the config is bf16); the optax.adamw state after one update likewise;
    the port's init makes the same structure and shapes."""
    jcfg, jmod, tcfg, tmod = FAMILIES[family]()
    jparams = jax.device_get(jmod.init(jcfg, jax.random.PRNGKey(0)))
    params = params_from_jax_numpy(jparams, tcfg, device="cpu")
    want = _flat(jparams)
    for name, got in _flat(params).items():
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert _flat(params).keys() == want.keys()
    assert {str(t.dtype) for t in tree_leaves(params)} == {
        str(tcfg.dtype)}
    opt = optax.adamw(1e-3)
    state = opt.init(jparams)
    grads = jax.tree_util.tree_map(lambda a: jnp.ones_like(a) * 0.5, jparams)
    _, state = opt.update(grads, state, jparams)
    adam = adamw_state_from_jax_numpy(jax.device_get(state), tcfg, "cpu")
    assert adam.count == 1
    for moment, got in (("mu", adam.mu), ("nu", adam.nu)):
        ref = _flat(getattr(jax.device_get(state[0]), moment))
        for name, arr in _flat(got).items():
            np.testing.assert_array_equal(arr, ref[name], err_msg=name)
    fresh = tmod.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in _flat(fresh).items()} == {
        k: v.shape for k, v in want.items()}
