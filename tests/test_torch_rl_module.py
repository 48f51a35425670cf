"""The port's RL modules against the JAX package's, on the CPU.

Each JAX module class of `ray_tpu.rllib.rl_module` and its port in
`ray_tpu_torch.rllib.rl_module` see the same seeded numpy inputs; the
parameters come from the JAX `init`, carried across by
`ray_tpu_torch.rllib.convert`. fp32 outputs agree to ATOL; argmax actions
exactly. The Nature CNN runs at full width on [2, 84, 84, 4] uint8 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import rl_module as jrl
from ray_tpu.rllib.catalog import Catalog as JaxCatalog
from ray_tpu_torch.rllib import rl_module as trl
from ray_tpu_torch.rllib.catalog import Catalog
from ray_tpu_torch.rllib.convert import (adam_state_from_jax_numpy,
                                         adam_state_to_jax_layout,
                                         load_jax_numpy, state_from_jax_numpy,
                                         to_jax_layout)
from ray_tpu_torch.rllib.envs import Box, Discrete

ATOL = 1e-5
BATCH = 8


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ported(jax_module, port_cls, *args, key=0, **kwargs):
    """(JAX params as numpy, the port module on the CPU with them)."""
    params = jax.device_get(jax_module.init(jax.random.PRNGKey(key)))
    module = port_cls(*args, device="cpu", **kwargs)
    return params, load_jax_numpy(module, params)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=0,
                               atol=atol)


def _obs(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


# (name, JAX module, port class, constructor args, obs)
ACTOR_CRITICS = [
    ("mlp", lambda: jrl.DiscreteActorCriticModule(4, 2),
     lambda: trl.DiscreteActorCriticModule(4, 2, device="cpu"),
     lambda: _obs((BATCH, 4))),
    ("mlp_wide", lambda: jrl.DiscreteActorCriticModule(7, 5, (32, 16, 8)),
     lambda: trl.DiscreteActorCriticModule(7, 5, (32, 16, 8), device="cpu"),
     lambda: _obs((BATCH, 7), 1)),
    ("nature_cnn_84x84x4_uint8",
     lambda: jrl.ConvActorCriticModule((84, 84, 4), 6),
     lambda: trl.ConvActorCriticModule((84, 84, 4), 6, device="cpu"),
     lambda: _obs((2, 84, 84, 4), 2, np.uint8)),
    ("small_cnn_float",
     lambda: jrl.ConvActorCriticModule((16, 12, 3), 4,
                                       ((8, 3, 2), (16, 3, 1)), (32,)),
     lambda: trl.ConvActorCriticModule((16, 12, 3), 4,
                                       ((8, 3, 2), (16, 3, 1)), (32,),
                                       device="cpu"),
     lambda: _obs((BATCH, 16, 12, 3), 3)),
]


@pytest.fixture(params=ACTOR_CRITICS, ids=[c[0] for c in ACTOR_CRITICS])
def actor_critic(request):
    _, jax_fn, port_fn, obs_fn = request.param
    jm = jax_fn()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = load_jax_numpy(port_fn(), params)
    obs = obs_fn()
    actions = np.random.default_rng(9).integers(
        0, jm.num_actions, len(obs)).astype(np.int32)
    return jm, params, tm, obs, actions


def test_actor_critic_forward(actor_critic):
    jm, params, tm, obs, _ = actor_critic
    logits, value = jm.forward(params, obs)
    with torch.no_grad():
        t_logits, t_value = tm(_t(obs))
    assert t_value.shape == (len(obs),)
    _close(t_logits, logits)
    _close(t_value, value)


def test_actor_critic_forward_train(actor_critic):
    jm, params, tm, obs, actions = actor_critic
    want = jm.forward_train(params, {"obs": obs, "actions": actions})
    with torch.no_grad():
        got = tm.forward_train({"obs": _t(obs), "actions": _t(actions)})
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_actor_critic_forward_inference(actor_critic):
    jm, params, tm, obs, _ = actor_critic
    want = jm.forward_inference(params, {"obs": obs})["actions"]
    with torch.no_grad():
        got = tm.forward_inference({"obs": _t(obs)})["actions"]
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_actor_critic_exploration_logp_and_values(actor_critic):
    """torch cannot draw jax.random's actions; for the actions it draws,
    its logp and value predictions are the JAX module's."""
    jm, params, tm, obs, _ = actor_critic
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        out = tm.forward_exploration({"obs": _t(obs)}, g)
    actions = out["actions"].numpy()
    assert actions.dtype == np.int64
    assert ((0 <= actions) & (actions < jm.num_actions)).all()
    want = jm.forward_train(params, {"obs": obs,
                                     "actions": actions.astype(np.int32)})
    _close(out["logp"], want["logp"])
    _close(out["vf_preds"], want["vf_preds"])
    # the same generator state draws the same actions
    with torch.no_grad():
        again = tm.forward_exploration({"obs": _t(obs)},
                                       torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(again["actions"].numpy(), actions)


def test_exploration_draws_follow_the_softmax():
    """The Gumbel-max draw is a categorical draw: over many rows the
    frequencies match softmax(logits)."""
    tm = trl.DiscreteActorCriticModule(3, 4, (8,), device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(0))
    with torch.no_grad():
        tm.pi.weight.zero_()
        tm.pi.bias.copy_(torch.tensor([0.0, 1.0, 2.0, -1.0]))
    obs = torch.zeros((20000, 3))
    with torch.no_grad():
        a = tm.forward_exploration({"obs": obs},
                                   torch.Generator().manual_seed(1))
    freq = np.bincount(a["actions"].numpy(), minlength=4) / 20000
    want = torch.softmax(tm.pi.bias, 0).detach().numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)


@pytest.mark.parametrize("obs_dim,num_actions,hiddens",
                         [(4, 2, (64, 64)), (6, 3, (16,))])
def test_q_module(obs_dim, num_actions, hiddens):
    jm = jrl.QModule(obs_dim, num_actions, hiddens)
    params, tm = _ported(jm, trl.QModule, obs_dim, num_actions, hiddens)
    obs = _obs((BATCH, obs_dim), 4)
    with torch.no_grad():
        _close(tm(_t(obs)), jm.forward(params, obs))


@pytest.mark.parametrize("hiddens", [(256, 256), (32,)])
def test_gaussian_actor(hiddens):
    jm = jrl.GaussianActorModule(3, 2, hiddens)
    params, tm = _ported(jm, trl.GaussianActorModule, 3, 2, hiddens)
    obs = _obs((BATCH, 3), 5) * 3
    key = jax.random.PRNGKey(7)
    act, logp = jm.sample(params, obs, key)
    eps = _np(jax.random.normal(key, (BATCH, 2)))
    with torch.no_grad():
        t_act, t_logp = tm(_t(obs), _t(eps))
        mu, log_std = tm.dist(_t(obs))
        inf = tm.forward_inference({"obs": _t(obs)})["actions"]
    j_mu, j_log_std = jm._dist(params, obs)
    _close(mu, j_mu)
    _close(log_std, j_log_std)
    _close(t_act, act)
    _close(t_logp, logp)
    _close(inf, jm.forward_inference(params, {"obs": obs})["actions"])
    with torch.no_grad():
        out = tm.forward_exploration({"obs": _t(obs)},
                                     torch.Generator().manual_seed(0))
    assert out["actions"].abs().max() <= 1 and out["vf_preds"].eq(0).all()


def test_gaussian_actor_log_std_bounds():
    jm = jrl.GaussianActorModule(2, 1, (8,), log_std_bounds=(-1.0, 0.5))
    params, tm = _ported(jm, trl.GaussianActorModule, 2, 1, (8,),
                         log_std_bounds=(-1.0, 0.5))
    params["log_std"]["b"] = np.full((1,), 5.0, np.float32)
    load_jax_numpy(tm, params)
    with torch.no_grad():
        _, log_std = tm.dist(torch.zeros((2, 2)))
    np.testing.assert_array_equal(log_std.numpy(), 0.5)


@pytest.mark.parametrize("hiddens", [(256, 256), (16, 8)])
def test_continuous_q_module(hiddens):
    jm = jrl.ContinuousQModule(3, 2, hiddens)
    params, tm = _ported(jm, trl.ContinuousQModule, 3, 2, hiddens)
    obs, act = _obs((BATCH, 3), 6), np.tanh(_obs((BATCH, 2), 7))
    with torch.no_grad():
        _close(tm(_t(obs), _t(act)), jm.forward(params, obs, act))


DICT_SPEC = {"kind": "concat", "container": "dict", "leaves": [
    ("img", {"kind": "flatten", "obs_dim": 6}),
    ("pos", {"kind": "onehot", "n": 5})]}
TUPLE_SPEC = {"kind": "concat", "container": "tuple", "leaves": [
    (0, {"kind": "onehot", "n": 3}), (1, {"kind": "flatten", "obs_dim": 4})]}


def _encoded_obs(spec, seed):
    rng = np.random.default_rng(seed)
    if spec["kind"] == "onehot":
        return rng.integers(0, spec["n"], BATCH)
    if spec["kind"] == "flatten":
        return rng.standard_normal((BATCH, 2, 3)).astype(np.float32)
    if spec["container"] == "dict":
        return {"img": rng.standard_normal((BATCH, 2, 3)).astype(np.float32),
                "pos": rng.integers(0, 5, BATCH)}
    return (rng.integers(0, 3, BATCH),
            rng.standard_normal((BATCH, 4)).astype(np.float32))


def _to_torch(obs):
    if isinstance(obs, dict):
        return {k: _t(v) for k, v in obs.items()}
    if isinstance(obs, tuple):
        return tuple(_t(v) for v in obs)
    return _t(obs)


ENCODERS = [{"kind": "onehot", "n": 7},
            {"kind": "flatten", "obs_dim": 6, "obs_shape": (2, 3)},
            DICT_SPEC, TUPLE_SPEC]


@pytest.mark.parametrize("spec", ENCODERS,
                         ids=["onehot", "flatten", "dict", "tuple"])
def test_apply_encoder(spec):
    obs = _encoded_obs(spec, 0)
    want = jrl.apply_encoder(spec, obs)
    got = trl.apply_encoder(spec, _to_torch(obs))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("spec", ENCODERS,
                         ids=["onehot", "flatten", "dict", "tuple"])
def test_encoded_actor_critic_and_q(spec):
    obs = _encoded_obs(spec, 1)
    jm = jrl.EncodedActorCriticModule(spec, 3, (16,))
    params, tm = _ported(jm, trl.EncodedActorCriticModule, spec, 3, (16,))
    actions = np.arange(BATCH, dtype=np.int32) % 3
    want = jm.forward_train(params, {"obs": obs, "actions": actions})
    with torch.no_grad():
        got = tm.forward_train({"obs": _to_torch(obs),
                                "actions": _t(actions)})
    for k in want:
        _close(got[k], want[k])
    jq = jrl.EncodedQModule(spec, 3, (16,))
    qparams, tq = _ported(jq, trl.EncodedQModule, spec, 3, (16,))
    with torch.no_grad():
        _close(tq(_to_torch(obs)), jq.forward(qparams, obs))


def test_catalog_specs_resolve_to_the_port():
    """The catalog's string specs name the port's classes, and
    resolve_module builds them; a spec naming the JAX package raises."""
    image = Catalog(Box(0, 255, (84, 84, 4), np.uint8), Discrete(6))
    spec = image.actor_critic_spec()
    assert spec["module_class"] == (
        "ray_tpu_torch.rllib.rl_module:ConvActorCriticModule")
    jax_spec = JaxCatalog(Box(0, 255, (84, 84, 4), np.uint8),
                          Discrete(6)).actor_critic_spec()
    assert {k: v for k, v in spec.items() if k != "module_class"} == {
        k: v for k, v in jax_spec.items() if k != "module_class"}
    assert isinstance(trl.resolve_module(spec, device="cpu"),
                      trl.ConvActorCriticModule)
    q = Catalog(Discrete(5), Discrete(2)).q_spec()
    assert isinstance(trl.resolve_module(q, device="cpu"),
                      trl.EncodedQModule)
    mlp = Catalog(Box(-1, 1, (4,)), Discrete(2)).actor_critic_spec()
    assert isinstance(trl.resolve_module(mlp, device="cpu"),
                      trl.DiscreteActorCriticModule)
    for bad in ("ray_tpu.rllib.rl_module:QModule", "ray_tpu:QModule"):
        with pytest.raises(ValueError, match="JAX package"):
            trl.resolve_module({"module_class": bad, "obs_dim": 4,
                                "num_actions": 2}, device="cpu")


def test_same_seed_same_weights_on_every_device():
    """Parameters are drawn on the CPU from the given generator."""
    spec = {"obs_dim": 4, "num_actions": 2}
    a = trl.resolve_module(spec, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    b = trl.resolve_module(spec, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert float(a.pi.weight.detach().std()) < 0.05  # the head's 0.01 scale
    assert float(a.pi.bias.abs().max()) == 0


def test_conv_filters_validation():
    with pytest.raises(ValueError, match="below 1x1"):
        trl.ConvActorCriticModule((8, 8, 1), 4,
                                  conv_filters=((32, 8, 4), (64, 4, 2)),
                                  device="cpu")


def test_converter_round_trip_and_layouts():
    jm = jrl.ConvActorCriticModule((20, 20, 2), 3, ((4, 4, 2), (8, 3, 1)),
                                   (16,))
    params, tm = _ported(jm, trl.ConvActorCriticModule, (20, 20, 2), 3,
                         ((4, 4, 2), (8, 3, 1)), (16,))
    state = state_from_jax_numpy(params)
    assert state["convs.0.weight"].shape == (4, 2, 4, 4)  # OIHW
    assert state["torso.0.weight"].shape == (16, 7 * 7 * 8)  # [out, in]
    back = to_jax_layout(tm.named_parameters())
    assert len(back["convs"]) == 2 and len(back["torso"]) == 1
    for path in (("convs", 1, "w"), ("torso", 0, "w"), ("pi", "b")):
        want, got = params, back
        for p in path:
            want, got = want[p], got[p]
        np.testing.assert_array_equal(got, want)
    params["pi"]["w"] = params["pi"]["w"][:, :2]
    with pytest.raises(ValueError, match="pi.weight"):
        load_jax_numpy(tm, params)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_state_converter(clip):
    """optax's Adam state after two updates (behind the clip or alone)
    comes across with its count and moments."""
    jm = jrl.DiscreteActorCriticModule(4, 2, (8,))
    params, tm = _ported(jm, trl.DiscreteActorCriticModule, 4, 2, (8,))
    tx = optax.chain(*([optax.clip_by_global_norm(clip)] if clip else []),
                     optax.adam(1e-3))
    state = tx.init(params)
    for i in range(2):
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.1 * (i + 1)),
                             params)
        _, state = tx.update(grads, state, params)
    state = jax.device_get(state)
    adam = state[-1][0]  # (scale_by_adam, scale_by_learning_rate)
    converted = adam_state_from_jax_numpy(tm, state)
    count, mu, nu = adam_state_to_jax_layout(tm, converted)
    assert count == 2
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        np.testing.assert_array_equal(got["torso"][0]["w"],
                                      want["torso"][0]["w"])
        np.testing.assert_array_equal(got["vf"]["b"], want["vf"]["b"])
    names = [n for n, _ in tm.named_parameters()]
    assert [tuple(m.shape) for m in converted.mu] == [
        tuple(dict(tm.named_parameters())[n].shape) for n in names]
