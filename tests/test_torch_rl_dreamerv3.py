"""DreamerV3 in the port against the JAX package's, on the CPU.

The port's `DreamerModel` takes the JAX algorithm's initial parameters and
three Adam states (`convert.dreamer_state_from_jax_numpy`). One whole
`train_step` runs on the same seeded numpy [B, T] batch as the JAX
algorithm's jitted `_train_step` with one key; the test replays that key's
splits (`dreamerv3.py:326-330`, `:219`, `:277`) to rebuild JAX's Gumbel
draws and hands them to the port. The losses agree to 1e-5, each of the
three gradients (JAX's from the step's own loss functions, at the states
the step takes them) and the first Adam moments to 2e-5 max|g| + 2e-4 |g|,
and the parameters and moments after the step to 1e-5 of each leaf's
largest magnitude against optax's Adam of the port's gradients (Adam's
first step, lr * g / (|g| + eps), magnifies a tolerated gradient
difference where |g| is near eps).
`policy_step` is held the same way; `_SeqBuffer` samples are identical.
The learning run mirrors `tests/test_rllib_catalog.py::test_dreamerv3_learns`
and is marked slow, as that one is.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib.algorithms import dreamerv3 as jdv3
from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdv3
from ray_tpu_torch.rllib.convert import (adam_state_to_jax_layout,
                                         dreamer_state_from_jax_numpy,
                                         to_jax_layout)

from test_torch_rl_learners import assert_trees_close

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4   # atol of max|g|, rtol of |g|
B, T, H = 4, 8, 5


def _jax_algo():
    algo = (jdv3.DreamerV3Config().environment("CartPole-v1")
            .training(batch_size_B=B, batch_length_T=T, horizon_H=H)
            .debugging(seed=3).build())
    return algo


def _port(jalgo):
    cfg = jalgo.config
    model = tdv3.DreamerModel(
        jalgo.obs_dim, jalgo.num_actions, deter_dim=cfg.deter_dim,
        stoch_groups=cfg.stoch_groups, stoch_classes=cfg.stoch_classes,
        embed_dim=cfg.embed_dim, hidden_dim=cfg.hidden_dim, device="cpu")
    learner = tdv3.DreamerV3Learner(model, cfg.to_dict())
    learner.opt_state = dreamer_state_from_jax_numpy(
        model, jax.device_get(jalgo.params), jax.device_get(jalgo.opt_state))
    return model, learner


def _batch(seed):
    r = np.random.default_rng(seed)
    cont = (r.random((B, T)) > 0.1).astype(np.float32)
    return {"obs": r.standard_normal((B, T, 4)).astype(np.float32),
            "actions": r.integers(0, 2, (B, T)),
            "rewards": r.standard_normal((B, T)).astype(np.float32),
            "cont": cont}


def _train_noise(key, cfg, num_actions):
    """JAX's Gumbel draws inside `_train_step(..., key)`: the posterior
    filter's per step (`k1` split at each step), then the imagination's
    (`k2` split in three at each step: the actor's, then the prior's)."""
    G, C = cfg.stoch_groups, cfg.stoch_classes
    n = B * T
    k1, k2 = jax.random.split(key)
    post, kk = [], k1
    for _ in range(T):
        kk, kt = jax.random.split(kk)
        post.append(jax.random.gumbel(kt, (B, G, C)))
    actor, prior, kk = [], [], k2
    for _ in range(H):
        kk, ka, kz = jax.random.split(kk, 3)
        actor.append(jax.random.gumbel(ka, (n, num_actions)))
        prior.append(jax.random.gumbel(kz, (n, G, C)))
    return {k: np.stack([np.asarray(x) for x in v])
            for k, v in (("post", post), ("actor", actor), ("prior", prior))}


def _closure(jitted):
    fn = jitted.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _jax_grads(jalgo, params, batch, key, new_params):
    """The three gradients of JAX's step at the states it takes them: the
    world model's at the old parameters; the actor's against the updated
    world model and the old critic; the critic's against the updated actor
    and world model."""
    f = _closure(jalgo._train_step)
    D, Z = f["D"], f["Z"]
    k1, k2 = jax.random.split(key)
    (_, (hs, zs, *_)), g_wm = jax.value_and_grad(
        f["wm_loss"], has_aux=True)(params["wm"], batch, k1)
    h0, z0 = hs.reshape(-1, D), zs.reshape(-1, Z)
    ac = f["ac_losses"]
    g_actor = jax.grad(lambda ap: ac(ap, params["critic"], new_params["wm"],
                                     h0, z0, k2)[0])(params["actor"])
    g_critic = jax.grad(lambda cp: ac(new_params["actor"], cp,
                                      new_params["wm"], h0, z0, k2)[1])(
        params["critic"])
    return {"wm": g_wm, "actor": g_actor, "critic": g_critic}


def _record_grads(learner):
    seen = {}
    for name, update in list(learner._updates.items()):
        def record(grads, state, params, name=name, update=update):
            seen[name] = [g.detach().clone() for g in grads]
            return update(grads, state, params)
        learner._updates[name] = record
    return seen


def _assert_grads_close(got, want, what):
    got, want = _flat(got), _flat(jax.device_get(want))
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(
            got[name], w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
            err_msg=f"{what} {name}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def jalgo():
    algo = _jax_algo()
    yield algo
    algo.stop()


def test_dreamerv3_train_step_matches_jax(jalgo):
    cfg = jalgo.config
    model, learner = _port(jalgo)
    grads = _record_grads(learner)
    params = jax.device_get(jalgo.params)
    batch = _batch(0)
    key = jax.random.PRNGKey(11)
    new_params, new_os, metrics = jalgo._train_step(
        jalgo.params, jalgo.opt_state, batch, key)
    noise = {k: torch.from_numpy(v) for k, v in
             _train_noise(key, cfg, jalgo.num_actions).items()}
    got = learner.train_step(tdv3._to_device(batch, "cpu"), noise)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    want_grads = _jax_grads(jalgo, params, batch, key,
                            jax.device_get(new_params))
    for name, lr in (("wm", cfg.lr), ("actor", cfg.actor_lr),
                     ("critic", cfg.critic_lr)):
        module = getattr(model, name)
        names = [n for n, _ in module.named_parameters()]
        port_grads = to_jax_layout(zip(names, grads[name]))
        _assert_grads_close(port_grads, want_grads[name], f"{name} grads")
        # Adam's first step is lr * g / (|g| + eps): where |g| is near eps
        # it magnifies the gradients' tolerated difference up to lr, so the
        # parameters and moments are held against optax's Adam of the
        # port's own gradients from JAX's state, and the first moment
        # (1 - b1) g against JAX's at the gradients' tolerance.
        upd, want_os = optax.adam(lr).update(
            port_grads, jalgo.opt_state[name], params[name])
        want = optax.apply_updates(params[name], upd)
        assert_trees_close(to_jax_layout(module.named_parameters()), want,
                           f"{name} params")
        count, mu, nu = adam_state_to_jax_layout(module,
                                                 learner.opt_state[name])
        assert count == int(want_os[0].count) == int(new_os[name][0].count)
        assert_trees_close(mu, want_os[0].mu, f"{name} mu")
        assert_trees_close(nu, want_os[0].nu, f"{name} nu")
        _assert_grads_close(mu, new_os[name][0].mu, f"{name} mu (JAX's)")


def test_dreamerv3_gumbel_replay_gives_jax_categorical():
    """The rebuilt noise is JAX's: argmax(logits + gumbel(key)) equals
    jax.random.categorical(key, logits)."""
    r = np.random.default_rng(1)
    logits = r.standard_normal((64, 8)).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gumbel(key, logits.shape))
        np.testing.assert_array_equal(
            np.argmax(g + logits, -1),
            np.asarray(jax.random.categorical(key, logits)))


def test_dreamerv3_policy_step_matches_jax(jalgo):
    cfg = jalgo.config
    model, _ = _port(jalgo)
    r = np.random.default_rng(2)
    h = r.standard_normal((3, cfg.deter_dim)).astype(np.float32)
    z = np.zeros((3, cfg.stoch_groups * cfg.stoch_classes), np.float32)
    obs = r.standard_normal((3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jh, jz, ja = jalgo._policy_step(jalgo.params, h, z, obs, key)
    k1, k2 = jax.random.split(key)
    noise = {"post": torch.from_numpy(np.asarray(jax.random.gumbel(
        k1, (3, cfg.stoch_groups, cfg.stoch_classes)))),
        "action": torch.from_numpy(np.asarray(jax.random.gumbel(
            k2, (3, jalgo.num_actions))))}
    th, tz, ta = model.policy_step(torch.from_numpy(h), torch.from_numpy(z),
                                   torch.from_numpy(obs), noise)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


def test_dreamerv3_algorithm_policy_step_rolls_its_latents(jalgo):
    """The algorithm's acting path with JAX's draws: the same actions and
    latents over a few real env steps from the same state."""
    cfg = jalgo.config
    talgo = (tdv3.DreamerV3Config().environment("CartPole-v1")
             .resources(device="cpu").debugging(seed=3).build())
    dreamer_state_from_jax_numpy(talgo.model, jax.device_get(jalgo.params),
                                 jax.device_get(jalgo.opt_state))
    h = np.zeros((1, cfg.deter_dim), np.float32)
    z = np.zeros((1, cfg.stoch_groups * cfg.stoch_classes), np.float32)
    obs = np.asarray([0.01, -0.02, 0.03, 0.04], np.float32)
    for seed in range(5):
        key = jax.random.PRNGKey(100 + seed)
        h, z, ja = jalgo._policy_step(jalgo.params, h, z, obs[None], key)
        k1, k2 = jax.random.split(key)
        ta = talgo.policy_step(obs, {
            "post": np.asarray(jax.random.gumbel(
                k1, (1, cfg.stoch_groups, cfg.stoch_classes))),
            "action": np.asarray(jax.random.gumbel(
                k2, (1, jalgo.num_actions)))})
        assert ta == int(np.asarray(ja)[0])
        np.testing.assert_allclose(talgo._h.numpy(), np.asarray(h),
                                   rtol=1e-5, atol=1e-6)
        obs = obs + np.float32(0.01)
    talgo.stop()


def test_seq_buffer_samples_equal_jax():
    r = np.random.default_rng(4)
    bufs = (jdv3._SeqBuffer(60), tdv3._SeqBuffer(60))
    for length in (5, 12, 20, 9, 30):
        steps = [(r.standard_normal(4), int(r.integers(2)), float(r.random()),
                  float(i < length - 1)) for i in range(length)]
        for buf in bufs:
            buf.start_episode()
            for s in steps:
                buf.add(*s)
            buf.end_episode()
    assert bufs[0].size == bufs[1].size
    for seed in range(3):
        want = bufs[0].sample(np.random.default_rng(seed), 4, 8)
        got = bufs[1].sample(np.random.default_rng(seed), 4, 8)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    assert bufs[1].sample(np.random.default_rng(0), 2, 100) is None


def test_dreamerv3_config_matches_jax():
    from ray_tpu.rllib.algorithm_config import AlgorithmConfig

    tcfg, jcfg = tdv3.DreamerV3Config(), jdv3.DreamerV3Config()
    keys = set(vars(jcfg)) - set(vars(AlgorithmConfig()))
    assert len(keys) == 17
    for k in keys:
        assert getattr(tcfg, k) == getattr(jcfg, k), k


def test_symlog_symexp_match_jax():
    x = np.linspace(-50, 50, 101).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tdv3.symlog(t).numpy(),
                               np.asarray(jdv3._symlog(x)), rtol=1e-6)
    np.testing.assert_allclose(tdv3.symexp(tdv3.symlog(t)).numpy(), x,
                               rtol=1e-5, atol=1e-5)


def test_dreamerv3_trains_on_the_cpu():
    algo = (tdv3.DreamerV3Config().environment("CartPole-v1")
            .resources(device="cpu").debugging(seed=0)
            .training(num_steps_per_iteration=64, train_ratio=2,
                      num_steps_sampled_before_learning_starts=64).build())
    before = {n: p.detach().clone() for n, p in
              algo.model.named_parameters()}
    out = algo.train()
    assert out["buffer_size"] >= 64 and np.isfinite(out["wm_loss"])
    # the prior learns only once the dyn KL exceeds its free bits
    assert out["kl_dyn"] == 1.0
    for n, p in algo.model.named_parameters():
        assert torch.equal(before[n], p) == n.startswith("wm.prior."), n
    algo.stop()


@pytest.mark.slow  # model-based training, as test_dreamerv3_learns
def test_dreamerv3_learns():
    algo = (tdv3.DreamerV3Config().environment("CartPole-v1")
            .resources(device="cpu").debugging(seed=0)
            .training(num_steps_per_iteration=200, train_ratio=48,
                      batch_size_B=8, batch_length_T=16, horizon_H=10,
                      entropy_coeff=1e-2, actor_lr=5e-5)
            .build())
    best = 0.0
    try:
        for _ in range(70):
            result = algo.train()
            best = max(best, result.get("episode_return_mean", 0.0))
            if best >= 60.0:
                break
        assert best >= 60.0, f"DreamerV3 never beat random: best={best}"
    finally:
        algo.stop()


def test_dreamerv3_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdv3.DreamerV3Config().environment("CartPole-v1").build()
