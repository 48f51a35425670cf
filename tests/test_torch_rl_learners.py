"""The port's learners against the JAX package's, on the CPU.

Each learner starts from the JAX learner's parameters and optax state
(carried across by `ray_tpu_torch.rllib.convert`) and takes the same
seeded numpy batches: one update and three, with the global-norm clip
triggered and not where the learner has one. After each update the loss
and every metric agree to METRIC_RTOL, and every parameter and Adam moment
to STATE_TOL of its leaf's largest magnitude. SAC takes JAX's own noise
draws; the V-trace targets are held against `make_vtrace_update`'s losses
and an independent loop of the recursion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import rl_module as jrl
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.convert import (_adam_state,
                                         adam_state_from_jax_numpy,
                                         adam_state_to_jax_layout,
                                         load_jax_numpy, to_jax_layout)
from ray_tpu_torch.rllib.learner import clip_by_global_norm_

METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
STATE_TOL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def assert_trees_close(got, want, what):
    got, want = _flat(got), _flat(jax.device_get(want))
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=STATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def assert_metrics_close(got, want):
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(got[k], w, rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], float(w), rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=k)


def assert_state_close(tlearner, jparams, jopt_state, module=None):
    """Parameters and Adam moments (and count) of the port's learner
    against the JAX learner's."""
    module = module or tlearner.module
    assert_trees_close(to_jax_layout(module.named_parameters()), jparams,
                       "params")
    adam = _adam_state(jax.device_get(jopt_state))
    count, mu, nu = adam_state_to_jax_layout(module, tlearner.opt_state)
    assert count == int(adam.count)
    assert_trees_close(mu, adam.mu, "mu")
    assert_trees_close(nu, adam.nu, "nu")


def port_from(jlearner, tlearner):
    """The port learner with the JAX learner's parameters and optax
    state."""
    params = jax.device_get(jlearner.params)
    load_jax_numpy(tlearner.module, params)
    tlearner.opt_state = adam_state_from_jax_numpy(
        tlearner.module, jax.device_get(jlearner.opt_state))
    return tlearner


def _rng(seed):
    return np.random.default_rng(seed)


def ppo_batch(seed, n=64, obs_dim=4, num_actions=2):
    r = _rng(seed)
    return {"obs": r.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": r.integers(0, num_actions, n).astype(np.int32),
            "logp": (-np.log(num_actions)
                     + 0.2 * r.standard_normal(n)).astype(np.float32),
            "advantages": r.standard_normal(n).astype(np.float32),
            "value_targets": r.standard_normal(n).astype(np.float32)}


def conv_ppo_batch(seed, n=16):
    r = _rng(seed)
    b = ppo_batch(seed, n, 1, 4)
    b["obs"] = r.integers(0, 256, (n, 20, 20, 2), dtype=np.uint8)
    return b


def q_batch(seed, n=64, obs_dim=4, num_actions=2, weights=False):
    r = _rng(seed)
    b = {"obs": r.standard_normal((n, obs_dim)).astype(np.float32),
         "next_obs": r.standard_normal((n, obs_dim)).astype(np.float32),
         "actions": r.integers(0, num_actions, n).astype(np.int32),
         "rewards": r.standard_normal(n).astype(np.float32),
         "terminateds": (r.random(n) < 0.2).astype(np.float32)}
    if weights:
        b["weights"] = r.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def marwil_batch(seed, n=64):
    r = _rng(seed)
    return {"obs": r.standard_normal((n, 4)).astype(np.float32),
            "actions": r.integers(0, 2, n).astype(np.int32),
            "returns": (5 * r.random(n)).astype(np.float32)}


MLP_SPEC = {"obs_dim": 4, "num_actions": 2, "hiddens": (32, 32)}
CONV_SPEC = {"obs_shape": (20, 20, 2),
             "num_actions": 4, "conv_filters": ((8, 4, 2), (16, 3, 1)),
             "hiddens": (32,)}

# name -> (JAX learner factory, port learner factory, batch factory)
CASES = {
    "ppo": (lambda c: jppo.PPOLearner(MLP_SPEC, c),
            lambda c: tppo.PPOLearner(MLP_SPEC, c), ppo_batch),
    "ppo_conv": (
        lambda c: jppo.PPOLearner(dict(
            CONV_SPEC, module_class="ray_tpu.rllib.rl_module:"
            "ConvActorCriticModule"), c),
        lambda c: tppo.PPOLearner(dict(
            CONV_SPEC, module_class="ray_tpu_torch.rllib.rl_module:"
            "ConvActorCriticModule"), c), conv_ppo_batch),
    "marwil": (lambda c: jmarwil.MARWILLearner(MLP_SPEC, c),
               lambda c: tmarwil.MARWILLearner(MLP_SPEC, c), marwil_batch),
    "bc": (lambda c: jmarwil.MARWILLearner(MLP_SPEC, dict(c, beta=0.0)),
           lambda c: tmarwil.MARWILLearner(MLP_SPEC, dict(c, beta=0.0)),
           marwil_batch),
}


def _config(clip, lr=1e-3):
    return {"lr": lr, "grad_clip": clip, "seed": 0, "device": "cpu",
            "entropy_coeff": 0.01}


def _global_norm_of_first_update(jlearner, batch):
    grads = jax.grad(lambda p: jlearner.loss_fn(p, batch)[0])(
        jlearner.params)
    return float(optax.global_norm(grads))


@pytest.mark.parametrize("clip", [None, 1e-3, 1e4],
                         ids=["no_clip", "clip_triggered", "clip_idle"])
@pytest.mark.parametrize("name", list(CASES))
def test_learner_updates_match_jax(name, clip):
    jfactory, tfactory, batch_fn = CASES[name]
    config = _config(clip)
    jl = jfactory(config)
    tl = port_from(jl, tfactory(config))
    batches = [batch_fn(seed) for seed in range(3)]
    if clip is not None:
        norm = _global_norm_of_first_update(jl, batches[0])
        assert (norm > clip) == (clip < 1), norm
    for i, batch in enumerate(batches):
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert set(got) == set(want)
        assert_metrics_close(got, want)
        assert_state_close(tl, jl.params, jl.opt_state)
        assert tl.policy_version == jl.policy_version == i + 1


@pytest.mark.parametrize("weights", [False, True], ids=["uniform", "prio"])
@pytest.mark.parametrize("clip", [None, 1e-3])
@pytest.mark.parametrize("kind", ["dqn", "cql"])
def test_q_learner_updates_match_jax(kind, clip, weights):
    """Three updates, a target sync, a fourth update against the synced
    target."""
    spec = {"obs_dim": 4, "num_actions": 3, "hiddens": (32, 32)}
    config = dict(_config(clip), gamma=0.9, cql_alpha=0.5)
    jcls = jdqn.DQNLearner if kind == "dqn" else jcql.CQLLearner
    tcls = tdqn.DQNLearner if kind == "dqn" else tcql.CQLLearner
    jl = jcls(spec, config)
    tl = port_from(jl, tcls(spec, config))
    tl.sync_target()
    for i in range(4):
        if i == 3:
            jl.sync_target()
            tl.sync_target()
        batch = q_batch(10 + i, num_actions=3, weights=weights)
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch)
        assert set(got) == set(want)
        assert_metrics_close(got, want)
        assert_state_close(tl, jl.params, jl.opt_state)
    assert_trees_close(to_jax_layout(tl.target.named_parameters()),
                       jl.target_params, "target")


def test_clip_is_optax_formula():
    """Scaled by max_norm / ||g|| only at or above max_norm; untouched
    below it (torch's clip_grad_norm_ multiplies always, by max_norm /
    (||g|| + 1e-6))."""
    g = [torch.full((3,), 2.0), torch.full((2, 2), -1.0)]
    norm = float(torch.sqrt(torch.tensor(3 * 4.0 + 4)))
    clipped = [x.clone() for x in g]
    clip_by_global_norm_(clipped, 1.0)
    jg = [jnp.asarray(x.numpy()) for x in g]
    want, _ = optax.clip_by_global_norm(1.0).update(jg, None)
    for a, b in zip(clipped, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idle = [x.clone() for x in g]
    clip_by_global_norm_(idle, norm + 1e-3)
    for a, b in zip(idle, g):
        assert torch.equal(a, b)


def _sac_pair(hiddens=(32, 32), **overrides):
    from ray_tpu.rllib.algorithms.sac import SACConfig as JaxSACConfig

    cfg = (JaxSACConfig().environment("Pendulum-v1")
           .training(model={"fcnet_hiddens": list(hiddens)}, **overrides)
           .debugging(seed=0))
    jalgo = cfg.build()
    config = dict(cfg.to_dict(), device="cpu")
    tl = tsac.SACLearner(3, 1, hiddens, config)
    load_jax_numpy(tl.module, jax.device_get(jalgo.params))
    load_jax_numpy(tl.target, jax.device_get(jalgo.target))
    tl.opt_state = adam_state_from_jax_numpy(
        tl.module, jax.device_get(jalgo.opt_state))
    return jalgo, tl


def sac_batch(seed, n=32):
    r = _rng(seed)
    return {"obs": r.standard_normal((n, 3)).astype(np.float32),
            "next_obs": r.standard_normal((n, 3)).astype(np.float32),
            "actions": r.uniform(-1, 1, (n, 1)).astype(np.float32),
            "rewards": r.standard_normal(n).astype(np.float32),
            "terminateds": (r.random(n) < 0.1).astype(np.float32)}


@pytest.mark.parametrize("initial_alpha", [1.0, 0.2])
def test_sac_updates_match_jax_with_its_noise(initial_alpha):
    """The port's losses take JAX's draws: normal(key) for the critic
    target's action, normal(fold_in(key, 1)) for the actor loss's."""
    jalgo, tl = _sac_pair(initial_alpha=initial_alpha)
    key = jax.random.PRNGKey(42)
    for i in range(3):
        key, sub = jax.random.split(key)
        batch = sac_batch(i)
        n = len(batch["obs"])
        noise = (np.asarray(jax.random.normal(sub, (n, 1))),
                 np.asarray(jax.random.normal(jax.random.fold_in(sub, 1),
                                              (n, 1))))
        jalgo.params, jalgo.opt_state, jalgo.target, aux = jalgo._update(
            jalgo.params, jalgo.opt_state, jalgo.target, batch, sub)
        got = tl.update_from_batch(batch, noise=noise)
        assert_metrics_close(got, {k: float(v) for k, v in aux.items()})
        assert_state_close(tl, jalgo.params, jalgo.opt_state)
        assert_trees_close(to_jax_layout(tl.target.named_parameters()),
                           jalgo.target, "target")
    jalgo.stop()


def test_sac_draws_its_own_noise():
    _, tl = _sac_pair()
    before = [p.detach().clone() for p in tl.module.parameters()]
    out = tl.update_from_batch(sac_batch(0))
    assert np.isfinite(list(out.values())).all()
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tl.module.parameters()))


def vtrace_batch(seed, b=4, t=6, obs_dim=4):
    r = _rng(seed)
    mask = np.ones((b, t), np.float32)
    mask[-1, 3:] = 0  # shape padding
    terms = (r.random((b, t)) < 0.15).astype(np.float32)
    terms[:, -1] = 1.0
    return {"obs": r.standard_normal((b, t, obs_dim)).astype(np.float32),
            "actions": r.integers(0, 2, (b, t)),
            "rewards": r.standard_normal((b, t)).astype(np.float32),
            "logp": (-np.log(2) + 0.5 * r.standard_normal((b, t)))
            .astype(np.float32),
            "terminateds": terms, "mask": mask,
            "bootstrap_value": r.standard_normal(b).astype(np.float32)}


@pytest.mark.parametrize("normalize", [True, False])
def test_vtrace_updates_match_make_vtrace_update(normalize):
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (32,)}
    config = {"lr": 1e-3, "gamma": 0.95, "vtrace_clip_rho_threshold": 1.0,
              "vtrace_clip_c_threshold": 0.9, "vf_loss_coeff": 0.5,
              "entropy_coeff": 0.01, "normalize_advantages": normalize,
              "seed": 0, "device": "cpu"}
    jm = jrl.DiscreteActorCriticModule(4, 2, (32,))
    params = jm.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    update = jimpala.make_vtrace_update(jm, opt, config)
    tl = timpala.VTraceLearner(spec, config)
    load_jax_numpy(tl.module, jax.device_get(params))
    for i in range(3):
        batch = vtrace_batch(i)
        params, opt_state, aux = update(params, opt_state, batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, {k: float(v) for k, v in aux.items()})
        assert_state_close(tl, params, opt_state)


def _vtrace_loop(values, bootstrap, rewards, discounts, rho, c):
    """The recursion written out, in float64."""
    b, t = values.shape
    vs = np.zeros((b, t))
    nxt_vs, nxt_v = bootstrap.astype(np.float64), bootstrap
    for s in reversed(range(t)):
        delta = rho[:, s] * (rewards[:, s] + discounts[:, s] * nxt_v
                             - values[:, s])
        vs[:, s] = values[:, s] + delta + discounts[:, s] * c[:, s] * (
            nxt_vs - nxt_v)
        nxt_vs, nxt_v = vs[:, s], values[:, s]
    return vs


def test_vtrace_targets_match_jax():
    """vs from the port's loop against the recursion written out, and the
    JAX update's vf_loss and pg_loss recomputed from the port's vs."""
    config = {"gamma": 0.9, "vtrace_clip_rho_threshold": 1.0,
              "vtrace_clip_c_threshold": 1.0, "normalize_advantages": False,
              "vf_loss_coeff": 1.0, "entropy_coeff": 0.0}
    jm = jrl.DiscreteActorCriticModule(4, 2, (16,))
    params = jm.init(jax.random.PRNGKey(3))
    batch = vtrace_batch(7)
    b, t = batch["actions"].shape
    out = jm.forward_train(params, {"obs": batch["obs"].reshape(b * t, 4),
                                    "actions": batch["actions"].reshape(-1)})
    values = np.asarray(out["vf_preds"]).reshape(b, t)
    logp = np.asarray(out["logp"]).reshape(b, t)
    rhos = np.exp(logp - batch["logp"])
    clipped = np.minimum(1.0, rhos)
    discounts = 0.9 * (1.0 - batch["terminateds"])
    vs = timpala.vtrace_returns(
        *(torch.from_numpy(np.asarray(x, np.float32)) for x in (
            values, batch["bootstrap_value"], batch["rewards"], discounts,
            clipped, clipped))).numpy()
    np.testing.assert_allclose(vs, _vtrace_loop(
        values, batch["bootstrap_value"], batch["rewards"], discounts,
        clipped, clipped), rtol=1e-5, atol=1e-5)
    _, _, aux = jimpala.make_vtrace_update(jm, optax.sgd(0.0), config)(
        params, optax.sgd(0.0).init(params), batch)
    mask = batch["mask"]
    vf = 0.5 * np.sum(mask * (values - vs) ** 2) / mask.sum()
    vs_next = np.concatenate([vs[:, 1:], batch["bootstrap_value"][:, None]],
                             axis=1)
    pg_adv = clipped * (batch["rewards"] + discounts * vs_next - values)
    pg = -np.sum(logp * pg_adv * mask) / mask.sum()
    np.testing.assert_allclose(vf, float(aux["vf_loss"]), rtol=1e-5)
    np.testing.assert_allclose(pg, float(aux["pg_loss"]), rtol=1e-5,
                               atol=1e-6)


def test_learner_state_round_trip_resumes_the_update():
    """get_state / set_state: a learner restored from another's state
    takes the same next update."""
    config = _config(0.5)
    a = tppo.PPOLearner(MLP_SPEC, config)
    a.update_from_batch(ppo_batch(0))
    b = tppo.PPOLearner(MLP_SPEC, dict(config, seed=9))
    b.set_state(a.get_state())
    assert b.policy_version == 1 and b.opt_state.count == 1
    out_a, out_b = (x.update_from_batch(ppo_batch(1)) for x in (a, b))
    assert out_a == out_b
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(p, q)
