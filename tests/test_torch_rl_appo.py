"""APPO's V-trace update in the port against the JAX package's, on the CPU.

The port's `VTraceLearner` with `appo_clip` starts from the JAX module's
parameters (converted by `ray_tpu_torch.rllib.convert`) and takes the same
seeded numpy [B, T] batches as `make_vtrace_update(..., appo_clip=True)`:
the loss and metrics, the gradients (JAX's read off one step of
`optax.sgd(1.0)`, which moves each parameter by minus its gradient) and the
parameters and Adam moments after each of three steps agree at 1e-5
relative. Far-off behaviour log-probabilities make the clip bite, and there
APPO's loss differs from IMPALA's, as
`tests/test_rllib_offline.py::test_appo_clipped_surrogate_differs_from_impala`
asks of the JAX package.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import rl_module as jrl
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms.registry import get_algorithm_class
from ray_tpu_torch.rllib.convert import load_jax_numpy, to_jax_layout
from ray_tpu_torch.rllib.learner import batch_to_device

from test_torch_rl_learners import (METRIC_ATOL, METRIC_RTOL,
                                    assert_metrics_close, assert_state_close,
                                    assert_trees_close, vtrace_batch)

SPEC = {"obs_dim": 4, "num_actions": 2, "hiddens": (32,)}


def _config(**kw):
    return {"lr": 1e-3, "gamma": 0.95, "vtrace_clip_rho_threshold": 1.0,
            "vtrace_clip_c_threshold": 0.9, "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01, "normalize_advantages": True,
            "appo_clip": True, "clip_param": 0.2, "seed": 0,
            "device": "cpu", **kw}


def _far_batch(seed):
    """vtrace_batch with behaviour log-probabilities far below the policy's,
    so that most ratios leave [1 - clip, 1 + clip]."""
    batch = vtrace_batch(seed)
    batch["logp"] = batch["logp"] - 1.5
    return batch


def _pair(config):
    jm = jrl.DiscreteActorCriticModule(4, 2, (32,))
    params = jm.init(jax.random.PRNGKey(0))
    tl = timpala.VTraceLearner(SPEC, config)
    load_jax_numpy(tl.module, jax.device_get(params))
    return jm, params, tl


@pytest.mark.parametrize("make_batch", [vtrace_batch, _far_batch],
                         ids=["near", "far"])
def test_appo_loss_and_gradients_match_jax(make_batch):
    config = _config()
    jm, params, tl = _pair(config)
    batch = make_batch(0)
    sgd = optax.sgd(1.0)
    moved, _, aux = jimpala.make_vtrace_update(jm, sgd, config)(
        params, sgd.init(params), batch)
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                    params, moved)
    loss, metrics = tl.compute_metrics(batch)
    loss.backward()
    got = {k: float(v) for k, v in metrics.items()}
    assert_metrics_close(got, {k: float(v) for k, v in aux.items()})
    grads = {k: p.grad for k, p in tl.module.named_parameters()}
    assert_trees_close(to_jax_layout(grads.items()), jgrads, "grads")


def test_appo_adam_steps_match_jax():
    config = _config()
    jm, params, tl = _pair(config)
    opt = optax.adam(config["lr"])
    opt_state = opt.init(params)
    update = jimpala.make_vtrace_update(jm, opt, config)
    for i in range(3):
        batch = _far_batch(i)
        params, opt_state, aux = update(params, opt_state, batch)
        got = tl.update_from_batch(batch)
        assert_metrics_close(got, {k: float(v) for k, v in aux.items()})
        assert_state_close(tl, params, opt_state)


def test_appo_clipped_surrogate_differs_from_impala():
    """Where the ratios leave the clip range, APPO's policy loss is not
    IMPALA's, on both packages, and the port's equals the JAX one's."""
    losses = {}
    for clip in (False, True):
        config = _config(appo_clip=clip)
        jm, params, tl = _pair(config)
        batch = _far_batch(3)
        _, _, aux = jimpala.make_vtrace_update(jm, optax.adam(1e-3), config)(
            params, optax.adam(1e-3).init(params), batch)
        with torch.no_grad():
            _, metrics = tl.loss_fn(batch_to_device(batch, "cpu"))
        losses[clip] = (float(metrics["pg_loss"]), float(aux["pg_loss"]))
        np.testing.assert_allclose(*losses[clip], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL)
    assert losses[False][0] != losses[True][0]


def test_appo_config_and_registry_follow_jax():
    from ray_tpu.rllib.algorithms import APPOConfig as JAPPOConfig

    tcfg, jcfg = timpala.APPOConfig(), JAPPOConfig()
    assert tcfg.algo_class is timpala.APPO
    assert get_algorithm_class("APPO") is timpala.APPO
    assert issubclass(timpala.APPO, timpala.IMPALA)
    for key in ("appo_clip", "clip_param", "lr", "rollout_fragment_length",
                "vtrace_clip_rho_threshold", "vtrace_clip_c_threshold",
                "vf_loss_coeff", "entropy_coeff", "normalize_advantages",
                "max_requests_in_flight_per_env_runner",
                "broadcast_interval"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    # both default to two remote runners, pipelined
    assert tcfg.num_env_runners == jcfg.num_env_runners == 2


def test_appo_trains_on_the_cpu():
    algo = (timpala.APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .resources(device="cpu").debugging(seed=0).build())
    out = algo.train()
    assert out["num_env_steps_sampled_lifetime"] >= 32
    assert np.isfinite([out[k] for k in ("pg_loss", "vf_loss",
                                         "total_loss")]).all()
    algo.stop()


def test_appo_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        (timpala.APPOConfig().environment("CartPole-v1")
         .env_runners(num_env_runners=0).build())
