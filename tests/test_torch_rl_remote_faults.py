"""The port's crashable fleet of remote env runners on the runtime's
actors, on the CPU: the counterparts of `tests/test_rl_dataflow.py`'s
`test_sync_group_respawns_dead_runner`, `test_pipelined_impala_rearms_
replacement` and `test_sync_group_fail_fast_when_restarts_disabled`.

- A runner killed with `ray_tpu.kill` is replaced in place, carrying the
  last weights pushed (the same tensors, the same version), and the fleet
  samples in full again.
- Pipelined IMPALA over one runner: after the kill the slot is replaced,
  re-armed to its full count, and two more updates follow.
- With restart_failed_env_runners=False the loop fails fast with the
  runtime's own `RayActorError`; a runner's own error propagates.

Each membership change is emitted as JAX's group emits it
(`rl.runner_dead`, `rl.runner_respawn`, the actor's id in the envelope),
read here as (event, slot, incarnation, reason).
"""

import collections
import time

import pytest
import torch

import ray_tpu as rt
from ray_tpu import exceptions as rt_exceptions
from ray_tpu_torch._private import actors, serialization
from ray_tpu_torch.rllib import remote_cases as rc
from ray_tpu_torch.rllib.algorithms import IMPALAConfig
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.util import metrics

DEADLINE_S = 60.0
DEAD = ("rl.runner_dead", 0, 0, "actor_died")
RESPAWN = ("rl.runner_respawn", 0, 1, "actor_died")


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True)
def _wire_uninstalled():
    yield
    serialization.uninstall_tensor_wire()


@pytest.fixture(autouse=True)
def _fresh_events(monkeypatch):
    metrics.use_runtime()
    monkeypatch.setattr(metrics, "_ring",
                        collections.deque(maxlen=metrics.RING_EVENTS))


def _emitted():
    """The runner events of this test, as (event, slot, incarnation,
    reason)."""
    evs = metrics.events("rl.runner_")
    assert all(e["actor_id"] for e in evs)
    return [(e["type"], e["data"]["runner"], e["data"]["incarnation"],
             e["data"]["reason"]) for e in evs]


def _group(**extra):
    spec = rc.cartpole_spec()
    group = EnvRunnerGroup(rc.runner_config("cpu", num_env_runners=2,
                                            **extra), spec, rt.remote)
    return group, resolve_module(spec, device="cpu").state_dict()


def test_a_dead_runner_is_replaced_carrying_the_last_weights(cluster):
    group, weights = _group()
    try:
        group.sync_weights(weights, version=1)
        assert len(group.sample(num_steps=4)) > 0
        dead = group.remotes[0]
        rt.kill(dead)
        # the kill may land after one more call; the survivor's fragments
        # keep coming back either way, and the dead slot is replaced
        deadline = time.monotonic() + DEADLINE_S
        while group.restarts == 0 and time.monotonic() < deadline:
            assert group.sample(num_steps=4) is not None
        assert group.restarts == 1 and group.remotes[0] != dead
        assert _emitted() == [DEAD, RESPAWN]
        new = group.remotes[0]
        assert actors.results([new.get_weights_version.remote()]) == [1]
        carried = actors.results([new.get_weights.remote()])[0]
        for k, v in weights.items():
            assert torch.equal(carried[k], v), k
        episodes = group.sample(num_steps=4)
        assert sum(len(e) for e in episodes) == 2 * 4
    finally:
        group.stop()


def test_pipelined_impala_rearms_the_replacement(cluster):
    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, rollout_fragment_length=16)
            .training(model={"fcnet_hiddens": [16]}, lr=1e-3)
            .debugging(seed=0).resources(device="cpu")
            .runtime(remote=rt.remote)).build()
    per = algo.config.max_requests_in_flight_per_env_runner
    try:
        deadline = time.monotonic() + DEADLINE_S
        updates = 0
        while updates < 2 and time.monotonic() < deadline:
            if algo.train().get("num_episodes", 0):
                updates += 1
        assert updates >= 2
        dead = algo.runner_group.remotes[0]
        rt.kill(dead)
        deadline = time.monotonic() + 2 * DEADLINE_S
        after = 0
        while time.monotonic() < deadline:
            if (algo.train().get("num_episodes", 0)
                    and algo.runner_group.restarts >= 1):
                after += 1
                if after >= 2:
                    break
        group = algo.runner_group
        assert group.restarts == 1 and after >= 2, \
            "the pipeline never recovered after the runner's death"
        assert group.remotes[0] != dead
        armed = collections.Counter(id(h) for h in algo._inflight.values())
        assert armed[id(group.remotes[0])] == per
        assert _emitted() == [DEAD, RESPAWN]
    finally:
        algo.stop()


def test_fail_fast_when_restarts_are_off(cluster):
    group, weights = _group(restart_failed_env_runners=False)
    try:
        group.sync_weights(weights, version=1)
        group.sample(num_steps=4)
        rt.kill(group.remotes[0])
        with pytest.raises(rt_exceptions.RayActorError):
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                group.sample(num_steps=4)
        assert group.restarts == 0
        assert _emitted() == [DEAD]
    finally:
        group.stop()


def test_a_runners_own_error_propagates_on_the_runtime(cluster):
    group, weights = _group()
    try:
        group.sync_weights(weights, version=1)
        with pytest.raises(TypeError, match="unexpected keyword"):
            group.sample(num_steps=4, no_such_option=1)
        assert group.restarts == 0 and _emitted() == []
    finally:
        group.stop()
