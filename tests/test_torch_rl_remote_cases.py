"""The remote RL groups' rules without the runtime, and `chip_smoke.py`'s
phase (q) rehearsed on the CPU.

- Refusals: remote runners or learners without the runtime's actor
  decorator raise and name `runtime(remote=...)`; an algorithm that runs
  no actors refuses them even with it; the default device raises on a
  host without CUDA, in the actor's construction; a runner's own error
  propagates. `decoupled=True` is what JAX makes of it: IMPALA builds the
  dataflow and trains; PPO and a group built directly run their
  synchronous runners.
- Membership changes: each replacement emits `rl.runner_dead` and
  `rl.runner_respawn` with the fields JAX's group passes (the actor's id
  in the envelope).
- The gone-runner classes: each name is a class of the runtime's
  exceptions, and only those (and their subclasses) count as gone.
- The actors' card binding, from node metadata: the position among the
  group's actors on the node, modulo the node's cards, two actors sharing
  a card; the bind before the instance is built; every call on the bound
  card, whatever thread runs it.
- The stand-in actors (`rllib.remote_cases.LocalRuntime`) and phase (q)'s
  three cases at their sizes, through `chip_smoke.py --only q`.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu import exceptions as rt_exceptions
from ray_tpu_torch._private import actors, gang, serialization
from ray_tpu_torch.rllib import remote_cases as rc
from ray_tpu_torch.rllib.algorithms import (DQNConfig, IMPALAConfig,
                                            PPOConfig)
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.dataflow import DecoupledDataflow
from ray_tpu_torch.rllib.learner import LearnerGroup, parameter_mean
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
from ray_tpu_torch.util import metrics


@pytest.fixture(autouse=True)
def _wire_uninstalled():
    """The groups install the typed tensor wire in this process; take it
    out again for the tests that follow."""
    yield
    serialization.uninstall_tensor_wire()


@pytest.fixture
def runtime():
    rt = rc.LocalRuntime()
    yield rt
    rt.shutdown()


@pytest.fixture
def membership_events(monkeypatch):
    """-> a function of the runner events emitted in this test, as
    (event, slot, incarnation, reason); each also carries the actor's
    id."""
    metrics.use_runtime()
    monkeypatch.setattr(metrics, "_ring",
                        collections.deque(maxlen=metrics.RING_EVENTS))

    def read():
        evs = metrics.events("rl.runner_")
        assert all(e["actor_id"] for e in evs)
        return [(e["type"], e["data"]["runner"], e["data"]["incarnation"],
                 e["data"]["reason"]) for e in evs]

    return read


# -- refusals ---------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda: PPOConfig().env_runners(num_env_runners=2),
    lambda: PPOConfig().learners(num_learners=2),
    lambda: IMPALAConfig(),          # two remote runners by default
    lambda: DQNConfig().env_runners(num_env_runners=1),
], ids=["ppo_runners", "ppo_learners", "impala_default", "dqn_runners"])
def test_remote_groups_without_the_decorator_raise_and_name_the_setter(
        build):
    with pytest.raises(ValueError, match=r"runtime\(remote=ray_tpu\.remote\)"):
        build().environment("CartPole-v1").resources(device="cpu").build()


def test_groups_built_directly_without_the_decorator_raise():
    spec = rc.cartpole_spec()
    with pytest.raises(ValueError, match=r"runtime\(remote="):
        EnvRunnerGroup(rc.runner_config("cpu", num_env_runners=2), spec)
    with pytest.raises(ValueError, match=r"runtime\(remote="):
        LearnerGroup(PPOLearner, spec,
                     rc.learner_config("cpu", num_learners=2))


def test_a_group_built_directly_refuses_the_decoupled_dataflow(runtime):
    """A group built directly ignores `decoupled`, as JAX's does (only
    IMPALA and APPO read it): it runs its synchronous runners. (The name
    is kept from when the port refused the dataflow.)"""
    config = rc.runner_config("cpu", num_env_runners=2, decoupled=True)
    spec = rc.cartpole_spec()
    group = EnvRunnerGroup(config, spec, runtime.remote)
    try:
        group.sync_weights(resolve_module(spec, device="cpu").state_dict(),
                           version=1)
        assert sum(len(e) for e in group.sample(num_steps=4)) == 2 * 4
    finally:
        group.stop()
    assert len(runtime.actors) == 2


@pytest.mark.parametrize("build", [
    lambda: DQNConfig().env_runners(num_env_runners=1),
    lambda: IMPALAConfig().learners(num_learners=2),
], ids=["dqn_runners", "impala_learners"])
def test_an_algorithm_without_actor_groups_refuses_them(build, runtime):
    """Neither samples nor learns in this process in their place."""
    with pytest.raises(NotImplementedError, match="in this process only"):
        (build().environment("CartPole-v1").resources(device="cpu")
         .runtime(remote=runtime.remote).build())


@pytest.mark.parametrize("config_cls", [IMPALAConfig, PPOConfig])
def test_the_decoupled_dataflow_raises_and_names_its_item(config_cls,
                                                          runtime):
    """`decoupled=True` with remote runners, as JAX reads it: IMPALA
    builds the decoupled dataflow over the runtime and trains; PPO ignores
    it and runs its synchronous runners. Nothing raises and names a
    ROADMAP item any more. (The name is kept from when the port refused
    the dataflow.)"""
    cfg = (config_cls().environment("CartPole-v1").resources(device="cpu")
           .env_runners(num_env_runners=2, rollout_fragment_length=16)
           .runtime(runtime).dataflow(decoupled=True)
           .debugging(seed=0))
    if config_cls is PPOConfig:
        cfg.training(train_batch_size=64, minibatch_size=32, num_epochs=1)
    algo = cfg.build()
    try:
        if config_cls is IMPALAConfig:
            assert isinstance(algo.dataflow, DecoupledDataflow)
            deadline = time.monotonic() + 30.0
            while algo.policy_version < 1:
                assert time.monotonic() < deadline, "IMPALA never updated"
                algo.train()
        else:
            assert algo.train()["num_env_steps_sampled"] >= 64
            assert len(algo.env_runner_group.remotes) == 2
    finally:
        algo.stop()


def test_the_default_device_raises_in_the_actors_construction(
        monkeypatch, runtime):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = rc.cartpole_spec()
    config = rc.runner_config(None, num_env_runners=2)
    assert config["device"] is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnvRunnerGroup(config, spec, runtime.remote)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnerGroup(PPOLearner, spec, rc.learner_config(None,
                                                         num_learners=2),
                     runtime.remote)


def test_a_runners_own_error_propagates(runtime, membership_events):
    """A failure whose class is not a gone-runner class is the runner's
    own: the group raises it and replaces nothing."""
    group = EnvRunnerGroup(rc.runner_config("cpu", num_env_runners=2),
                           rc.cartpole_spec(), runtime.remote)
    with pytest.raises(TypeError, match="unexpected keyword"):
        group.sample(num_steps=4, no_such_option=1)
    assert group.restarts == 0 and membership_events() == []
    group.stop()


def test_the_decorator_stays_out_of_what_actors_receive(runtime):
    cfg = PPOConfig().runtime(remote=runtime.remote)
    assert "remote" not in cfg.to_dict()
    assert cfg.copy().remote == runtime.remote
    assert cfg.copy().remote.__self__ is runtime


# -- the gone-runner classes ----------------------------------------------------

def test_gone_runner_names_are_the_runtimes_exception_classes():
    for name in actors.RUNNER_GONE:
        assert isinstance(getattr(rt_exceptions, name), type), name
    gone = [rt_exceptions.ActorDiedError("a"), rt_exceptions.OwnerDiedError(),
            rt_exceptions.WorkerCrashedError(), rc.RayActorError("x")]
    assert all(actors.is_gone(e) for e in gone)
    task_error = rt_exceptions.RayTaskError(
        "sample", "", ValueError("a bug")).as_instanceof_cause()
    assert not actors.is_gone(task_error)
    assert not actors.is_gone(RuntimeError("RayActorError"))
    with pytest.raises(ValueError):
        actors.check_gone(ValueError("a bug"))
    actors.check_gone(rt_exceptions.ActorDiedError("a"))


# -- the card binding -------------------------------------------------------------

def test_actor_cards_from_node_metadata():
    """Position among the group's actors on the node, modulo the node's
    cards; two actors on one card is allowed (no NCCL between them)."""
    nodes = ["a", "b", "a", "a", "b", "a", "a"]
    cards = {"a": 2, "b": 4}
    got = [actors.card_of(p, cards[n])
           for n, p in zip(nodes, gang.local_ranks(nodes))]
    assert got == [0, 0, 1, 0, 1, 1, 0]
    assert got.count(0) > cards["a"] // 2


def _stub_cards(monkeypatch, n):
    """n visible cards; set_device recorded per thread."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    class _Props:
        def __init__(self, i):
            self.uuid = f"GPU-{i}"

    monkeypatch.setattr(torch.cuda, "get_device_properties", _Props)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: bound.append(
        (threading.get_ident(), torch.device(d).index)))
    monkeypatch.setitem(gang._bound, "card", None)
    return bound


def test_an_actor_binds_its_card_by_position(monkeypatch):
    bound = _stub_cards(monkeypatch, 2)
    assert actors.bind_actor_card(3) == "GPU-1"
    assert actors.bind_actor_card(2) == "GPU-0"
    assert actors.bind_actor_card(5) == "GPU-1"      # shares card 1
    assert actors.bind_actor_card(0, "cuda:1") == "GPU-1"
    assert [i for _, i in bound] == [1, 0, 1, 1]
    assert actors.bind_actor_card(0, "cpu") is None
    assert len(bound) == 4


def test_a_card_actor_builds_on_its_card_and_calls_there(monkeypatch):
    bound = _stub_cards(monkeypatch, 4)

    class Probe:
        def __init__(self, x):
            self.x = x
            self.built_on = bound[-1]

        def where(self):
            return self.x, bound[-1]

    a = actors.CardActor(Probe, 7)
    with pytest.raises(AttributeError, match="not bound"):
        a.where()
    assert a.bind(5) == "GPU-1"
    assert a.built_on[1] == 1
    box = []
    t = threading.Thread(target=lambda: box.append(a.where()))
    t.start()
    t.join()
    x, (thread, card) = box[0]
    assert x == 7 and card == 1 and thread == t.ident


def test_place_actors_binds_by_position_on_the_node(runtime):
    """Three stand-in actors on this host: positions 0, 1, 2; a
    replacement takes its slot's position (`CardActor.bind_slot`)."""
    cls = runtime.remote(actors.CardActor)
    handles = [cls.remote(dict, a=i) for i in range(3)]
    nodes = actors.place_actors(handles, "cpu")
    assert len(set(nodes)) == 1
    assert actors.results([h.get.remote("a") for h in handles]) == [0, 1, 2]
    spare = cls.remote(dict, a=9)
    assert actors.results([spare.bind_slot.remote(nodes, 1, "cpu")]) == [
        nodes[1]]
    assert actors.results([spare.get.remote("a")]) == [9]


def test_parameter_mean_sums_in_order():
    w = [{"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(0.1)},
         {"a": torch.tensor([3.0, 6.0]), "b": torch.tensor(0.2)},
         {"a": torch.tensor([5.0, 1.0]), "b": torch.tensor(0.3)}]
    mean = parameter_mean(w)
    assert torch.equal(mean["a"], torch.tensor([3.0, 3.0]))
    assert torch.equal(mean["b"], ((0 + w[0]["b"] + w[1]["b"]) + w[2]["b"])
                       / 3)


def test_parameter_mean_of_leaves_on_different_devices():
    """Learners on different cards: each leaf meets the first learner's on
    its device before the sum ("meta" stands in for a second device)."""
    w = [{"a": torch.ones(2, 3, device="meta")},
         {"a": torch.full((2, 3), 3.0)}]
    with pytest.raises(RuntimeError, match="device"):
        _ = w[0]["a"] + w[1]["a"]
    mean = parameter_mean(w)
    assert mean["a"].device.type == "meta" and mean["a"].shape == (2, 3)


def test_the_learner_group_meets_its_learners_weights_on_the_host(
        monkeypatch, runtime):
    """What the driver gathers from the learner actors, and what it sends
    back and on to the runners, are host copies: a CUDA tensor on the wire
    is rebuilt on its sender's card index, so learners on cards 0 and 1
    would meet on two devices, and a runner on card 1 would take card 0's
    tensors."""
    import ray_tpu_torch.rllib.learner as learner_mod

    seen = []

    def spy(weights):
        seen.append([v.device.type for w in weights for v in w.values()])
        return parameter_mean(weights)

    monkeypatch.setattr(learner_mod, "parameter_mean", spy)
    spec = rc.cartpole_spec()
    group = LearnerGroup(PPOLearner, spec,
                         rc.learner_config("cpu", num_learners=2),
                         runtime.remote)
    group.update_from_batch(rc.learner_batch(0, 16))
    assert seen and set(seen[0]) == {"cpu"}
    weights = group.get_weights()
    assert {v.device.type for v in weights.values()} == {"cpu"}
    group.stop()

    learner = PPOLearner(spec, rc.learner_config("cpu"))
    host = learner.get_host_weights()
    live = learner.get_weights()
    for k, v in host.items():
        assert torch.equal(v, live[k])
        assert v.data_ptr() != live[k].data_ptr(), k

    runners = EnvRunnerGroup(rc.runner_config("cpu", num_env_runners=1),
                             spec, runtime.remote)
    runners.sync_weights(live, version=3)
    shipped, version = runners._last_weights
    assert version == 3
    for k, v in shipped.items():
        assert v.device.type == "cpu" and torch.equal(v, live[k])
        assert v.data_ptr() != live[k].data_ptr(), k
    runners.stop()


def test_a_replaced_runner_is_stopped(runtime, membership_events):
    """A gone-runner error can come from a lost object while its actor
    lives on: the replaced actor is stopped, so it frees its CPUs and its
    card."""
    group = EnvRunnerGroup(rc.runner_config("cpu", num_env_runners=2),
                           rc.cartpole_spec(), runtime.remote)
    old = group.remotes[1]
    new = group.replace_runner(old, "object_lost")
    assert new is group.remotes[1] and new is not old
    assert old.terminated and not new.terminated
    assert membership_events() == [
        ("rl.runner_dead", 1, 0, "object_lost"),
        ("rl.runner_respawn", 1, 1, "object_lost")]
    dead, respawn = metrics.events("rl.runner_")
    assert dead["actor_id"] == old._actor_id.hex()
    assert respawn["actor_id"] == new._actor_id.hex()
    assert group.replace_runner(old) is None
    group.stop()
    assert all(a.terminated for a in runtime.actors)


# -- the stand-in and phase (q) ---------------------------------------------------

def test_stand_in_actors_run_in_order_by_value(runtime):
    h = runtime.remote(list).remote([1])
    t = torch.ones(3)
    refs = [h.append.remote(t), h.copy.remote()]
    t.add_(1)   # the actor took its own copy when the call was made
    got = actors.results(refs)[1]
    assert got[0] == 1 and got[1].tolist() == [1.0, 1.0, 1.0]
    finished = h.copy.remote()
    finished.future().result()
    h.fail()
    with pytest.raises(rc.RayActorError):
        h.copy.remote().future().result()
    # a call that finished before the failure and was not read since
    with pytest.raises(rc.RayActorError):
        finished.future().result()
    actors.terminate(h)


def test_chip_smoke_phase_q_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request,
                                                 membership_events):
    """`chip_smoke.py --only q` with the card stubbed: (q-1) the learner
    group's mean and metrics against the CPU's steps, (q-2) the wire and
    the remote runners against in-process ones, (q-3) IMPALA's pipeline
    with a failed runner, at phase (q)'s own sizes; no flash kernel
    launched; the last line is the ok object."""
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    assert smoke.main(["--only", "q"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[q-1] (NVIDIA H100 80GB HBM3, 700.00 W) LearnerGroup of 2 "
                "PPO learners", "[q-2]", "[q-3]", "[q] the remote RL groups",
                "[phases]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert any(line.startswith("[q] launches of the flash kernels") and
               "'flash_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0" in line
               for line in lines)
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    out = json.loads(lines[-2])["rl_remote"]
    assert out["runners"]["transitions"] == 2 * rc.RUNNER_STEPS
    assert out["runners"]["bytes"] > 0
    pipe = out["pipeline"]
    assert pipe["updates"] >= (rc.PIPELINE_ITERATIONS
                               + rc.PIPELINE_AFTER_FAILURE)
    assert len(pipe["wait_s"]) == pipe["updates"]
    # the pipeline itself read a failed armed call and replaced its runner
    assert pipe["dropped"] >= 1
    slot = pipe["failed_slot"]
    assert [tuple(m) for m in pipe["membership"]] == [
        ("rl.runner_dead", slot, 0, "actor_died"),
        ("rl.runner_respawn", slot, 1, "actor_died")] == membership_events()
    assert out["learners"]["max_abs_err_weights"] == 0.0
    assert all(np.isfinite(out["learners"][k]) for k in (
        "update_ms", "gather_ms", "mean_ms", "set_ms"))
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_a_failed_runners_fragment_is_dropped_and_its_slot_replaced(
        runtime, membership_events):
    """IMPALA's pipeline with no broadcast after the start (so no weight
    push finds the failed runner first): the failed runner's next calls
    raise RayActorError when the loop reads them; each such fragment is
    dropped (a step with no episodes), the slot is replaced once and
    re-armed to its full count, and updates go on."""
    algo = rc.pipeline_config("cpu", runtime,
                              broadcast_interval=10 ** 6).build()
    try:
        for _ in range(2):
            assert algo.train()["num_episodes"] > 0
        failed = algo.runner_group.remotes[0]
        failed.fail()
        results = [algo.train() for _ in range(12)]
    finally:
        algo.stop()
    group = algo.runner_group
    dropped = [r for r in results if not r.get("num_episodes")]
    assert 1 <= len(dropped) <= rc.IN_FLIGHT
    assert group.restarts == 1 and group.remotes[0] is not failed
    assert membership_events() == [
        ("rl.runner_dead", 0, 0, "actor_died"),
        ("rl.runner_respawn", 0, 1, "actor_died")]
    assert sum(bool(r.get("num_episodes")) for r in results) >= 2
    armed = collections.Counter(id(h) for h in algo._inflight.values())
    assert [armed[id(h)] for h in group.remotes] == [rc.IN_FLIGHT] * 2


def test_runner_actors_ask_for_the_configured_resources(runtime):
    """num_cpus_per_env_runner and custom_resources_per_env_runner reach
    the runner actors' options, as in JAX's group; learners take one CPU."""
    spec = rc.cartpole_spec()
    config = (PPOConfig().environment("CartPole-v1").resources(device="cpu")
              .env_runners(num_env_runners=2, num_cpus_per_env_runner=0.5,
                           custom_resources_per_env_runner={"rollout": 1})
              ).to_dict()
    EnvRunnerGroup(config, spec, runtime.remote).stop()
    LearnerGroup(PPOLearner, spec, rc.learner_config("cpu", num_learners=1),
                 runtime.remote).stop()
    assert [a.options for a in runtime.actors] == [
        {"num_cpus": 0.5, "resources": {"rollout": 1}}] * 2 + [
        {"num_cpus": 1}]
