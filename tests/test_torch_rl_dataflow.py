"""The port's decoupled RL dataflow (`ray_tpu_torch/rllib/dataflow.py`)
against the JAX package's, on the CPU: the counterparts of
`tests/test_rl_dataflow.py`.

- The queue: JAX's `SampleQueueActor` and the port's, built directly, take
  the same `set_incarnation` / `push` / `pop_batch` sequences and return
  the same acks, stats and depths, and emit the same events with the same
  fields.
- The fleet and the flow over the stand-in runtime
  (`rllib.remote_cases.LocalRuntime`, given its `put` and owner death):
  broadcasts stamp the batches' versions; staleness drops are counted,
  emitted and exported, never returned; IMPALA escapes the stale livelock
  by re-broadcasting; a failed runner is respawned with a bumped
  incarnation, its queued entries discarded and its payloads, once read,
  counted discarded; a preempt notice retires the runners of its node;
  the fleet scales up when the learner starves and down when the queue
  sheds.
- IMPALA's update from pulled batches: the same batch, built from the same
  pulled episodes, and the same update as JAX's `make_vtrace_update`.
- `chip_smoke.py --only s` rehearsed on the CPU at its own sizes, but
  (s-2)'s seconds and (s-3)'s shape.
- On the runtime (`ray_tpu.init`): decoupled IMPALA through
  `config.runtime(...)` survives a killed runner and one injected
  `node.preempt_notice`; its events, in the runtime's log, pass JAX's
  `drills.slo.rl_slo`; the runtime's OwnerDiedError of a dead runner's
  batch is counted discarded.

Every wait has its own deadline.
"""

import collections
import copy
import json
import time
from types import SimpleNamespace

import inspect

import jax
import numpy as np
import pytest
import torch

import ray_tpu as rt
from ray_tpu._private import event_log
from ray_tpu._private.event_watch import EventCursor
from ray_tpu.drills import slo
from ray_tpu.rllib import algorithms as jalgos
from ray_tpu.rllib import dataflow as jdataflow
from ray_tpu.rllib.episode import SingleAgentEpisode as JaxEpisode
from ray_tpu_torch._private import serialization
from ray_tpu_torch.rllib import dataflow as tdataflow
from ray_tpu_torch.rllib import remote_cases as rc
from ray_tpu_torch.rllib.algorithms import IMPALAConfig, PPOConfig
from ray_tpu_torch.rllib.convert import load_jax_numpy, to_jax_layout
from ray_tpu_torch.rllib.rl_module import resolve_module
from ray_tpu_torch.util import metrics

from test_torch_rl_learners import assert_metrics_close, assert_trees_close

pytestmark = pytest.mark.rl

DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def local_events(monkeypatch):
    """The port's own registry and a fresh event ring, and no typed tensor
    wire left installed, before and after each test."""
    metrics.use_runtime()
    monkeypatch.setattr(metrics, "_ring",
                        collections.deque(maxlen=metrics.RING_EVENTS))
    yield
    metrics.use_runtime()
    serialization.uninstall_tensor_wire()


@pytest.fixture
def runtime():
    stand_in = rc.LocalRuntime()
    yield stand_in
    stand_in.shutdown()


# -- the queue against JAX's ------------------------------------------------------

def _entry(runner=0, incarnation=0, version=0, ref="r"):
    return {"ref": ref, "env_steps": 8, "policy_version": version,
            "runner": runner, "incarnation": incarnation}


# Each sequence mirrors one of tests/test_rl_dataflow.py's queue tests.
QUEUE_SEQUENCES = {
    "bound_typed_shed": (2, [
        ("push", _entry()), ("push", _entry()), ("push", _entry()),
        ("stats",), ("pop_batch", 10), ("push", _entry()), ("depth",)]),
    "zombie_push_rejected": (8, [
        ("set_incarnation", 3, 2), ("push", _entry(runner=3, incarnation=1)),
        ("stats",), ("depth",), ("push", _entry(runner=3, incarnation=2)),
        ("depth",)]),
    "newer_incarnation_supersedes_and_discards": (8, [
        ("push", _entry(runner=1)), ("push", _entry(runner=1)),
        ("push", _entry(runner=2)),
        ("push", _entry(runner=1, incarnation=1)),
        ("set_incarnation", 1, 1), ("pop_batch", 10), ("stats",)]),
    "stale_set_incarnation_is_noop": (8, [
        ("set_incarnation", 0, 5), ("set_incarnation", 0, 3), ("stats",)]),
    "shed_then_zombie_then_discard": (1, [
        ("push", _entry(runner=0, version=4)),
        ("push", _entry(runner=1, version=4)),
        ("set_incarnation", 0, 2), ("push", _entry(runner=0, incarnation=1)),
        ("pop_batch", 0), ("depth",), ("pop_batch", 1), ("stats",)]),
}


def _jax_events(since):
    return [(e["type"], e["data"]) for e in list(event_log._ring)
            if e["seq"] > since and e["type"].startswith("rl.")]


@pytest.mark.parametrize("name", sorted(QUEUE_SEQUENCES))
def test_queue_matches_jax(name):
    maxsize, ops = QUEUE_SEQUENCES[name]
    jq = jdataflow.SampleQueueActor(maxsize)
    tq = tdataflow.SampleQueueActor(maxsize)
    since = max([e["seq"] for e in event_log._ring] or [0])
    port_seq = max([e["seq"] for e in metrics.events()] or [0])
    for op, *args in ops:
        want = getattr(jq, op)(*copy.deepcopy(args))
        got = getattr(tq, op)(*copy.deepcopy(args))
        assert got == want, (op, args)
    assert tq.stats() == jq.stats()
    port = [(e["type"], e["data"]) for e in metrics.events("rl.")
            if e["seq"] > port_seq]
    assert port == _jax_events(since)
    assert port or name not in ("bound_typed_shed", "zombie_push_rejected")
    for etype, data in port:
        assert set(event_log.EVENT_SCHEMAS[etype]) <= set(data)


def test_retry_hint_and_bound_are_the_runtimes():
    from ray_tpu._private.backoff import retry_after_hint
    from ray_tpu._private.config import CONFIG

    assert tdataflow.SAMPLE_QUEUE_MAX == CONFIG.rl_sample_queue_max
    for depth in (0, 1, 7, 64, 10_000):
        for kw in ({}, {"per_item_s": 0.01, "floor_s": 0.05, "cap_s": 1.0}):
            assert (tdataflow.retry_after_hint(depth, **kw)
                    == retry_after_hint(depth, **kw))


def test_the_queues_events_reach_the_emitter_it_is_given():
    """A queue in a runtime worker has not called use_runtime: it takes
    the emitter its creator was given."""
    seen = []
    q = tdataflow.SampleQueueActor(1, emit=lambda t, **d: seen.append(
        (t, d)))
    q.push(_entry())
    q.push(_entry(runner=4))
    q.set_incarnation(4, 2)
    q.push(_entry(runner=4, incarnation=1))
    assert seen == [("rl.sample_shed", {"runner": 4, "depth": 1}),
                    ("rl.zombie_push", {"runner": 4, "incarnation": 1,
                                        "current": 2})]
    assert not metrics.events("rl.")


# -- the fleet and the flow on the stand-in -------------------------------------------

def _spec():
    return rc.cartpole_spec({"fcnet_hiddens": [16]})


def _flow_config(num_runners, **kw):
    cfg = {"env": "CartPole-v1", "num_envs_per_env_runner": 1,
           "rollout_fragment_length": 16, "seed": 0,
           "num_env_runners": num_runners,
           "max_requests_in_flight_per_env_runner": 1, "device": "cpu"}
    cfg.update(kw)
    return cfg


def _weights(spec):
    return resolve_module(spec, device="cpu").state_dict()


def _flow(runtime, num_runners=1, **kw):
    spec = _spec()
    return tdataflow.DecoupledDataflow(_flow_config(num_runners, **kw), spec,
                                       _weights(spec), version=0,
                                       runtime=runtime)


def _pull_until(flow, version, want, **kw):
    got = []
    deadline = time.monotonic() + DEADLINE_S
    while len(got) < want and time.monotonic() < deadline:
        got.extend(flow.pull(current_version=version, **kw))
        time.sleep(0.01)
    return got


def _until(cond, step, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, what
        step()
        time.sleep(0.01)


def _rl_events(etype):
    return [e for e in metrics.events(etype)]


def test_the_dataflow_needs_the_runtime(runtime):
    """Without the runtime as one value, the dataflow and IMPALA's
    decoupled mode raise and name it; no actor is made."""
    spec = _spec()
    with pytest.raises(ValueError, match=r"SimpleNamespace.*put=ray_tpu"):
        tdataflow.DecoupledDataflow(_flow_config(1), spec, _weights(spec))
    config = (IMPALAConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=1)
              .dataflow(decoupled=True).resources(device="cpu")
              .runtime(remote=runtime.remote))
    with pytest.raises(ValueError, match=r"SimpleNamespace.*put=ray_tpu"):
        config.build()
    assert runtime.actors == []


def test_versioned_weight_broadcast_stamps_batches(runtime):
    flow = _flow(runtime)
    try:
        first = _pull_until(flow, 0, 1)
        assert first and first[0][0]["policy_version"] == 0
        flow.broadcast(_weights(_spec()), version=5)
        seen = []
        _until(lambda: 5 in seen, lambda: seen.extend(
            e["policy_version"] for e, _ in flow.pull(current_version=5)),
            "the runner never stamped the broadcast version")
        # a version never goes back once the broadcast is taken
        assert seen[seen.index(5):] == [5] * (len(seen) - seen.index(5))
    finally:
        flow.stop()
    (ev,) = _rl_events("rl.weights_broadcast")
    assert ev["data"] == {"version": 5, "runners": 1}
    assert flow.stats()["fleet_version"] == 5


def _counter_total(name):
    m = metrics.get_metric(name)
    return sum(v for _, _, v in m._samples()) if m is not None else 0.0


def test_staleness_drop_accounting(runtime):
    exported = _counter_total("ray_tpu_rl_stale_dropped_total")
    flow = _flow(runtime, max_sample_staleness=1)
    try:
        # the learner raced ahead: version 10 against batches of version 0,
        # past the bound of 1: every pulled batch is dropped and counted,
        # never returned for training
        def pull_stale():
            assert flow.pull(current_version=10) == []

        _until(lambda: flow.stale_dropped >= 1, pull_stale,
               "no batch was dropped as stale")
        flow.broadcast(_weights(_spec()), version=10)
        got = _until_version(flow, 10)
    finally:
        flow.stop()
    assert got["policy_version"] == 10
    drops = _rl_events("rl.stale_drop")
    assert len(drops) == flow.stale_dropped >= 1
    assert all(e["data"] == {"version": 10, "batch_version": 0, "bound": 1,
                             "runner": 0} for e in drops)
    assert (_counter_total("ray_tpu_rl_stale_dropped_total") - exported
            == flow.stale_dropped)
    for name in ("ray_tpu_rl_queue_depth", "ray_tpu_rl_rollout_runners",
                 "ray_tpu_rl_samples_shed_total",
                 "ray_tpu_rl_runner_restarts_total"):
        assert metrics.get_metric(name) is not None, name


def _until_version(flow, version):
    """The first entry pulled at `version` that carries it (stale drops of
    older versions go on meanwhile)."""
    box = []

    def pull():
        box.extend(e for e, _ in flow.pull(current_version=version)
                   if e["policy_version"] == version)

    _until(lambda: box, pull, f"no batch of version {version}")
    return box[0]


def _impala(runtime, num_runners=1, **dataflow):
    return (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=num_runners,
                         rollout_fragment_length=16)
            .training(model={"fcnet_hiddens": [16]}, lr=1e-3)
            .dataflow(decoupled=True, **dataflow)
            .debugging(seed=0).resources(device="cpu")
            .runtime(runtime)).build()


def test_stale_livelock_escapes_via_rebroadcast(runtime):
    """A learner whose version races past the fleet's re-broadcasts on a
    pull that only dropped stale batches, instead of livelocking."""
    algo = _impala(runtime, max_sample_staleness=1)
    try:
        _until(lambda: algo.policy_version >= 2, algo.train,
               "the learner never got going")
        # a restored checkpoint far ahead of the fleet
        algo.policy_version += 10
        jumped = algo.policy_version
        _until(lambda: algo.policy_version > jumped, algo.train,
               "the learner livelocked on stale batches")
        assert algo.dataflow.stale_dropped >= 1
        versions = [e["data"]["version"]
                    for e in _rl_events("rl.weights_broadcast")]
        assert jumped in versions    # the re-broadcast, with no update
        steps = [e["data"] for e in _rl_events("rl.learner_step")]
        assert [s["step"] for s in steps] == list(range(1, len(steps) + 1))
        for s in steps:
            assert s["version"] - 1 - s["min_batch_version"] <= 1
    finally:
        algo.stop()


def test_runner_death_respawn_discards_its_entries(runtime):
    """A failed runner is respawned in its slot with a bumped incarnation
    and a new actor; the queue discards its queued entries; the learner
    keeps making progress."""
    flow = _flow(runtime, 2, sample_queue_size=8)
    try:
        # let the queue fill with both runners' entries, unread
        _until(lambda: flow.fleet.stats()["pushed"] >= 6,
               lambda: flow.fleet.pump(), "the runners never pushed")
        snap = flow.fleet.snapshot()
        snap[0]["handle"].fail()
        _until(lambda: flow.fleet.restarts >= 1, flow.fleet.pump,
               "the failed runner was never respawned")
        queue = flow.queue
        qstats = queue.stats.remote().future().result(timeout=DEADLINE_S)
        assert qstats["discarded_dead"] >= 1
        assert qstats["incarnations"][0] == 1
        later = _pull_until(flow, 0, 4)
        assert not [e for e, _ in later
                    if e["runner"] == 0 and e["incarnation"] == 0]
        assert any(e["runner"] == 0 and e["incarnation"] == 1
                   for e, _ in _pull_until(flow, 0, 6))
    finally:
        flow.stop()
    snap2 = flow.fleet.snapshot() or None
    assert snap2 is None    # stopped
    (dead,) = _rl_events("rl.runner_dead")
    (respawn,) = _rl_events("rl.runner_respawn")
    assert dead["actor_id"] == snap[0]["actor_id"]
    assert dead["data"] == {"runner": 0, "reason": "RayActorError",
                            "incarnation": 0}
    assert respawn["actor_id"] != snap[0]["actor_id"]
    assert respawn["data"] == {"runner": 0, "incarnation": 1,
                               "reason": "RayActorError"}
    assert snap[0]["handle"].terminated
    assert flow.fleet.deaths == flow.fleet.restarts == 1


def test_a_dead_runners_batches_are_counted_discarded(runtime, monkeypatch):
    """Entries popped before the fleet has seen the death: reading their
    payloads raises the owner's death, and the learner counts them
    discarded and returns none of them."""
    flow = _flow(runtime, 1, sample_queue_size=8)
    try:
        _until(lambda: flow.fleet.stats()["pushed"] >= 3, flow.fleet.pump,
               "the runner never pushed")
        flow.fleet.snapshot()[0]["handle"].fail()
        monkeypatch.setattr(flow.fleet, "pump", lambda timeout=0.0: {})
        assert flow.pull(current_version=0, max_batches=100) == []
        assert flow.discarded_dead >= 3
        assert flow.env_steps_trained == 0
    finally:
        flow.stop()


def test_a_preempt_notice_retires_the_runners_of_its_node(runtime):
    flow = _flow(runtime, 2)
    try:
        _until(lambda: all(s.node_id for s in flow.fleet.slots.values()),
               flow.fleet.pump, "the runners' nodes never came back")
        assert {s.node_id for s in flow.fleet.slots.values()} == {
            runtime.node_id}
        runtime.preempt("another-node")
        flow.fleet.pump()
        assert flow.fleet.deaths == 0
        runtime.preempt()
        flow.fleet.pump()
        assert flow.fleet.deaths == flow.fleet.restarts == 2
        assert {s.incarnation for s in flow.fleet.slots.values()} == {1}
        got = _pull_until(flow, 0, 2)
        assert got and {e["incarnation"] for e, _ in got} == {1}
    finally:
        flow.stop()
    assert [e["data"]["reason"] for e in _rl_events("rl.runner_dead")] == [
        "preempt_notice"] * 2


def test_the_fleet_scales_up_when_the_learner_starves(runtime):
    flow = _flow(runtime, 1, elastic_min_env_runners=1,
                 elastic_max_env_runners=2)
    try:
        _until(lambda: len(flow.fleet.slots) == 2,
               lambda: flow.pull(current_version=0, max_batches=100),
               "the fleet never scaled up")
        got = _pull_until(flow, 0, 8, max_batches=100)
        assert {e["runner"] for e, _ in got} == {0, 1}
    finally:
        flow.stop()
    (ev,) = _rl_events("rl.fleet_scale")
    assert ev["data"] == {"from_runners": 1, "to_runners": 2,
                          "reason": "learner_starved"}


def test_the_fleet_scales_down_when_the_queue_sheds(runtime):
    flow = _flow(runtime, 3, sample_queue_size=1,
                 max_requests_in_flight_per_env_runner=2,
                 elastic_min_env_runners=1, elastic_max_env_runners=3)
    try:
        # nothing is popped: the full queue sheds every runner's push
        def pull_nothing():
            assert flow.pull(current_version=0, max_batches=0) == []
            time.sleep(0.1)

        _until(lambda: len(flow.fleet.slots) == 1, pull_nothing,
               "the fleet never scaled down")
        retired = [runtime.actors[i] for i in (2, 3)]   # after the queue
    finally:
        flow.stop()
    scale = [e["data"] for e in _rl_events("rl.fleet_scale")]
    assert scale == [{"from_runners": 3, "to_runners": 2,
                      "reason": "queue_backlogged"},
                     {"from_runners": 2, "to_runners": 1,
                      "reason": "queue_backlogged"}]
    assert all(a.terminated for a in retired)
    assert _rl_events("rl.sample_shed")


# -- IMPALA and PPO with the setting ------------------------------------------------

def test_appo_builds_the_dataflow_and_trains(runtime):
    from ray_tpu_torch.rllib.algorithms import APPOConfig

    algo = (APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, rollout_fragment_length=16)
            .dataflow(decoupled=True).debugging(seed=0)
            .resources(device="cpu").runtime(runtime)).build()
    try:
        assert isinstance(algo.dataflow, tdataflow.DecoupledDataflow)
        assert algo.runner_group is None
        _until(lambda: algo.policy_version >= 2, algo.train,
               "APPO never updated")
        out = algo.train()
        assert "dataflow" in out or out == {"num_episodes": 0,
                                            "wait_seconds": out.get(
                                                "wait_seconds")}
    finally:
        algo.stop()


def test_ppo_ignores_the_setting_and_runs_its_runners(runtime):
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, rollout_fragment_length=32)
            .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
            .dataflow(decoupled=True).debugging(seed=0)
            .resources(device="cpu").runtime(remote=runtime.remote)).build()
    try:
        result = algo.train()
    finally:
        algo.stop()
    assert result["num_env_steps_sampled"] >= 64
    assert len(algo.env_runner_group.remotes) == 2


def test_impala_update_from_pulled_batches_matches_jax(runtime):
    """The same batch from the same pulled episodes, then the same update
    (weights to STATE_TOL = 1e-5 of each leaf's scale, metrics to 1e-5)."""
    j = (jalgos.IMPALAConfig().environment("CartPole-v1")
         .env_runners(num_env_runners=0, rollout_fragment_length=16)
         .training(model={"fcnet_hiddens": [16]}, lr=1e-3)
         .debugging(seed=0)).build()
    t = _impala(runtime, 2)
    try:
        load_jax_numpy(t.learner.module, jax.device_get(j.params))
        t._broadcast()
        box = []

        def pull():
            box.extend(t._pull_decoupled()["episodes"])

        _until(lambda: box, pull, "no batch was pulled")
        jeps = []
        for ep in box:
            je = JaxEpisode()
            je.__dict__.update(copy.deepcopy(ep.__dict__))
            jeps.append(je)
        jb = j._episodes_to_batch(jeps)
        tb = t._episodes_to_batch(box)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        j.params, j.opt_state, aux = j._update(j.params, j.opt_state, jb)
        got = t.learner.update_from_batch(tb)
        assert_metrics_close(got, {k: float(v) for k, v in aux.items()
                                   if k != "total_loss"})
        assert_trees_close(to_jax_layout(t.learner.module.named_parameters()),
                           j.params, "params")
    finally:
        t.stop()
        j.stop()


# -- chip_smoke.py's phase (s) ----------------------------------------------------

def test_chip_smoke_phase_s_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only s` with the card stubbed: (s-1) at its own
    sizes (8 updates, a failed runner, a stale jump, the first update
    against the CPU's), (s-2) for 0.5 s a runner count, (s-3) at 64 x 64
    on aot_eager; no flash kernel launched; the last line is the ok
    object."""
    from ray_tpu_torch.rllib import dataflow_cases as dc
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "DATAFLOW_BENCH_S", 0.5)
    monkeypatch.setattr(smoke, "DAG_SHAPE", (64, 64))
    torch._dynamo.reset()
    try:
        assert smoke.main(["--only", "s"]) == 0
    finally:
        torch._dynamo.reset()
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[s-1] (NVIDIA H100 80GB HBM3, 700.00 W) decoupled IMPALA",
                "[s-2]", "[s-3]", "[s] the decoupled dataflow",
                "[phases]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert any(line.startswith("[s] launches of the flash kernels") and
               "'flash_fwd': 0, 'flash_bwd_dq': 0, 'flash_bwd_dkv': 0" in line
               for line in lines)
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    out = json.loads(lines[-2])["dataflow"]
    impala = out["impala"]
    assert len(out["pull_s"]) == len(out["learn_s"]) == dc.UPDATES
    assert impala["stale_trained"] == 0 and impala["stale_dropped"] >= 1
    assert impala["events"]["rl.runner_dead"] == 1
    assert impala["max_abs_err_first_update_weights"] <= 1e-6
    per = out["benchmark_decoupled"]["detail"]["per_worker_counts"]
    assert set(per) == {"1", "2"} and min(per.values()) > 0
    assert out["benchmark_decoupled"]["metric"] == (
        "rllib_decoupled_env_steps_per_sec")
    assert set(out["lower_to_jit"]) == {"workflow", "diamond"}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_benchmark_decoupled_returns_jaxs_keys(runtime):
    from ray_tpu.rllib import benchmarks as jbench
    from ray_tpu_torch.rllib import benchmarks as tbench

    got = tbench.benchmark_decoupled((1,), fragment=8, duration_s=0.2,
                                     device="cpu", runtime=runtime)
    assert got["metric"] == "rllib_decoupled_env_steps_per_sec"
    assert got["unit"] == "env-steps/s" and got["value"] > 0
    src = inspect.getsource(jbench.benchmark_decoupled)
    for key in ("per_worker_counts", "scaling", "worker_counts",
                "num_envs_per_runner", "host_cpus"):
        assert f'"{key}"' in src and key in got["detail"], key


# -- on the runtime ----------------------------------------------------------------

@pytest.fixture
def cluster():
    rt.init(num_cpus=6)
    yield
    rt.shutdown()


def _runtime_config(**dataflow):
    return (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, rollout_fragment_length=16)
            .training(model={"fcnet_hiddens": [16]}, lr=1e-3)
            .dataflow(decoupled=True, **dataflow)
            .debugging(seed=0).resources(device="cpu")
            .runtime(SimpleNamespace(
                remote=rt.remote, put=rt.put,
                get_runtime_context=rt.get_runtime_context,
                event_cursor=EventCursor)))


def _cluster_events(since):
    from ray_tpu._raylet import get_core_worker

    event_log.flush(timeout=5.0)
    evs = get_core_worker()._gcs.call(
        "get_cluster_events", {"type": "rl.*", "since": since,
                               "limit": 5000}, timeout=10)
    return slo.order_events(evs)


def test_decoupled_impala_on_the_runtime(cluster, monkeypatch):
    """A runner killed mid-training and one injected preempt notice:
    deaths equal respawns, steps monotonic, nothing stale and no batch of
    a dead runner trained on (JAX's rl_slo over the port's events in the
    runtime's log); a dead runner's batch read through the runtime is
    counted discarded."""
    metrics.use_runtime(emit=event_log.emit)
    t_start = time.time()
    algo = _runtime_config(max_sample_staleness=3).build()
    trained = []          # (runner, incarnation) of each batch trained on
    pull = algo.dataflow.pull

    def recording_pull(*a, **kw):
        out = pull(*a, **kw)
        trained.extend((e["runner"], e["incarnation"]) for e, _ in out)
        return out

    monkeypatch.setattr(algo.dataflow, "pull", recording_pull)
    flow, fleet = algo.dataflow, algo.dataflow.fleet

    def progress(n, what):
        v = algo.policy_version
        _until(lambda: algo.policy_version >= v + n, algo.train, what)

    def gone():
        """The incarnations the fleet has replaced."""
        return {(s.index, i) for s in fleet.slots.values()
                for i in range(s.incarnation)}

    try:
        progress(3, "the learner never got going")
        rt.kill(fleet.snapshot()[0]["handle"])
        _until(lambda: fleet.restarts >= 1, algo.train,
               "the killed runner was never respawned")
        seen = len(trained)
        progress(3, "no progress after the kill")
        assert not set(trained[seen:]) & gone()

        # one preempt notice for the runners' node, as the raylet emits it
        _until(lambda: all(s.node_id for s in fleet.slots.values()),
               algo.train, "the runners' node ids never came back")
        (node,) = {s.node_id for s in fleet.slots.values()}
        assert node == rt.get_runtime_context().get_node_id()
        deaths = fleet.deaths
        event_log.emit("node.preempt_notice", node_id=node, deadline_s=30.0,
                       reason="test")
        event_log.flush(timeout=5.0)
        _until(lambda: fleet.deaths >= deaths + 2, algo.train,
               "the preempt notice did not retire the node's runners")
        seen = len(trained)
        progress(3, "no progress after the preempt notice")
        assert not set(trained[seen:]) & gone()
        assert fleet.deaths == fleet.restarts == 3

        # a dead runner's batches read through the runtime: the owner's
        # death is counted discarded, and none is returned
        _until(lambda: flow.queue.depth.remote().future().result(
            timeout=DEADLINE_S) >= 2, fleet.pump, "the queue stayed empty")
        monkeypatch.setattr(fleet, "pump", lambda timeout=0.0: {})
        for s in fleet.snapshot().values():
            rt.kill(s["handle"])
        time.sleep(1.0)
        discarded = flow.discarded_dead
        assert pull(algo.policy_version, max_batches=100) == []
        assert flow.discarded_dead >= discarded + 2
    finally:
        algo.stop()
        metrics.use_runtime()
    events = _cluster_events(t_start - 1.0)
    rl = slo.rl_slo(events, "rl_rollout_storm")
    assert rl["steps_monotonic"] is True
    assert rl["stale_trained_violations"] == 0
    assert rl["learner_steps"] >= 9
    assert rl["runner_deaths"] == rl["runner_respawns"] == 3
    reasons = [e["data"]["reason"] for e in events
               if e["type"] == "rl.runner_dead"]
    assert reasons[0] != "preempt_notice"
    assert reasons[1:] == ["preempt_notice"] * 2
    steps = [e["data"] for e in events if e["type"] == "rl.learner_step"]
    assert all(s["min_batch_version"] is not None
               and s["staleness_bound"] == 3 for s in steps)
    for e in events:
        if e["type"] in ("rl.runner_dead", "rl.runner_respawn"):
            assert e["actor_id"] and "actor_id" not in e["data"]
        assert set(event_log.EVENT_SCHEMAS[e["type"]]) <= set(e["data"])
