"""The decoupled dataflow's work on one device without the runtime:
`chip_smoke.py`'s phase (s) and its CPU rehearsal.

The actors are `remote_cases.LocalRuntime`'s stand-ins (threads of this
process; arguments by value through the port's pickler; `put` owned by
the calling actor, lost with it), each runner bound to the card as the
runtime's would be.

`decoupled_case`: IMPALA (fp32, CartPole at its default widths) with
`dataflow(decoupled=True)` over two stand-in runners, on `device`, for
`updates` updates. After a third of them one runner fails: the fleet
respawns its slot with a bumped incarnation. After two thirds the
learner's version jumps past the staleness bound, as after a restored
checkpoint: the queued batches are dropped as stale, and the pull that
only dropped re-broadcasts the weights. Checked: no stale batch trained
on (each `rl.learner_step`'s version - 1 - min_batch_version <= bound, as
`drills/slo.rl_slo` reads it), the events' counts against the dataflow's
own (steps, deaths, respawns, stale drops), and the learner's first
update against the same pulled batch on the CPU (|a - b| <= ATOL + RTOL
|b|, phase (m)'s rule).

Then the stand-in DAG nodes that (s) lowers with `dag.lower_to_jit` on
the card, and two DAGs of operator-only functions (below).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Tuple

from ray_tpu_torch._private import actors
from ray_tpu_torch.rllib import remote_cases as rc
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig, VTraceLearner
from ray_tpu_torch.util import metrics

# (s): the decoupled IMPALA's size and bound.
UPDATES = 8
STALENESS = 2
DEADLINE_S = 60.0


def decoupled_config(device, runtime) -> IMPALAConfig:
    return (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2)
            .dataflow(decoupled=True, max_sample_staleness=STALENESS)
            .debugging(seed=7).resources(device=device)
            .runtime(runtime))


def _events_since(seq: int, prefix: str):
    return [e for e in metrics.events(prefix) if e["seq"] > seq]


def decoupled_case(device, updates: int = UPDATES) -> Dict[str, Any]:
    """-> the updates' (pull s, learn s), the failed slot, the stale
    drops, the discarded batches, the events' counts, and the first
    update's largest differences from the CPU's."""
    runtime = rc.LocalRuntime()
    seq = max([e["seq"] for e in metrics.events()] or [0])
    algo = decoupled_config(device, runtime).build()
    first = {}
    update = algo.learner.update_from_batch

    def recorded(batch):
        if not first:
            first["batch"] = copy.deepcopy(batch)
        out = update(batch)
        if "metrics" not in first:
            first["metrics"] = dict(out)
            first["weights"] = algo.learner.get_host_weights()
        return out

    algo.learner.update_from_batch = recorded
    rows = []
    fleet = algo.dataflow.fleet
    failed_slot = None
    jumped = None
    try:
        deadline = time.monotonic() + DEADLINE_S
        while len(rows) < updates:
            if time.monotonic() > deadline:
                raise AssertionError(f"{len(rows)} of {updates} updates in "
                                     f"{DEADLINE_S} s: {algo.dataflow.stats()}")
            if failed_slot is None and len(rows) >= updates // 3:
                failed_slot = 0
                fleet.snapshot()[failed_slot]["handle"].fail()
            if jumped is None and len(rows) >= 2 * updates // 3:
                # a restored checkpoint far ahead of the fleet
                algo.policy_version += STALENESS + 1
                jumped = algo.policy_version
            r = algo.train()
            if r.get("num_episodes"):
                rows.append((r["wait_seconds"], r["learn_seconds"]))
            else:
                time.sleep(0.005)
        flow = algo.dataflow.stats()
        held = actors.results([s["handle"].get_weights.remote()
                               for s in fleet.snapshot().values()])
    finally:
        algo.stop()
        runtime.shutdown()
    dev_type = str(device).split(":")[0]
    for weights in held:
        if {v.device.type for v in weights.values()} != {dev_type}:
            raise AssertionError("a runner holds its weights off its device")
    if flow["fleet_restarts"] != 1 or flow["fleet_deaths"] != 1:
        raise AssertionError(f"the failed runner: {flow}")
    if flow["stale_dropped"] < 1:
        raise AssertionError(f"no stale drop after the version jump: {flow}")
    counts = {t: len(_events_since(seq, t)) for t in (
        "rl.learner_step", "rl.runner_dead", "rl.runner_respawn",
        "rl.stale_drop", "rl.weights_broadcast")}
    want = {"rl.learner_step": updates, "rl.runner_dead": 1,
            "rl.runner_respawn": 1, "rl.stale_drop": flow["stale_dropped"]}
    if {k: counts[k] for k in want} != want \
            or counts["rl.weights_broadcast"] <= updates:
        raise AssertionError(f"events {counts}, not {want} and more than "
                             f"{updates} broadcasts (one a step and the "
                             "stale pull's)")
    steps = [e["data"] for e in _events_since(seq, "rl.learner_step")]
    stale_trained = sum(
        s["version"] - 1 - s["min_batch_version"] > s["staleness_bound"]
        for s in steps)
    if stale_trained or [s["step"] for s in steps] != list(
            range(1, updates + 1)):
        raise AssertionError(f"{stale_trained} stale batches trained on; "
                             f"steps {[s['step'] for s in steps]}")
    dead = _events_since(seq, "rl.runner_dead")[0]["data"]
    if dead["runner"] != failed_slot or dead["incarnation"] != 0:
        raise AssertionError(f"rl.runner_dead {dead}")

    # the first update against the same pulled batch on the CPU
    cpu = VTraceLearner(algo.module_spec,
                        dict(algo.config.to_dict(), device="cpu"))
    want_metrics = cpu.update_from_batch(first["batch"])
    err_m = rc.close(first["metrics"], want_metrics)
    err_w = rc.close(first["weights"], cpu.get_host_weights())
    return {"updates": rows, "failed_slot": failed_slot,
            "jumped_to": jumped, "stale_dropped": flow["stale_dropped"],
            "discarded_dead": flow["discarded_dead"],
            "env_steps_trained": flow["env_steps_trained"],
            "events": counts, "stale_trained": stale_trained,
            "max_abs_err_first_update_metrics": err_m,
            "max_abs_err_first_update_weights": err_w}


# -- (s-3): lower_to_jit's stand-in nodes --------------------------------------
#
# The class names and attributes of `ray_tpu.dag`'s nodes that
# `dag.lower_to_jit` reads, and `remote(fn).bind(...)` to build them, for a
# process without the runtime. They run nothing remotely; `dag.evaluate`
# runs them eagerly. `workflow_dag` and `diamond_dag` build two DAGs of
# operator-only functions with any package's `remote`, `InputNode` and
# `MultiOutputNode`: these stand-ins', or the runtime's (where they run
# under JAX as well as torch).

class DAGNode:
    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    def _children(self) -> List["DAGNode"]:
        return [a for a in list(self._bound_args)
                + list(self._bound_kwargs.values())
                if isinstance(a, DAGNode)]


class InputNode(DAGNode):
    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _project(self, value):
        return value[self._key]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})


class _RemoteFunction:
    def __init__(self, fn):
        self._function = fn

    def bind(self, *args, **kwargs) -> "FunctionNode":
        return FunctionNode(self, args, kwargs)


class FunctionNode(DAGNode):
    def __init__(self, remote_fn: _RemoteFunction, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn


class ClassMethodNode(DAGNode):
    """An actor method's node: `lower_to_jit` refuses it."""


def remote(fn) -> _RemoteFunction:
    return _RemoteFunction(fn)


# -- two DAGs of operator-only functions ---------------------------------------

def _scale(x):
    return x * 2.0


def _shift(x):
    return x + 1.0


def _combine(a, b):
    return a @ b.T


def _gate(a, b, *, w):
    return (a - b) * w


def _mix(a, b):
    return a * b + a


def workflow_dag(remote_, input_node, multi_output):
    """`tests/test_workflow_dag.py`'s DAG: s = scale(x);
    [combine(s, shift(s)), s], with s shared. Input: a square matrix."""
    scale, shift, combine = (remote_(f) for f in (_scale, _shift, _combine))
    with input_node() as inp:
        s = scale.bind(inp)
        return multi_output([combine.bind(s, shift.bind(s)), s])


def diamond_dag(remote_, input_node, multi_output):
    """x, y = inp["x"], inp["y"]; a = scale(x); b = shift(a);
    c = gate(a, y, w=a); [mix(b, c), combine(c, b)]. Input: a dict of two
    matrices of one shape."""
    scale, shift, gate, mix, combine = (
        remote_(f) for f in (_scale, _shift, _gate, _mix, _combine))
    with input_node() as inp:
        a = scale.bind(inp["x"])
        b = shift.bind(a)
        c = gate.bind(a, inp["y"], w=a)
        return multi_output([mix.bind(b, c), combine.bind(c, b)])
