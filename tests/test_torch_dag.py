"""`ray_tpu_torch.dag.lower_to_jit` against the JAX package's `lower_to_jit`,
on the CPU.

The DAGs are the runtime's own nodes (`ray_tpu.remote` functions bound
under an `InputNode`), whose functions use operators only, so each serves
both packages: `tests/test_workflow_dag.py::test_dag_lower_to_jit`'s DAG
(a shared subgraph under a `MultiOutputNode`) and a diamond over an input
dict's items with a keyword argument. The port's program (compiled with
`backend="aot_eager"`, as the CPU tests compile) holds JAX's jitted one
to fp32 1e-6 on the same numpy input. A shared node runs once, an actor
node raises TypeError as in JAX, `static_argnames` names only the one
argument, and the stand-in nodes of `rllib.dataflow_cases` (the fixture of
`chip_smoke.py`'s phase (s)) lower as the runtime's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.dag import InputNode, MultiOutputNode
from ray_tpu.dag import lower_to_jit as jax_lower_to_jit
from ray_tpu_torch.dag import evaluate, lower_to_jit
from ray_tpu_torch.rllib import dataflow_cases as dc
from ray_tpu_torch.rllib.dataflow_cases import diamond_dag, workflow_dag

TOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _inputs(seed):
    r = np.random.default_rng(seed)
    return {"x": r.standard_normal((6, 5)).astype(np.float32),
            "y": r.standard_normal((6, 5)).astype(np.float32)}


CASES = {
    "workflow": (workflow_dag, lambda d: d["x"][:4, :4]),
    "diamond": (diamond_dag, lambda d: d),
}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lower_to_jit_matches_jax(name):
    build, pick = CASES[name]
    dag = build(ray_tpu.remote, InputNode, MultiOutputNode)
    x = pick(_inputs(3))
    want = jax_lower_to_jit(dag)(_to(x, jnp.asarray))
    got = lower_to_jit(dag, backend="aot_eager")(_to(x, torch.from_numpy))
    eager = evaluate(dag, _to(x, torch.from_numpy))
    assert len(got) == len(want) == len(eager) == 2
    for g, e, w in zip(got, eager, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(e.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stand_in_nodes_lower_as_the_runtimes(name):
    build, pick = CASES[name]
    x = _to(pick(_inputs(4)), torch.from_numpy)
    runtime_dag = build(ray_tpu.remote, InputNode, MultiOutputNode)
    stand_in = build(dc.remote, dc.InputNode, dc.MultiOutputNode)
    want = evaluate(runtime_dag, x)
    got = lower_to_jit(stand_in, backend="aot_eager")(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


def test_a_shared_node_runs_once():
    calls = []

    def counted(x):
        calls.append(1)
        return x * 3.0

    shared = dc.remote(counted)
    add = dc.remote(lambda a, b: a + b)
    with dc.InputNode() as inp:
        s = shared.bind(inp)
        dag = dc.MultiOutputNode([add.bind(s, s), add.bind(s, inp), s])
    out = evaluate(dag, torch.ones(3))
    assert len(calls) == 1
    assert [o.tolist() for o in out] == [[6.0] * 3, [4.0] * 3, [3.0] * 3]
    fn = lower_to_jit(dag, backend="aot_eager")
    # the compiled program replays the function's side effect once a run
    assert [o.tolist() for o in fn(torch.ones(3))][0] == [6.0] * 3
    fn(torch.full((3,), 2.0))
    assert len(calls) == 3


def test_actor_nodes_raise_type_error_as_in_jax():
    @ray_tpu.remote
    class Holder:
        def get(self, x):
            return x

    with InputNode() as inp:
        dag = ray_tpu.remote(dc._shift).bind(Holder.bind().get.bind(inp))
    with pytest.raises(TypeError, match="pure-function DAGs only"):
        jax_lower_to_jit(dag)
    with pytest.raises(TypeError, match="pure-function DAGs only"):
        lower_to_jit(dag, backend="aot_eager")
    with dc.InputNode() as inp:
        stand_in = dc.MultiOutputNode([dc.ClassMethodNode((inp,), {})])
    with pytest.raises(TypeError, match="found ClassMethodNode"):
        lower_to_jit(stand_in, backend="aot_eager")


def test_static_argnames_name_the_one_argument():
    ones = dc.remote(lambda x: torch.ones(2) * x[0] + x[1])
    with dc.InputNode() as inp:
        dag = ones.bind(inp)
    with pytest.raises(ValueError, match="static_argnames {'y'}"):
        lower_to_jit(dag, static_argnames=("y",))
    for names in ("x", ("x",)):
        fn = lower_to_jit(dag, static_argnames=names, backend="aot_eager")
        assert fn((3.0, 1.0)).tolist() == [4.0, 4.0]
        assert fn((2.0, 0.5)).tolist() == [2.5, 2.5]
        with pytest.raises(TypeError, match="cannot hold a tensor"):
            fn((torch.tensor(3.0), 1.0))
        with pytest.raises(TypeError, match="unhashable"):
            fn([3.0, 1.0])
    # JAX refuses the same names
    with pytest.raises(ValueError):
        jax_lower_to_jit(
            ray_tpu.remote(dc._shift).bind(InputNode()),
            static_argnames=("y",))
