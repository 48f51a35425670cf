"""DAGs of pure functions fused into one compiled program: the port's
counterpart of `ray_tpu/dag/__init__.py` `lower_to_jit` (:257-308).

`lower_to_jit(dag)` takes a DAG of the runtime's nodes (built with its
`.bind()` and `InputNode` / `MultiOutputNode`) whose function nodes are
side-effect-free tensor functions, and returns one `torch.compile`
program of the whole graph (JAX: one `jax.jit`): no per-stage dispatch,
and a subgraph that several nodes share is computed once. Actor nodes
(`ClassNode`, `ClassMethodNode`) hold process state and cannot fuse: they
raise TypeError, as in JAX.

The port imports nothing of `ray_tpu.dag`: it tells the nodes by their
class names (anywhere in the MRO) and reads what JAX's `lower_to_jit`
reads: `_children()`, `_bound_args`, `_bound_kwargs`, an
`InputAttributeNode`'s `_project` and a `FunctionNode`'s
`_remote_fn._function`. The graph is walked once, when it is
lowered, into a plan in topological order; the compiled program runs the
plan, so the compiler sees only the functions and the input.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["evaluate", "lower_to_jit"]

# The one argument of the fused function (JAX: `fused(x)`).
ARGNAME = "x"


def _kinds(node) -> set:
    return {c.__name__ for c in type(node).__mro__}


def _is_node(value) -> bool:
    return "DAGNode" in _kinds(value)


def _plan(dag) -> List[Tuple[str, Any, tuple, dict]]:
    """The DAG's nodes in topological order, each once: (kind, payload,
    args, kwargs), an argument a ("node", position in the plan) or a
    ("const", value). Raises TypeError at an actor node or a node it
    cannot lower."""
    plan: List[Tuple[str, Any, tuple, dict]] = []
    index: Dict[int, int] = {}

    def check(node) -> None:
        kinds = _kinds(node)
        if kinds & {"ClassNode", "ClassMethodNode"}:
            raise TypeError(
                "lower_to_jit supports pure-function DAGs only; "
                f"found {type(node).__name__}")
        for c in node._children():
            check(c)

    def arg(value):
        return ("node", visit(value)) if _is_node(value) else ("const",
                                                               value)

    def visit(node) -> int:
        if id(node) in index:
            return index[id(node)]
        kinds = _kinds(node)
        if "InputNode" in kinds:
            step = ("input", None, (), {})
        elif "InputAttributeNode" in kinds:
            step = ("project", node._project, (), {})
        elif "MultiOutputNode" in kinds:
            step = ("outputs", None, tuple(arg(o) for o in node._bound_args),
                    {})
        elif "FunctionNode" in kinds:
            step = ("call", node._remote_fn._function,
                    tuple(arg(a) for a in node._bound_args),
                    {k: arg(v) for k, v in node._bound_kwargs.items()})
        else:
            raise TypeError(f"cannot lower {type(node).__name__}")
        plan.append(step)
        index[id(node)] = len(plan) - 1
        return index[id(node)]

    check(dag)
    visit(dag)
    return plan


def _runner(plan) -> Callable[[Any], Any]:
    """The plan as a function of the input: the fused program's body."""

    def fused(x):
        vals: List[Any] = []

        def get(spec):
            kind, v = spec
            return vals[v] if kind == "node" else v

        for kind, payload, args, kwargs in plan:
            if kind == "input":
                out = x
            elif kind == "project":
                out = payload(x)
            elif kind == "outputs":
                out = [get(a) for a in args]
            else:
                out = payload(*[get(a) for a in args],
                              **{k: get(v) for k, v in kwargs.items()})
            vals.append(out)
        return vals[-1]

    return fused


def evaluate(dag, x):
    """The DAG on `x` eagerly, each shared node once: the plain version
    that `lower_to_jit`'s program is held against."""
    return _runner(_plan(dag))(x)


def _holds_tensor(value) -> bool:
    if torch.is_tensor(value):
        return True
    if isinstance(value, (list, tuple)):
        return any(_holds_tensor(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_tensor(v) for v in value.values())
    return False


def lower_to_jit(dag, static_argnames=None, *,
                 backend: str = "inductor") -> Callable[[Any], Any]:
    """Fuse a pure-function DAG into one `torch.compile` program;
    -> fn with fn(x) = the DAG's output on the input x.

    static_argnames names arguments of the fused function, which has one,
    "x" (JAX: `jax.jit(fused, static_argnames=...)`). "x" (or ("x",))
    makes the input a compile-time constant, as in JAX: it must be
    hashable and hold no tensor (TypeError, as JAX's unhashable array),
    and each value compiles once, which is how torch.compile already
    treats an input that holds no tensor (it guards on the value). Any
    other name raises ValueError, as JAX's does. backend: torch.compile's
    ("inductor" on the card; the CPU tests pass "aot_eager"). The program
    is one graph (fullgraph): a function that breaks it raises."""
    names = ((static_argnames,) if isinstance(static_argnames, str)
             else tuple(static_argnames or ()))
    bad = set(names) - {ARGNAME}
    if bad:
        raise ValueError(f"lower_to_jit's fused function takes one "
                         f"argument, {ARGNAME!r}; static_argnames {bad} "
                         "name none")
    static = ARGNAME in names
    compiled = torch.compile(_runner(_plan(dag)), backend=backend,
                             fullgraph=True)

    def run(x):
        if static:
            hash(x)
            if _holds_tensor(x):
                raise TypeError("a static argument cannot hold a tensor "
                                "(JAX: non-hashable static arguments are "
                                "not supported)")
        return compiled(x)

    return run
