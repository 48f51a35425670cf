"""Collective report of a compiled program: what a sharded step moves.

Counterpart of `ray_tpu/parallel/hlo_report.py`, with its name and its
result: {kind: {"count", "bytes"}} for "all-reduce", "all-gather",
"reduce-scatter", "collective-permute" and "all-to-all", plus "total",
where bytes are the collectives' RESULT buffer sizes (a consistent proxy
for traffic; the wire bytes depend on the algorithm and the topology).

It reads no HLO: there is none. It reads the AOTAutograd graphs that
torch.compile hands its compiler, the forward and the backward of each
program (the inference graph of one without gradients), as they are
before inductor's own passes. The compiled step (`train.step.make_train_step(...,
compiled=True)`) builds two programs, the loss with its backward and the
update with the global norm's all-reduce; `recording` is the backend that
notes each graph's collectives while it compiles them, and the step's
`lower(state, batch)` hook (the counterpart of the `.lower` JAX's report
prefers) hands them over, compiling a program first (and leaving the
state as it was) only where the step has not run yet.

What it counts: the functional collectives (`_c10d_functional`
all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
all_to_all_single, coalesced forms included), which DTensor and the
port's `funcol` calls become; the port's own collective operators,
`ray_tpu_torch::all_to_all` as an all-to-all and `all_reduce_sum` /
`group_mean` as all-reduces (`parallel/moe.py`); and the sp ring,
`ray_tpu_torch::ring_fwd` / `ring_bwd` (`parallel/ring_attention.py`),
whose point-to-point sends are work hidden inside one operator. A ring
of n ranks is counted as collective-permutes worked out from the
operator's inputs: one per tensor moved a hop, its bytes the tensor's.
The forward moves K and V n - 1 hops (2(n - 1) permutes, (n - 1)(|K| +
|V|) bytes); the backward moves K and V n - 1 hops and the fp32 partial
dK and dV n hops, the last one home to the block's owner (2(n - 1) + 2n
permutes, (n - 1)(|K| + |V|) + 4n(#K + #V) bytes).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")

# operator name (namespace::name, no overload) -> kind
_KINDS = {}
for _ns in ("_c10d_functional", "c10d_functional"):
    _KINDS.update({
        f"{_ns}::all_reduce": "all-reduce",
        f"{_ns}::all_reduce_": "all-reduce",
        f"{_ns}::all_reduce_coalesced": "all-reduce",
        f"{_ns}::all_reduce_coalesced_": "all-reduce",
        f"{_ns}::all_gather_into_tensor": "all-gather",
        f"{_ns}::all_gather_into_tensor_out": "all-gather",
        f"{_ns}::all_gather_into_tensor_coalesced": "all-gather",
        f"{_ns}::reduce_scatter_tensor": "reduce-scatter",
        f"{_ns}::reduce_scatter_tensor_coalesced": "reduce-scatter",
        f"{_ns}::all_to_all_single": "all-to-all",
    })
_KINDS.update({
    "ray_tpu_torch::all_to_all": "all-to-all",
    "ray_tpu_torch::all_reduce_sum": "all-reduce",
    "ray_tpu_torch::group_mean": "all-reduce",
})
_RINGS = ("ray_tpu_torch::ring_fwd", "ray_tpu_torch::ring_bwd")


def _nbytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (list, tuple)):
        return sum(_nbytes(v) for v in val)
    return 0


def _meta(arg):
    return arg.meta.get("val") if hasattr(arg, "meta") else None


def _ring_size(group: str) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_world_size(_resolve_process_group(group))


def _ring(op: str, node) -> Dict[str, Any]:
    """The collective-permutes a ring operator node moves (module
    docstring)."""
    k, v = _meta(node.args[1]), _meta(node.args[2])
    group = node.args[3] if op.endswith("fwd") else node.args[6]
    n = _ring_size(group)
    kv = _nbytes(k) + _nbytes(v)
    count, nbytes = 2 * (n - 1), (n - 1) * kv
    if op.endswith("bwd") and n > 1:
        count += 2 * n
        nbytes += 4 * n * (k.numel() + v.numel())
    return {"op": op, "kind": "collective-permute", "count": count,
            "bytes": nbytes, "numel": k.numel() + v.numel()}


def graph_collectives(gm) -> List[Dict[str, Any]]:
    """The collectives of an AOTAutograd graph (and of the graphs it holds),
    in order: per node {"op", "kind", "count", "bytes" (result buffers),
    "numel" (result elements)}."""
    out = []
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            schema = getattr(node.target, "_schema", None)
            if node.op != "call_function" or schema is None:
                continue
            op = schema.name
            if op in _RINGS:
                out.append(_ring(op, node))
            elif op in _KINDS:
                val = _meta(node)
                vals = val if isinstance(val, (list, tuple)) else [val]
                out.append({"op": op, "kind": _KINDS[op], "count": 1,
                            "bytes": _nbytes(val),
                            "numel": sum(x.numel() for x in vals
                                         if isinstance(x, torch.Tensor))})
    return out


def _has_collectives(gm, example_inputs) -> bool:
    """Whether a Dynamo graph is one whose collectives a report may ask
    for: it takes DTensors or calls a collective."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in example_inputs):
        return True
    ours = tuple(op.replace("::", ".") for op in (*_KINDS, *_RINGS)
                 if op.startswith("ray_tpu_torch"))
    for node in gm.graph.nodes:
        target = str(node.target)
        if ("c10d" in target or "functional_collectives" in target
                or target.startswith(ours)):
            return True
    return False


def recording(backend: str, programs: List[List[Dict[str, Any]]],
              options: Optional[Dict[str, Any]] = None) -> Callable:
    """A torch.compile backend that compiles as `backend` ("inductor", with
    the inductor `options`, or "aot_eager") and appends to `programs`, per
    compile, the collectives of each AOTAutograd graph it compiles
    (`graph_collectives`). A program with collectives is compiled past
    AOTAutograd's cache, since a program loaded from it hands no graph to
    note; the others keep the cache. Any other backend compiles as it is
    and notes nothing."""
    if backend not in ("inductor", "aot_eager"):
        return backend

    def compile_program(gm, example_inputs):
        found: List[Dict[str, Any]] = []
        programs.append(found)

        def note(compile_graph):
            def compile_noted(graph, inputs, *args, **kwargs):
                found.extend(graph_collectives(graph))
                return compile_graph(graph, inputs, *args, **kwargs)
            return compile_noted

        if backend == "aot_eager":
            from torch._dynamo.backends.common import aot_autograd
            from torch._dynamo.backends.debugging import boxed_nop
            from torch._functorch.partitioners import (
                min_cut_rematerialization_partition)

            compiler = aot_autograd(
                fw_compiler=note(boxed_nop), bw_compiler=note(boxed_nop),
                partition_fn=min_cut_rematerialization_partition,
                keep_inference_input_mutations=True)
        else:
            from torch._inductor.compile_fx import compile_fx, compile_fx_inner

            def compiler(g, inputs):
                return compile_fx(g, inputs, inner_compile=note(
                    compile_fx_inner), config_patches=options)
        if not _has_collectives(gm, example_inputs):
            return compiler(gm, example_inputs)
        with torch._functorch.config.patch(enable_autograd_cache=False):
            return compiler(gm, example_inputs)

    return compile_program


def collectives(fn: Callable, *args) -> List[Dict[str, Any]]:
    """The collectives of `fn(*args)` compiled, per node (see
    `graph_collectives`): from `fn.lower(*args)` where fn has that hook (the
    compiled step), else from compiling fn with aot_eager (fullgraph) and
    calling it once on args (its forward alone), which fn must leave as
    they were."""
    lower = getattr(fn, "lower", None)
    if lower is not None:
        return lower(*args)
    programs: List[List[Dict[str, Any]]] = []
    compiled = torch.compile(fn, backend=recording("aot_eager", programs),
                             fullgraph=True, dynamic=False)
    compiled(*args)
    return [c for program in programs for c in program]


def collective_report(fn: Callable, *args) -> Dict[str, Dict[str, int]]:
    """The collectives of `fn(*args)` compiled, by kind:
    {kind: {"count": n, "bytes": total result bytes}} plus "total"."""
    report: Dict[str, Dict[str, int]] = {
        k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for c in collectives(fn, *args):
        report[c["kind"]]["count"] += c["count"]
        report[c["kind"]]["bytes"] += c["bytes"]
    report["total"] = {
        "count": sum(v["count"] for v in report.values()),
        "bytes": sum(v["bytes"] for v in report.values()),
    }
    return report

