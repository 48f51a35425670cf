"""The port's collective report (`ray_tpu_torch.parallel.hlo_report`) of its
compiled sharded steps against the JAX package's report of its jitted ones,
on the CPU.

One 4-rank gloo gang (spawned once for the file) builds each mesh
configuration's compiled sharded step (aot_eager, fullgraph) from a seeded
state and reports it before any step: the tiny fp32 Llama on dp=4, fsdp=4,
dp=2 x tp=2 and sp=2 x fsdp=2 (the ring), the tiny fp32 Mixtral on dp=2 x
ep=2. JAX's `collective_report` reports the same model's step on the same
mesh shape of 4 of the 8 virtual CPU devices. Both satisfy the signature
tests/test_parallel.py asserts of each configuration (and the ring's
collective-permutes, Mixtral's all-to-alls). dp's all-reduce bytes equal
the bytes JAX's program moves as it runs, scalars apart: JAX's report
reads HLO text, which counts an all-reduce in a while loop's body once
(XLA runs it once a layer) and misses a tuple all-reduce of six or more
operands (its `/*index=5*/` comment holds the "=" its pattern stops at);
`_executed` reads the same HLO with both taken into account. The report
leaves the caller's state as it was.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh
from ray_tpu.models import llama as jl
from ray_tpu.models import mixtral as jmx
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.hlo_report import _SHAPE_RE, _shape_bytes
from ray_tpu.parallel.hlo_report import collective_report as jax_report
from ray_tpu.parallel.sharding import LogicalAxisRules, logical_sharding
from ray_tpu.train.step import init_train_state, make_train_step
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.parallel.hlo_report import COLLECTIVES, collective_report
from ray_tpu_torch.train import backend
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 300
TOKENS = {"inputs": ("batch", "seq"), "targets": ("batch", "seq")}
# name: (family, config kwargs, mesh kwargs)
LAYERS = 2  # the tiny configs' own depth, as tests/test_parallel.py builds them
CONFIGS = {
    "dp4": ("llama", dict(n_layers=LAYERS), dict(dp=4)),
    "fsdp4": ("llama", dict(n_layers=LAYERS), dict(fsdp=4)),
    "dp2xtp2": ("llama", dict(n_layers=LAYERS), dict(dp=2, tp=2)),
    "ring-sp2xfsdp2": ("llama", dict(n_layers=LAYERS,
                                     use_ring_attention=True),
                       dict(sp=2, fsdp=2)),
    "mixtral-dp2xep2": ("mixtral", dict(n_layers=LAYERS), dict(dp=2, ep=2)),
}
JAX_MODULES = {"llama": (jl, jl.LlamaConfig), "mixtral": (jmx, jmx.MixtralConfig)}


def _batch():
    toks = np.random.default_rng(1).integers(0, 128, (8, 33))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cases = [("report_case", (family, cfg_kw, mesh_kw, _batch(), TOKENS))
             for family, cfg_kw, mesh_kw in CONFIGS.values()]
    store = tmp_path_factory.mktemp("gang") / "store"
    out = launch_gang(gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
                      args=(cases,), init_method=f"file://{store}")
    return {name: [r[i] for r in out] for i, name in enumerate(CONFIGS)}


def _group_size(line):
    """The devices in each replica group of a collective's HLO line (all
    of them where it names none)."""
    m = re.search(r"replica_groups=\{\{([0-9,]*)\}", line)
    if m:
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", line)
    return int(m.group(2)) if m else WORLD


def _executed(hlo):
    """Per kind, {"count", "bytes"} of result buffers that the optimized
    HLO moves as it runs: every collective over groups of more than one
    device, tuples whole, times the trip count of the while loops around
    it; and "scalar_all_reduce_bytes"."""
    comps, cur, entry = {}, None, None
    for line in hlo.splitlines():
        if line and not line.startswith(" ") and line.rstrip().endswith("{"):
            cur = line.split()[1 if line.startswith("ENTRY") else 0]
            cur = cur.lstrip("%")
            entry = cur if line.startswith("ENTRY") else entry
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    times = {entry: 1}
    todo = [entry]
    while todo:
        name = todo.pop()
        for line in comps[name]:
            body = re.search(r" while\(.*body=%?([\w.\-]+)", line)
            if body:
                trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
                assert trips, line
                times[body.group(1)] = times[name] * int(trips.group(1))
                todo.append(body.group(1))
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    out["scalar_all_reduce_bytes"] = 0
    kinds = "|".join(COLLECTIVES)
    for name, n in times.items():
        for line in comps[name]:
            m = re.search(rf"= (.*?) ({kinds})(-start)?\(", line)
            if m is None or _group_size(line) == 1:
                continue
            shapes = _SHAPE_RE.findall(m.group(1))
            out[m.group(2)]["count"] += n
            out[m.group(2)]["bytes"] += n * sum(_shape_bytes(d, s)
                                                for d, s in shapes)
            if m.group(2) == "all-reduce":
                out["scalar_all_reduce_bytes"] += n * sum(
                    _shape_bytes(d, s) for d, s in shapes if not s)
    return out


@pytest.fixture(scope="module")
def jax_reports():
    """Per configuration, JAX's report of its jitted sharded step and what
    the same program moves as it runs (`_executed`)."""
    out = {}
    for name, (family, cfg_kw, mesh_kw) in CONFIGS.items():
        mod, config = JAX_MODULES[family]
        cfg = dataclasses.replace(config.tiny(),
                                  dtype=jnp.float32, **cfg_kw)
        sizes = jmesh.MeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
            tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)
        rules = LogicalAxisRules()
        opt = optax.adamw(1e-3)
        state, shardings = init_train_state(
            functools.partial(mod.init, cfg), opt, mod.param_logical_axes(cfg),
            mesh, jax.random.PRNGKey(0), rules)
        bs = logical_sharding(mesh, ("batch", "seq"), rules)
        step = make_train_step(
            functools.partial(mod.loss_fn, config=cfg, mesh=mesh, rules=rules),
            opt, shardings, batch_sharding={"inputs": bs, "targets": bs})
        batch = {k: jax.device_put(v, bs) for k, v in _batch().items()}
        out[name] = {"report": jax_report(step, state, batch),
                     "executed": _executed(
                         step.lower(state, batch).compile().as_text()),
                     "params": sum(x.size for x in jax.tree.leaves(
                         state.params))}
    return out


def _signature(name, report, params):
    """tests/test_parallel.py's signature of each mesh configuration (and
    the ring's and the experts' own collectives)."""
    assert report["total"]["count"] == sum(report[k]["count"]
                                           for k in COLLECTIVES)
    if name == "dp4":  # gradients all-reduce, ~param bytes; nothing gathered
        assert report["all-reduce"]["count"] >= 1
        assert report["all-reduce"]["bytes"] >= params
        assert report["all-gather"]["count"] == 0
    elif name in ("fsdp4", "ring-sp2xfsdp2"):  # gather params, reduce grads
        assert report["all-gather"]["count"] >= 1
        assert report["all-gather"]["bytes"] > 0
        assert (report["reduce-scatter"]["count"] >= 1
                or report["all-reduce"]["count"] >= 1)
    else:  # activation reductions and the gradient sync
        assert report["total"]["count"] >= 2
        assert report["total"]["bytes"] > 0
    if name.startswith("ring"):
        assert report["collective-permute"]["count"] >= 1
    if name.startswith("mixtral"):
        assert report["all-to-all"]["count"] >= 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_both_reports_have_the_configuration_s_signature(gang, jax_reports,
                                                        name):
    for rank in range(WORLD):
        _signature(name, gang[name][rank]["report"], gang[name][rank]["params"])
    _signature(name, jax_reports[name]["report"], jax_reports[name]["params"])
    assert gang[name][0]["params"] == jax_reports[name]["params"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_report_leaves_the_state_as_it_was(gang, name):
    assert all(r["state_unchanged"] for r in gang[name])


def test_dp_all_reduce_bytes_equal_what_jax_moves(gang, jax_reports):
    """Scalars apart, dp=4's all-reduces move every gradient once: the
    parameters' fp32 bytes, as JAX's program does when it runs; JAX's
    report of the same HLO reads less (the module docstring)."""
    nodes = gang["dp4"][0]["nodes"]
    port = sum(c["bytes"] for c in nodes
               if c["kind"] == "all-reduce" and c["numel"] > 1)
    executed = jax_reports["dp4"]["executed"]
    jax_moves = (executed["all-reduce"]["bytes"]
                 - executed["scalar_all_reduce_bytes"])
    assert port == jax_moves == gang["dp4"][0]["param_bytes"]
    assert jax_reports["dp4"]["report"]["all-reduce"]["bytes"] < jax_moves


def test_fsdp_all_gathers_follow_the_shapes_and_the_remat_policy(gang):
    """Each layer's seven matrices gathered in the forward and again in the
    backward's rerun ("dots": the gathers sit in the layer's checkpoint),
    the embedding and the lm_head once, fp32."""
    d, h, kv, hd, f, v, layers = 128, 4, 2, 32, 256, 512, LAYERS
    layer = 2 * d * h * hd + 2 * d * kv * hd + 3 * d * f
    want = 4 * (2 * layers * layer + 2 * v * d)
    for rank in range(WORLD):
        assert gang["fsdp4"][rank]["report"]["all-gather"]["bytes"] == want


def test_the_ring_counts_its_hops_from_its_inputs(gang):
    """sp=2: each layer's forward (run twice under "dots") moves K and V one
    hop, its backward K and V one hop and fp32 dK and dV two."""
    b, s, kv, hd, layers, n = 8 // 2, 32 // 2, 2, 32, LAYERS, 2
    kv_bytes = 2 * b * s * kv * hd * 4
    fwd = (2 * (n - 1), (n - 1) * kv_bytes)
    bwd = (2 * (n - 1) + 2 * n, (n - 1) * kv_bytes + n * kv_bytes)
    want = {"count": layers * (2 * fwd[0] + bwd[0]),
            "bytes": layers * (2 * fwd[1] + bwd[1])}
    for rank in range(WORLD):
        assert (gang["ring-sp2xfsdp2"][rank]["report"]["collective-permute"]
                == want)


def test_a_plain_function_is_compiled_and_reported(tmp_path):
    """A function without the step's hook is compiled (aot_eager,
    fullgraph) and called once: its functional collectives by kind, result
    bytes, on a world-1 gang."""
    from torch.distributed import _functional_collectives as funcol

    backend.init_process_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        def fn(x):
            y = funcol.all_reduce(x * 2, "sum", dist.group.WORLD)
            return funcol.all_gather_tensor(y, 0, dist.group.WORLD)

        torch._dynamo.reset()
        report = collective_report(fn, torch.ones(3, 5))
    finally:
        backend.destroy_process_group()
    assert report["all-reduce"] == {"count": 1, "bytes": 60}
    assert report["all-gather"] == {"count": 1, "bytes": 60}
    assert report["total"] == {"count": 2, "bytes": 120}
