"""The port's card advertisement on the runtime's nodes, on the CPU.

`nvidia.node_advertisement` is held beside the JAX package's
`apply_tpu_detection` (which its raylet runs): the caller's values win, a
host without cards gets nothing, the typed resource equals the count, the
allotment is honoured. The probe runs in a process of its own: this one
never initialises CUDA, and a probe that crashes or times out raises.

Then the runtime's own placement: a `Cluster` of two nodes, each started
with the advertisement of two cards (from an injected `GpuInfo`, through
`add_node(resources=, labels=)`) and with the markers of a two-chip TPU
host (`accelerator_env`). The runtime's `DataParallelTrainer` runs four
workers at {"GPU": 1} with the port's `TorchConfig(device="cpu")`, and
four at `ScalingConfig(use_tpu=True)` with JAX's default backend: each
node gets two workers, every worker's node rank and local rank are JAX's,
and the local rank (the card `TorchBackend` binds) stays below the node's
cards. A fifth worker places for neither package, nor does a gang pinned
to a part the nodes do not have. `accelerator_ids` gives each worker, and
each task given cards, as many as `get_accelerator_ids` gives JAX's chips.
"""

import json
import subprocess
import sys
import types

import pytest
import torch

import ray_tpu
from ray_tpu._private.accelerators import apply_tpu_detection
from ray_tpu.air import RunConfig, ScalingConfig
from ray_tpu.cluster_utils import Cluster
from ray_tpu.train import DataParallelTrainer
from ray_tpu.util.placement_group import (placement_group,
                                          remove_placement_group)
from ray_tpu_torch._private import backend_probe, gang
from ray_tpu_torch._private.accelerators import nvidia
from ray_tpu_torch.train import TorchConfig

H100 = "NVIDIA H100 80GB HBM3"
TWO_CARDS = nvidia.GpuInfo(2, (H100, H100), (85_000_000_000,) * 2)
LABEL = nvidia.ACCELERATOR_TYPE_LABEL


def _tpu_host(worker_id: int, chips: int = 2) -> dict:
    """The markers of host `worker_id` of a two-host slice of `chips`
    chips a host (tests/test_tpu_topology.py's form)."""
    return {"TPU_ACCELERATOR_TYPE": "v5litepod-4", "TPU_NAME": "slice-a",
            "TPU_WORKER_ID": str(worker_id), "TPU_WORKER_HOSTNAMES": "h0,h1",
            "TPU_CHIPS_PER_HOST_BOUNDS": f"{chips},1,1"}


# -- the advertisement's contract, beside apply_tpu_detection's ---------------

def test_the_advertisement_adds_the_cards_their_part_and_its_label():
    given_res, given_lab = {"CPU": 8.0}, {"zone": "a"}
    res, lab = nvidia.node_advertisement(given_res, given_lab,
                                         info=TWO_CARDS, env={})
    assert res == {"CPU": 8.0, "GPU": 2.0, "GPU-H100-SXM": 2.0}
    assert lab == {"zone": "a", LABEL: "H100 SXM"}
    assert (given_res, given_lab) == ({"CPU": 8.0}, {"zone": "a"})
    # JAX's: the chips and the typed TPU-<type> at the same count
    tres, tlab = {"CPU": 8.0}, {}
    info = apply_tpu_detection(tres, tlab, env=_tpu_host(1))
    assert tres["TPU"] == tres[f"TPU-{info.accelerator_type}"] == 2.0
    assert res["GPU"] == res[nvidia.typed_resource(TWO_CARDS)] == tres["TPU"]
    # a card the peak table does not know keeps its own name
    other = nvidia.GpuInfo(1, ("Some Other GPU",), (1,))
    assert nvidia.node_advertisement(info=other, env={})[0] == {
        "GPU": 1.0, "GPU-Some-Other-GPU": 1.0}


def test_the_callers_values_win_as_they_do_for_apply_tpu_detection():
    res, lab = nvidia.node_advertisement(
        {"GPU": 1.0}, {LABEL: "mine"}, info=TWO_CARDS, env={})
    assert res == {"GPU": 1.0, "GPU-H100-SXM": 1.0}  # typed = advertised
    assert lab == {LABEL: "mine"}
    res, _ = nvidia.node_advertisement({"GPU-H100-SXM": 0.0},
                                       info=TWO_CARDS, env={})
    assert res == {"GPU": 2.0, "GPU-H100-SXM": 0.0}
    tres = {"TPU": 8.0}
    apply_tpu_detection(tres, {}, env=_tpu_host(1))
    assert tres["TPU"] == 8.0


def test_a_host_without_cards_is_left_as_it_was():
    res, lab = nvidia.node_advertisement({"CPU": 4.0}, {"zone": "a"})
    assert (res, lab) == ({"CPU": 4.0}, {"zone": "a"})  # probed: no CUDA
    assert nvidia.node_advertisement(info=TWO_CARDS, env={
        "CUDA_VISIBLE_DEVICES": ""}) == ({}, {})
    tres, tlab = {"CPU": 4.0}, {}
    assert apply_tpu_detection(tres, tlab, env={}) is None
    assert (tres, tlab) == ({"CPU": 4.0}, {})


@pytest.mark.parametrize("allot,count", [
    ("1", 1), ("1,0", 2), ("0,1,5", 2), ("5,0", 0), ("-1", 0), (" 0 ", 1)])
def test_the_allotment_is_honoured(allot, count):
    res, _ = nvidia.node_advertisement(
        info=TWO_CARDS, env={"CUDA_VISIBLE_DEVICES": allot})
    assert res == ({"GPU": float(count), "GPU-H100-SXM": float(count)}
                   if count else {})


def test_an_allotment_by_uuid_needs_the_probe():
    with pytest.raises(ValueError, match="UUID"):
        nvidia.node_advertisement(info=TWO_CARDS, env={
            "CUDA_VISIBLE_DEVICES": "GPU-5a7c"})
    # JAX's allotment, TPU_VISIBLE_CHIPS, counts the same way by index
    tres = {}
    apply_tpu_detection(tres, {}, env={"TPU_ACCELERATOR_TYPE": "v4-16",
                                       "TPU_NAME": "s",
                                       "TPU_VISIBLE_CHIPS": "0,1"})
    assert tres["TPU"] == 2.0


# -- the probe ----------------------------------------------------------------

def test_the_probe_runs_in_a_process_of_its_own(monkeypatch):
    def no_cuda_here(*_, **__):
        raise AssertionError("the calling process touched CUDA")

    for name in ("is_available", "device_count", "get_device_properties",
                 "init", "_lazy_init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda_here)
    assert nvidia.node_advertisement({"CPU": 1.0}) == ({"CPU": 1.0}, {})
    assert not torch.cuda.is_initialized()
    # what the probe process answers is what the node advertises
    fake = ("import json, os; print('noise'); print(json.dumps("
            "[[os.environ['CARD'], 1]] * int(os.environ['N'])))")
    monkeypatch.setattr(backend_probe, "_PROBE", fake)
    env = {"CARD": "NVIDIA H100 PCIe", "N": "3"}
    assert backend_probe.probe_cards(env=env) == [("NVIDIA H100 PCIe", 1)] * 3
    res, lab = nvidia.node_advertisement(env=env)
    assert res == {"GPU": 3.0, "GPU-H100-PCIe": 3.0}
    assert lab == {LABEL: "H100 PCIe"}
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("code,match", [
    ("import sys; sys.exit(3)", "exit code 3"),
    ("import time; time.sleep(60)", "no answer within"),
    ("print('no list')", "printed no list")])
def test_a_probe_that_fails_raises_and_never_reads_as_no_card(
        monkeypatch, code, match):
    monkeypatch.setattr(backend_probe, "_PROBE", code)
    monkeypatch.setattr(backend_probe, "PROBE_TIMEOUT_S", 3.0)
    with pytest.raises(RuntimeError, match=match):
        backend_probe.probe_cards()
    with pytest.raises(RuntimeError, match=match):
        nvidia.node_advertisement({"CPU": 1.0})
    with pytest.raises(RuntimeError, match=match):
        backend_probe.cuda_device_count()
    assert not backend_probe.backend_alive(1)


def test_the_command_prints_the_advertisement_as_json():
    for args, want in (([], {}), (["--labels"], {})):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch._private.accelerators",
             *args], capture_output=True, text=True, timeout=120, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1]) == want


def test_accelerator_ids_read_the_allotment_or_the_assigned_count():
    ctx = types.SimpleNamespace(get_assigned_resources=lambda: {"GPU": 2.0})
    assert nvidia.accelerator_ids(ctx, env={}) == {"GPU": ["0", "1"]}
    assert nvidia.accelerator_ids(ctx, env={
        "CUDA_VISIBLE_DEVICES": "4, 6"}) == {"GPU": ["4", "6"]}
    none = types.SimpleNamespace(get_assigned_resources=lambda: {})
    assert nvidia.accelerator_ids(none, env={
        "CUDA_VISIBLE_DEVICES": ""}) == {"GPU": []}


# -- placement on the runtime's nodes ----------------------------------------------

@pytest.fixture(scope="module")
def two_nodes():
    """Two nodes, each advertising two cards (the port's advertisement
    through the runtime's own arguments) and two TPU chips."""
    cluster = Cluster(initialize_head=False)
    for worker_id in (0, 1):
        res, lab = nvidia.node_advertisement({"CPU": 4.0}, info=TWO_CARDS,
                                             env={})
        cluster.add_node(resources=res, labels=lab,
                         accelerator_env=_tpu_host(worker_id))
    cluster.wait_for_nodes()
    cluster.connect()
    yield cluster
    cluster.shutdown()


def _place_fn():
    """The train function: each worker writes where it runs, by value
    (the workers cannot import this module)."""

    def train_fn(config):
        import json
        import os

        import ray_tpu
        from ray_tpu import train

        ctx = train.get_context()
        rt_ctx = ray_tpu.get_runtime_context()
        if config["port"]:
            from ray_tpu_torch._private.accelerators.nvidia import (
                accelerator_ids)

            ids = accelerator_ids(rt_ctx)
        else:
            ids = rt_ctx.get_accelerator_ids()
        with open(os.path.join(config["out"],
                               f"{ctx.get_world_rank()}.json"), "w") as f:
            json.dump({"node": rt_ctx.get_node_id(),
                       "node_rank": ctx.get_node_rank(),
                       "local_rank": ctx.get_local_rank(),
                       "local_world": ctx.get_local_world_size(),
                       "ids": ids}, f)
        train.report({"ok": 1})

    return train_fn


def _placed(tmp_path, name, port, scaling, backend_config=None):
    out = tmp_path / name
    out.mkdir()
    DataParallelTrainer(
        _place_fn(), train_loop_config={"out": str(out), "port": port},
        backend_config=backend_config, scaling_config=scaling,
        run_config=RunConfig(storage_path=str(tmp_path / f"runs_{name}"))
    ).fit()
    return [json.loads((out / f"{r}.json").read_text()) for r in range(4)]


def test_the_gang_places_two_workers_a_node_as_jax_does(two_nodes, tmp_path):
    nodes = {n["NodeID"]: n for n in ray_tpu.nodes() if n["Alive"]}
    assert len(nodes) == 2
    for n in nodes.values():
        assert n["Resources"]["GPU"] == n["Resources"]["GPU-H100-SXM"] == 2
        assert n["Resources"]["TPU"] == 2 and n["Labels"][LABEL] == "H100 SXM"
    port = _placed(tmp_path, "port", True, ScalingConfig(
        num_workers=4, resources_per_worker={"GPU": 1}),
        TorchConfig(device="cpu"))
    jax = _placed(tmp_path, "jax", False,
                  ScalingConfig(num_workers=4, use_tpu=True))
    for run in (port, jax):
        per_node = [sum(w["node"] == n for w in run) for n in nodes]
        assert per_node == [2, 2]
        # the card each worker binds (TorchBackend: its local rank from the
        # workers' nodes) is the runtime's local rank, below the node's two
        assert gang.local_ranks([w["node"] for w in run]) == [
            w["local_rank"] for w in run]
        assert all(w["local_rank"] < 2 and w["local_world"] == 2
                   for w in run)
    assert [(w["node_rank"], w["local_rank"]) for w in port] == [
        (w["node_rank"], w["local_rank"]) for w in jax]
    # inside a train worker (an actor's call) the runtime assigns none
    assert [len(w["ids"]["GPU"]) for w in port] == [
        len(w["ids"]["TPU"]) for w in jax]


def test_accelerator_ids_count_what_the_runtime_assigned(two_nodes):
    @ray_tpu.remote
    def ids(port):
        ctx = ray_tpu.get_runtime_context()
        if port:
            from ray_tpu_torch._private.accelerators.nvidia import (
                accelerator_ids)

            return accelerator_ids(ctx)
        return ctx.get_accelerator_ids()

    for n in (1, 2):
        port = ray_tpu.get(ids.options(resources={"GPU": n}).remote(True),
                           timeout=120)
        jax = ray_tpu.get(ids.options(resources={"TPU": n}).remote(False),
                          timeout=120)
        assert port == {"GPU": [str(i) for i in range(n)]}
        assert len(port["GPU"]) == len(jax["TPU"]) == n


@pytest.mark.parametrize("bundle", [
    {"CPU": 1.0, "GPU": 1.0}, {"CPU": 1.0, "TPU": 1.0},
    {"CPU": 1.0, "GPU": 1.0, "GPU-H100-SXM": 1.0}])
def test_a_fifth_worker_does_not_place_for_either_package(two_nodes,
                                                           bundle):
    pg = placement_group([bundle] * 5, strategy="PACK")
    try:
        assert pg.wait(timeout_seconds=3) is False
    finally:
        remove_placement_group(pg)
    pg = placement_group([bundle] * 4, strategy="PACK")
    try:
        assert pg.wait(timeout_seconds=30)
    finally:
        remove_placement_group(pg)


def test_a_gang_pinned_to_another_part_does_not_place(two_nodes):
    pg = placement_group([{"CPU": 1.0, "GPU": 1.0, "GPU-H100-PCIe": 1.0}],
                         strategy="PACK")
    try:
        assert pg.wait(timeout_seconds=3) is False
    finally:
        remove_placement_group(pg)
