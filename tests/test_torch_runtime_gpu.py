"""`num_gpus` leases of the port's runtime bound to cards, on a CPU node
that advertises two fake ones (no CUDA needed).

The node is started with `resources={"GPU": 2}` and a fake
`nvidia.GpuInfo` of two H100s in place of the probe, so the raylet
advertises `GPU`, the typed `GPU-H100-SXM` and the accelerator-type label.
Each lease of whole cards binds its worker to distinct cards through
CUDA_VISIBLE_DEVICES, which `get_accelerator_ids()` reads back; a lease
that finds no free card waits for one; a worker bound to one card never
serves a lease of another; card workers are direct spawns of the raylet,
never forks of the zygote; a plain worker sees no card. The JAX runtime on the same script with `TPU`
in place of `GPU` gives the same counts from `get_accelerator_ids`.
"""

import os
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch._private.accelerators import nvidia

FAKE_CARDS = nvidia.GpuInfo(2, ("NVIDIA H100 80GB HBM3",) * 2,
                            (85899345920,) * 2)


def _accelerator_counts(api, accel):
    """Two tasks of one card each: the count of ids each one sees."""
    @api.remote(**{f"num_{accel.lower()}s": 1})
    def ids():
        return api.get_runtime_context().get_accelerator_ids()

    return [len(i[accel])
            for i in api.get([ids.remote() for _ in range(2)], timeout=60)]


@pytest.fixture(scope="module")
def node():
    # the JAX runtime first, on the same script with TPU in place of GPU;
    # never both runtimes at once
    ray_tpu.init(num_cpus=4, resources={"TPU": 2})
    try:
        jax_counts = _accelerator_counts(ray_tpu, "TPU")
    finally:
        ray_tpu.shutdown()
    saved = os.environ.pop("CUDA_VISIBLE_DEVICES", None)  # no allotment
    rt.init(num_cpus=4, resources={"GPU": 2}, _gpu_info=FAKE_CARDS)
    try:
        yield {"jax_counts": jax_counts}
    finally:
        rt.shutdown()
        if saved is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


@rt.remote(num_gpus=1)
class Card:
    def where(self):
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "ids": rt.get_runtime_context().get_accelerator_ids(),
                "pid": os.getpid(), "ppid": os.getppid()}


@rt.remote(num_gpus=1)
def card_task():
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "ppid": os.getppid()}


@rt.remote
def plain_task():
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "ppid": os.getppid(),
            "ids": rt.get_runtime_context().get_accelerator_ids()}


@rt.remote
class Plain:
    def where(self):
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "ids": rt.get_runtime_context().get_accelerator_ids()}


def test_the_fake_cards_become_the_nodes_resources_and_label(node):
    res = rt.cluster_resources()
    assert res["GPU"] == 2.0 and res["GPU-H100-SXM"] == 2.0
    (info,) = rt.nodes()
    assert info["Labels"][nvidia.ACCELERATOR_TYPE_LABEL] == "H100 SXM"


def test_two_gpu_actors_see_different_cards(node):
    actors = [Card.remote(), Card.remote()]
    try:
        seen = rt.get([a.where.remote() for a in actors], timeout=60)
    finally:
        for a in actors:
            rt.kill(a)
    assert sorted(s["visible"] for s in seen) == ["0", "1"]
    for s in seen:
        assert s["ids"] == {"GPU": [s["visible"]]}
    assert len({s["pid"] for s in seen}) == 2


def test_a_third_lease_waits_for_a_freed_card(node):
    actors = [Card.remote(), Card.remote()]
    seen = rt.get([a.where.remote() for a in actors], timeout=60)
    waiting = card_task.remote()
    ready, _ = rt.wait([waiting], num_returns=1, timeout=1.5)
    assert ready == []  # both cards are held
    freed = seen[0]["visible"]
    rt.kill(actors[0])
    try:
        got = rt.get(waiting, timeout=60)
    finally:
        rt.kill(actors[1])
    assert got["visible"] == freed


def _wait_for(cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_a_worker_of_one_card_never_serves_another(node):
    raylet = rt.api._global_node.raylet  # in this process: read its state
    free = {0: 1.0, 1: 1.0}
    _wait_for(lambda: raylet._card_free == free)  # earlier kills landed
    holder = Card.remote()  # the lowest free card, 0
    held = rt.get(holder.where.remote(), timeout=60)["visible"]
    first = rt.get(card_task.remote(), timeout=60)  # on the other card
    assert (held, first["visible"]) == ("0", "1")
    # the driver gives its idle lease back (worker_lease_idle_timeout_ms)
    # and the kill frees the held card: both cards free, first's worker
    # idle in the pool and bound to its card
    rt.kill(holder)
    _wait_for(lambda: raylet._card_free == free)
    bound = {w.pid: w.cards for w in list(raylet.worker_pool._workers.values())
             if w.state == "idle"}
    assert bound[first["pid"]] == (int(first["visible"]),)
    second = rt.get(card_task.remote(), timeout=60)
    # the lowest free card is the freed one: a fresh worker takes it, and
    # the idle worker of the other card is not handed out
    assert second["visible"] == held
    assert second["pid"] != first["pid"]


def test_card_workers_are_direct_spawns_never_zygote_forks(node):
    # the raylet runs in this process: a direct spawn is its child, a
    # fork is the zygote's
    card = rt.get(card_task.remote(), timeout=60)
    plain = rt.get(plain_task.remote(), timeout=60)
    assert card["ppid"] == os.getpid()
    assert plain["ppid"] != os.getpid()
    assert plain["ids"] == {"GPU": []}


def test_a_plain_worker_sees_no_card(node):
    # num_gpus=0 work cannot reach a card outside the lease accounting
    task = rt.get(plain_task.remote(), timeout=60)
    actor = Plain.remote()
    try:
        held = rt.get(actor.where.remote(), timeout=60)
    finally:
        rt.kill(actor)
    for seen in (task, held):
        assert seen["visible"] == ""
        assert seen["ids"] == {"GPU": []}


def test_fractional_leases_share_a_card(node):
    @rt.remote(num_gpus=0.5)
    class Half:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    halves = [Half.remote() for _ in range(2)]
    try:
        seen = rt.get([h.visible.remote() for h in halves], timeout=60)
        whole = rt.get(card_task.remote(), timeout=60)["visible"]
    finally:
        for h in halves:
            rt.kill(h)
    assert seen[0] == seen[1]  # packed on one card
    assert whole != seen[0]    # the other card stays whole


def test_num_gpus_above_one_must_be_whole():
    with pytest.raises(ValueError, match="whole number"):
        rt.remote(num_gpus=1.5)(card_task._function)


def test_the_jax_runtime_gives_the_same_counts(node):
    assert _accelerator_counts(rt, "GPU") == node["jax_counts"] == [1, 1]
