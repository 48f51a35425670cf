"""The port's collective groups declared over the runtime's actors
(`ray_tpu_torch.util.collective.create_collective_group`,
`CollectiveActorMixin`), on the CPU, and the card-binding rule of the
gang's declaring side (`ray_tpu_torch.train.backend`).

Four runtime actors mix in the port's mixin and are declared one gloo gang
with ranks [2, 0, 3, 1] (rank 0 is not the first actor): the host path on
numpy (the four reductions of a pytree, allgather, broadcast,
reducescatter, a send/recv ring, two tags received in the other order)
equals the JAX package's host path on an actor gang declared the same way,
exactly; a "mesh" group declared over the same actors keeps their gang and
runs every eager collective on integer-valued fp32 tensors exactly as
numpy computes it. The declaration's errors: a name declared twice, an
actor in a gang of another world, a join that fails on one actor (the
declaration fails at once, naming its rank, long before the gang's
timeout), and the default device, the card, on a host without CUDA. The
binding rule is held from the metadata: each rank on the card at its
position among its node's ranks, two ranks on one card or a node with too
few cards raising.
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

import ray_tpu as rt
from ray_tpu.util import collective as jcol
from ray_tpu_torch._private import gang
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.train import backend
from ray_tpu_torch.util import collective as col

from test_torch_collective import _host_values, _Rank as _JaxRank, _same

WORLD = 4
RANKS = [2, 0, 3, 1]
SRC = 1
TIMEOUT_S = 60


def _actor_classes():
    """The actor classes, defined here so that they travel to the workers
    by value (the workers cannot import this module)."""

    class _PortRankBody(col.CollectiveActorMixin):
        """A runtime actor that joins the port's declared groups."""

        def host(self, name, values, rank, world):
            return gang_cases.host_collectives(name, values, rank, world)

        def mesh(self, name, x, chunks):
            return gang_cases.mesh_collectives(
                name, torch.from_numpy(x), [torch.from_numpy(c) for c in chunks],
                SRC, False)

        def gang(self):
            import torch.distributed as dist

            return dist.get_rank(), dist.get_world_size(), dist.get_backend()

        def join_alone(self, path):
            backend.init_process_group(0, 1, f"file://{path}", "cpu")
            return True


    class _FailingJoinBody(_PortRankBody):
        """As _PortRankBody, but its join fails as rank 3."""

        def _rt_collective_join(self, world_size, rank, *args, **kwargs):
            if rank == 3:
                raise RuntimeError("this actor cannot join")
            return super()._rt_collective_join(world_size, rank, *args, **kwargs)

    return rt.remote(_PortRankBody), rt.remote(_FailingJoinBody)


_PortRank, _FailingJoin = _actor_classes()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def declared(cluster):
    """Four actors declared one gloo gang (ranks RANKS) with a "host"
    group ("default") and a "mesh" group over it."""
    actors = [_PortRank.remote() for _ in range(WORLD)]
    col.create_collective_group(actors, WORLD, RANKS, device="cpu",
                                init_timeout_s=TIMEOUT_S)
    col.create_collective_group(actors, WORLD, RANKS, "mesh", "mesh",
                                device="cpu", init_timeout_s=TIMEOUT_S)
    yield actors
    col.destroy_collective_group()
    col.destroy_collective_group("mesh")
    for a in actors:
        rt.kill(a)


def _get(refs):
    return [r.future().result(TIMEOUT_S) for r in refs]


def test_declared_gang_ranks_follow_ranks_not_actor_order(declared):
    assert _get([a.gang.remote() for a in declared]) == [
        (r, WORLD, "gloo") for r in RANKS]


def test_host_path_matches_jax_on_a_declared_actor_gang(declared):
    values = _host_values()
    got = _get([a.host.remote("default", values, r, WORLD)
                for a, r in zip(declared, RANKS)])
    jax_actors = [_JaxRank.remote() for _ in range(WORLD)]
    jcol.create_collective_group(jax_actors, WORLD, RANKS)
    try:
        want = _get([a.run.remote(values[r], r, WORLD)
                      for a, r in zip(jax_actors, RANKS)])
    finally:
        jcol.destroy_collective_group()
        for a in jax_actors:
            rt.kill(a)
    for g, w, rank in zip(got, want, RANKS):
        assert g.keys() == w.keys()
        for k in w:
            assert _same(g[k], w[k]), (rank, k)
    assert [g["ring"] for g in got] == [(r - 1) % WORLD for r in RANKS]


def test_declared_mesh_group_collectives_equal_numpy(declared):
    rng = np.random.default_rng(3)
    xs = [rng.integers(-3, 4, (3, 8)).astype(np.float32)
          for _ in range(WORLD)]
    chunks = [[rng.integers(-3, 4, (2, 8)).astype(np.float32)
               for _ in range(WORLD)] for _ in range(WORLD)]
    got = _get([a.mesh.remote("mesh", xs[r], chunks[r])
                for a, r in zip(declared, RANKS)])
    x = np.stack(xs)  # positions are the ranks: no mesh, the whole gang
    for g, rank in zip(got, RANKS):
        scattered = np.stack([chunks[q][rank] for q in range(WORLD)]).sum(0)
        want = {"sum": x.sum(0), "product": x.prod(0), "min": x.min(0),
                "max": x.max(0), "allgather": x, "broadcast": x[SRC],
                "reducescatter": scattered,
                "reducescatter_tree_g": scattered,
                "reducescatter_tree_h": 2 * scattered, "bf16_sum": x.sum(0)}
        assert g.keys() == want.keys()
        for k in want:
            assert g[k].dtype == np.float32 and np.array_equal(g[k], want[k]
                                                               ), (rank, k)


def test_declaring_a_name_twice_raises(declared):
    with pytest.raises(RuntimeError, match="'mesh' already declared"):
        col.create_collective_group(declared, WORLD, RANKS, "mesh", "mesh",
                                    device="cpu")


def test_an_actor_in_a_gang_of_another_world_fails_the_declaration(
        cluster, tmp_path):
    actors = [_PortRank.remote() for _ in range(WORLD)]
    try:
        _get([actors[0].join_alone.remote(str(tmp_path / "alone"))])
        t0 = time.perf_counter()
        with pytest.raises(col.CollectiveGroupError,
                           match=r"(?s)rank 2 failed to join the gang: .*rank "
                           r"0 of a gang of 1"):
            col.create_collective_group(actors, WORLD, RANKS, device="cpu",
                                        group_name="other",
                                        init_timeout_s=TIMEOUT_S)
        assert time.perf_counter() - t0 < TIMEOUT_S / 2
        assert not col.is_group_initialized("other")
        # the name is free again
        with pytest.raises(col.CollectiveGroupError):
            col.create_collective_group(actors, WORLD, RANKS, device="cpu",
                                        group_name="other", init_timeout_s=1)
    finally:
        for a in actors:
            rt.kill(a)


def test_a_join_that_fails_names_its_rank_at_once(cluster):
    actors = [_FailingJoin.remote() for _ in range(WORLD)]
    try:
        t0 = time.perf_counter()
        with pytest.raises(col.CollectiveGroupError,
                           match="(?s)rank 3 failed to join the gang: .*this "
                           "actor cannot join"):
            col.create_collective_group(actors, WORLD, RANKS, device="cpu",
                                        group_name="failing",
                                        init_timeout_s=TIMEOUT_S)
        assert time.perf_counter() - t0 < TIMEOUT_S / 2
    finally:
        for a in actors:
            rt.kill(a)


def test_the_default_device_is_the_card_and_raises_without_cuda(cluster):
    actors = [_PortRank.remote() for _ in range(2)]
    try:
        with pytest.raises(col.CollectiveGroupError,
                           match=r"(?s)rank [01] failed to bind to its card: .*"
                           "needs a CUDA card"):
            col.create_collective_group(actors, 2, [0, 1],
                                        group_name="card",
                                        init_timeout_s=TIMEOUT_S)
    finally:
        for a in actors:
            rt.kill(a)


# -- the card-binding rule, from the metadata ------------------------------------

class _Ref:
    """An ObjectRef stand-in: the call ran here; future() holds its
    outcome."""

    def __init__(self, fn, *args, **kwargs):
        self._f = concurrent.futures.Future()
        try:
            self._f.set_result(fn(*args, **kwargs))
        except Exception as e:  # noqa: BLE001 - the future carries it
            self._f.set_exception(e)

    def future(self):
        return self._f


class _Worker:
    def __init__(self):
        self.execute = self

    def remote(self, fn, *args, **kwargs):
        return _Ref(fn, *args, **kwargs)


class _Group:
    """A WorkerGroup stand-in whose workers run their calls here."""

    def __init__(self, nodes):
        self.num_workers = len(nodes)
        self.workers = [_Worker() for _ in nodes]
        self._meta = [{"node_id": n, "hostname": f"host-{n}", "pid": i}
                      for i, n in enumerate(nodes)]

    def group_metadata(self):
        return self._meta


@pytest.fixture
def cards(monkeypatch):
    """A host with `n` stubbed cards (card_id "pci-<index>"); -> the cards
    each bind_card call bound, in order."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(gang, "card_id", lambda i: f"pci-{i}")
    monkeypatch.setattr(gang, "_bound", {"card": None})

    def have(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        return bound

    return have


def test_local_ranks_follow_rank_order_within_a_node():
    assert gang.local_ranks(["a", "b", "a", "a", "b"]) == [0, 0, 1, 2, 1]
    assert gang.local_ranks([]) == []


def test_each_worker_binds_the_card_at_its_local_rank(cards):
    bound = cards(3)
    backend.TorchBackend().on_start(_Group(["a", "b", "a", "a", "b"]),
                                    backend.TorchConfig())
    assert [d.index for d in bound] == [0, 0, 1, 2, 1]


def test_a_node_with_too_few_cards_raises(cards):
    cards(2)
    with pytest.raises(col.CollectiveGroupError,
                       match=r"rank 0 failed to bind to its card: this node "
                       r"runs 3 ranks of the gang and its processes see 2"):
        backend.TorchBackend().on_start(_Group(["a", "b", "a", "a"]),
                                        backend.TorchConfig())


def test_two_ranks_on_one_card_raise(cards, monkeypatch):
    cards(4)
    # Each process of node "a" sees the same card first, as two processes
    # given other CUDA_VISIBLE_DEVICES orders could.
    monkeypatch.setattr(gang, "card_id", lambda i: "pci-shared")
    with pytest.raises(RuntimeError, match="ranks 0 and 1 are both bound to "
                       "card pci-shared of node a"):
        backend.TorchBackend().on_start(_Group(["a", "a"]),
                                        backend.TorchConfig())
    gang.check_distinct_cards(["a", "b"], ["pci-0", "pci-0"])
    gang.check_distinct_cards(["a", "a"], [None, None])


def test_resolve_names_the_rank_that_did_not_finish():
    pending = concurrent.futures.Future()

    class Slow:
        def future(self):
            return pending

    ok = _Ref(lambda: 1)
    t0 = time.perf_counter()
    with pytest.raises(col.CollectiveGroupError,
                       match=r"ranks \[5\] did not join within 0.2 s"):
        gang.resolve([ok, Slow()], [4, 5], "join", 0.2)
    assert time.perf_counter() - t0 < 5
    assert gang.resolve([ok], [0], "join", 1) == [1]
