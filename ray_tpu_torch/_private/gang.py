"""The torch.distributed gang a process is in: binding to a card, joining,
and the calling side of a rendezvous over the runtime's actors.

Below both of its users: `util.collective` (groups declared over actors,
`create_collective_group`) and `train.backend` (`TorchBackend`, whose
hooks the runtime's `DataParallelTrainer` calls). Every function a rank
runs is a plain function of this module, importable by name, so the
runtime ships it to its workers by reference.

- The rank side: `bind_card` (this process's first CUDA call, onto the card
  at its local rank), `join_gang`, `init_process_group`, `rank_device`,
  `bind_thread`, `destroy_process_group`, `gang_address` (the rendezvous's
  store, served on a port this process holds from the moment it is
  advertised) and `release_address`.
- The calling side: `local_ranks` and `check_distinct_cards` (which card
  each rank takes), `resolve` (the runtime's ObjectRefs, each read through
  its own `future()`) and `gather_gang` (bind, check, join).

A CUDA card is current per thread, and a runtime actor runs its calls and
its train function on threads of its own, so the card `bind_card` bound is
kept for the process (`_bound`) and each thread that reaches the gang is
made to use it (`bind_thread`, `rank_device`).
"""

from __future__ import annotations

import collections
import concurrent.futures
import datetime
import os
import socket
import threading
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


class CollectiveGroupError(RuntimeError):
    """A group of world > 1, or a mesh, was asked for where this process is
    in no torch.distributed gang, or in one of another world or rank."""


WAY_IN = ("join the gang first: train.backend.launch_gang runs a function "
          "on N ranks that have joined one, and a process joins one by "
          "train.backend.init_process_group or "
          "parallel.mesh.initialize_distributed")

NO_CARD = ("an NCCL rank needs a CUDA card and none is visible; ask for "
           "device='cpu' to run gloo")

# The card `bind_card` bound this process to.
_bound: Dict[str, Optional[torch.device]] = {"card": None}

# The rendezvous store this process serves (`gang_address`), by port, until
# a join takes it or `release_address` stops it.
_held_lock = threading.Lock()
_held: Dict[int, Any] = {}


def device_type(device) -> str:
    """"cuda" for None or a CUDA device, "cpu" for the CPU; else raises."""
    dev_type = "cuda" if device is None else torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device} (use 'cuda' or 'cpu')")
    return dev_type


def process_group_backend(backend: Optional[str], dev_type: str) -> str:
    """`backend`, or NCCL for the card and gloo for the CPU."""
    if backend is not None:
        return backend
    if dev_type == "cuda":
        return "nccl"
    if dev_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for {dev_type}")


def check_gang(world_size: int, rank: int) -> None:
    """Raises `CollectiveGroupError` unless this process is rank `rank` of
    a gang of `world_size`."""
    if not dist.is_initialized():
        raise CollectiveGroupError(
            f"a collective group of world {world_size} runs over the "
            "torch.distributed gang this process is in, and it is in none: "
            + WAY_IN)
    have = (dist.get_world_size(), dist.get_rank())
    if have != (world_size, rank):
        raise CollectiveGroupError(
            f"a collective group of world {world_size} with this process as "
            f"rank {rank} spans its gang, but this process is rank {have[1]} "
            f"of a gang of {have[0]}: " + WAY_IN + " with that world and "
            "rank")


# -- the rank side ---------------------------------------------------------------

def card_id(index: int) -> str:
    """The PCI bus id of card `index` of those this process sees (its UUID
    where torch does not give the bus id)."""
    p = torch.cuda.get_device_properties(index)
    if hasattr(p, "pci_bus_id"):
        return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}"
    return str(p.uuid)


def bind_card(local_rank: int, device=None, env_vars: Optional[dict] = None,
              node_ranks: Optional[int] = None) -> Optional[str]:
    """Set `env_vars`, then bind this process to card `local_rank` of those
    it sees (all of its node's, as a runtime actor sees them): its first
    CUDA call. A node with fewer visible cards than ranks (`node_ranks`,
    default local_rank + 1) raises, as does a host without CUDA. device
    "cpu": no card. -> the card's PCI bus id, or None."""
    for k, v in (env_vars or {}).items():
        os.environ[k] = str(v)
    if device_type(device) == "cpu":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    need = local_rank + 1 if node_ranks is None else node_ranks
    have = torch.cuda.device_count()
    if have < need:
        raise RuntimeError(
            f"this node runs {need} ranks of the gang and its processes see "
            f"{have} CUDA card(s): NCCL takes one rank a card")
    card = torch.device("cuda", local_rank)
    torch.cuda.set_device(card)
    _bound["card"] = card
    return card_id(local_rank)


def bind_thread() -> Optional[torch.device]:
    """Make the card `bind_card` bound this process to the calling thread's
    current card too; -> that card, or None when none is bound."""
    card = _bound["card"]
    if card is not None:
        torch.cuda.set_device(card)
    return card


def rank_device() -> torch.device:
    """This rank's device: the card `bind_card` bound the process to (made
    the calling thread's current card too), else its card under NCCL, the
    CPU under gloo."""
    card = bind_thread()
    if card is not None:
        return card
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rendezvous_store(init_method: str, world_size: int, rank: int,
                      timeout: datetime.timedelta):
    """The store of a `tcp://<host>:<port>` rendezvous: the one this process
    serves on that port (`gang_address`), else served by rank 0 on the
    port (a `coordinator_port`) and reached by the others; None for any
    other init_method, which torch's own rendezvous reads. Every rank of
    a tcp gang takes its store from here: torch prefixes the keys of a
    store it made itself ("default_pg") and not those of one it is given,
    so ranks that mixed the two would wait for each other's keys."""
    url = urllib.parse.urlparse(init_method)
    if url.scheme != "tcp":
        return None
    with _held_lock:
        store = _held.pop(url.port, None)
    if store is not None:
        store.set_timeout(timeout)
        return store
    return dist.TCPStore(url.hostname, url.port, world_size, rank == 0,
                         timeout, wait_for_workers=False)


def release_address(init_method: str) -> bool:
    """Stop serving the rendezvous that `gang_address` advertised at
    `init_method`, where no join of this process will take it (a process
    that keeps its gang, a declaration that failed). -> whether this
    process served it."""
    with _held_lock:
        return _held.pop(urllib.parse.urlparse(init_method).port,
                         None) is not None


def init_process_group(rank: int, world_size: int, init_method: str,
                       device=None, backend: Optional[str] = None,
                       init_timeout_s: int = 300) -> torch.device:
    """Join the gang as `rank` of `world_size` through `init_method`
    (`tcp://<host>:<port>` or `file://<path>`). device None or "cuda":
    NCCL (or `backend`), this rank on the card `bind_card` bound it to,
    else on `torch.cuda.current_device()`; "cpu": gloo. A tcp rendezvous
    meets at the store the process that advertised the port serves
    (`gang_address`); with no such process, rank 0 serves it there. The
    rendezvous and every collective after it give up after init_timeout_s;
    a gloo join returns once every rank has connected. -> the rank's
    device. A process already in a gang raises."""
    dev_type = device_type(device)
    if dist.is_initialized():
        raise RuntimeError("this process is already in a torch.distributed "
                           "gang; destroy_process_group() first")
    kw = {}
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CARD)
        dev = bind_thread()
        if dev is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
    timeout = datetime.timedelta(seconds=init_timeout_s)
    store = _rendezvous_store(init_method, world_size, rank, timeout)
    if store is None:
        kw["init_method"] = init_method
    else:
        kw["store"] = store
    try:
        dist.init_process_group(
            backend=process_group_backend(backend, dev_type),
            world_size=world_size, rank=rank, timeout=timeout, **kw)
    finally:
        del store, kw  # a failed join stops serving its rendezvous
    if dist.get_backend() == "gloo":
        # gloo's constructor returns once this rank's side of every pair is
        # up; a peer may still be finishing its side, and a rank that left
        # the gang before then (destroyed its group, or exited) fails the
        # peer's connect with "Connection closed by peer".
        dist.barrier()
    return dev


def join_gang(init_method: str, world_size: int, rank: int, device=None,
              init_timeout_s: int = 300, backend: Optional[str] = None
              ) -> str:
    """Join the gang of `world_size` as `rank` through `init_method`. A
    process already in a gang of that world and rank keeps it; one in a
    gang of another world or rank raises `CollectiveGroupError`; either
    stops serving a rendezvous this process advertised at init_method.
    -> this rank's device, as a string."""
    if dist.is_initialized():
        release_address(init_method)
        check_gang(world_size, rank)
        return str(rank_device())
    return str(init_process_group(rank, world_size, init_method, device,
                                  backend, init_timeout_s))


def destroy_process_group() -> None:
    """Leave the gang, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def gang_address() -> Dict[str, Any]:
    """Where a gang can meet at this process: its host's name and a free
    port there, on which this process serves the rendezvous's store from
    now on, so that nothing else can take the port between its
    advertisement and the join. The join of any rank in this process
    through that port takes the store (`init_process_group`); the others
    reach it. A process advertises one gang at a time: a store it still
    serves from an earlier call, which no join took, is stopped."""
    store = dist.TCPStore(socket.gethostname(), 0, None, True,
                          datetime.timedelta(seconds=300),
                          wait_for_workers=False)
    with _held_lock:
        _held.clear()
        _held[store.port] = store
    return {"hostname": socket.gethostname(), "port": store.port}


# -- the calling side ---------------------------------------------------------------

def local_ranks(node_ids: Sequence[Any]) -> List[int]:
    """Each rank's position among the ranks of its node, in rank order: the
    card it binds to (the local rank that the runtime's `BackendExecutor`
    derives from the same metadata)."""
    seen: Dict[Any, int] = collections.defaultdict(int)
    out = []
    for node in node_ids:
        out.append(seen[node])
        seen[node] += 1
    return out


def check_distinct_cards(node_ids: Sequence[Any],
                         cards: Sequence[Optional[str]]) -> None:
    """Raises if two ranks are bound to one card of one node (`cards`: what
    `bind_card` returned for each rank, None for a CPU rank)."""
    seen: Dict[Any, int] = {}
    for rank, (node, card) in enumerate(zip(node_ids, cards)):
        if card is None:
            continue
        first = seen.setdefault((node, card), rank)
        if first != rank:
            raise RuntimeError(
                f"ranks {first} and {rank} are both bound to card {card} of "
                f"node {node}: NCCL takes one rank a card (do the processes "
                "of that node see different cards, or the same cards in "
                "different orders?)")


def resolve(refs: Sequence[Any], ranks: Sequence[int], what: str,
            timeout_s: float) -> List[Any]:
    """The values of the runtime's ObjectRefs `refs` (rank `ranks[i]`'s
    call is refs[i]), each read through its own `future()`. Raises
    `CollectiveGroupError` naming the rank as soon as a call fails, and
    naming the ranks still running when timeout_s passes: a rank that
    cannot join never hangs the caller."""
    futures = [r.future() for r in refs]
    done, pending = concurrent.futures.wait(
        futures, timeout=timeout_s,
        return_when=concurrent.futures.FIRST_EXCEPTION)
    failed = sorted((ranks[i], f.exception()) for i, f in enumerate(futures)
                    if f in done and f.exception() is not None)
    if failed:
        rank, err = failed[0]
        raise CollectiveGroupError(f"rank {rank} failed to {what}: {err}"
                                   ) from err
    if pending:
        late = sorted(ranks[i] for i, f in enumerate(futures)
                      if f in pending)
        raise CollectiveGroupError(f"ranks {late} did not {what} within "
                                   f"{timeout_s} s")
    return [f.result() for f in futures]


def gather_gang(nodes: Sequence[Any], bind: Callable, join: Optional[Callable],
                timeout_s: float) -> List[Optional[str]]:
    """The calling process's half of a gang's rendezvous over the runtime's
    actors, rank r on node nodes[r]: bind(r, local rank, ranks on its node)
    -> the ref of rank r's `bind_card`; every rank bound, the cards checked
    distinct, then join(r) -> the ref of rank r's join (None: no gang),
    each step through `resolve`. -> the cards."""
    ranks = list(range(len(nodes)))
    local = local_ranks(nodes)
    count = collections.Counter(nodes)
    cards = resolve([bind(r, local[r], count[nodes[r]]) for r in ranks],
                    ranks, "bind to its card", timeout_s)
    check_distinct_cards(nodes, cards)
    if join is not None:
        resolve([join(r) for r in ranks], ranks, "join the gang", timeout_s)
    return cards
