"""The runtime's actors as the port's RLlib groups drive them.

The port imports nothing of the runtime, so what it needs of it comes in as
values: the actor decorator (`ray_tpu.remote`, which a config carries from
`AlgorithmConfig.runtime(remote=...)`), the handles that decorator makes,
and the refs their calls return. Everything else is here:

- Refs are read through their own `future()` (`results`), as
  `gang.resolve` reads them; a wait for the first of many is
  `concurrent.futures.wait` over those futures.
- A dead actor is told from a bug in its code by the class of the
  exception its future raises (`is_gone`): a class named in `RUNNER_GONE`
  anywhere in its MRO means the actor, or an object it owned, is gone. Any
  other exception is the actor's own error and propagates.
- An actor is stopped by the runtime's own terminating call
  (`terminate`: `__ray_terminate__`).
- Each actor binds to a card before its first CUDA call (`CardActor`,
  `place_actors`, or `CardActor.bind_slot` for a replacement): the card
  at its position among its group's actors on its node, modulo the node's
  cards (`card_of`). A runtime actor sees every card of its node, so
  without the bind all of them would land on card 0.
  These actors run no NCCL, so two of them may share a card.
"""

from __future__ import annotations

import functools
import socket
from typing import Any, List, Optional, Sequence

import torch

from ray_tpu_torch._private import gang
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.serialization import install_tensor_wire

# The runtime's exception classes that mean "this actor, or an object it
# owned, is gone" rather than a bug in its code (ObjectLostError covers an
# owner that died, a freed object and a failed reconstruction). Matched by
# name, since the port imports nothing of the runtime.
RUNNER_GONE = ("RayActorError", "ObjectLostError", "WorkerCrashedError")

NEEDS_RUNTIME = ("runs actors of the runtime: pass its actor decorator with "
                 "config.runtime(remote=ray_tpu.remote) (the port imports "
                 "nothing of the runtime); nothing samples or learns in this "
                 "process in their place")


def is_gone(err: BaseException) -> bool:
    """Whether `err` says that an actor or its objects are gone: a class
    named in RUNNER_GONE is in its MRO."""
    return any(c.__name__ in RUNNER_GONE for c in type(err).__mro__)


def check_gone(err: BaseException) -> None:
    """Re-raise `err` unless it says that an actor is gone."""
    if not is_gone(err):
        raise err


def results(refs: Sequence[Any]) -> List[Any]:
    """The values of `refs`, each read through its own `future()`; the
    first failure raises the exception its future holds."""
    return [f.result() for f in [r.future() for r in refs]]


def terminate(handle) -> None:
    """Stop the actor `handle` with the runtime's own terminating call. A
    handle whose actor is already gone is left as it is."""
    try:
        handle.__ray_terminate__.remote()
    except Exception as err:  # noqa: BLE001 — a dead handle raises at submit
        check_gone(err)


def card_of(position: int, n_cards: int) -> int:
    """The card an actor binds to: its position among its group's actors
    on its node, modulo the node's cards. Two actors may share a card."""
    return position % n_cards


def bind_actor_card(position: int, device=None) -> Optional[str]:
    """Bind this actor's process to its card (`card_of`, or the card that
    `device` names by index) before its first CUDA call; -> the card's PCI
    bus id. device "cpu": binds nothing, -> None. The default device on a
    host without CUDA raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    index = (dev.index if dev.index is not None
             else card_of(position, torch.cuda.device_count()))
    return gang.bind_card(index, dev)


class CardActor:
    """What a group runs in each of its actors: an instance of `cls`, built
    by `bind` once the actor is on its card. Every call then reaches the
    instance on that card, from whichever thread the runtime runs it on
    (a CUDA card is current per thread)."""

    def __init__(self, cls, *args, **kwargs):
        self._make = (cls, args, kwargs)
        self._obj = None
        # what this actor sends back travels on the typed tensor wire
        install_tensor_wire()

    def node(self) -> str:
        """The actor's node: its host's name."""
        return socket.gethostname()

    def bind(self, position: int, device=None) -> Optional[str]:
        """Bind to the card (`bind_actor_card`), then build the instance."""
        card = bind_actor_card(position, device)
        cls, args, kwargs = self._make
        self._obj = cls(*args, **kwargs)
        return card

    def bind_slot(self, nodes: Sequence[Optional[str]], slot: int,
                  device=None) -> str:
        """Bind as the actor that takes position `slot` in a group whose
        actors sit on `nodes` (this actor's entry replaced by its own
        node): how every replacement binds. Its creator need not wait for
        its node first, so a respawn can submit this call and the calls
        after it at once. -> its node."""
        nodes = list(nodes)
        nodes[slot] = self.node()
        self.bind(gang.local_ranks(nodes)[slot], device)
        return nodes[slot]

    def __getattr__(self, name: str):
        obj = self.__dict__.get("_obj")
        if obj is None:
            raise AttributeError(f"{name}: the actor is not bound to its "
                                 "card yet (CardActor.bind)")
        attr = getattr(obj, name)
        if not callable(attr):
            return attr

        @functools.wraps(attr)
        def on_card(*args, **kwargs):
            gang.bind_thread()
            return attr(*args, **kwargs)

        return on_card


def place_actors(handles: Sequence[Any], device=None) -> List[str]:
    """Bind the CardActors `handles`, a whole group in its order, to their
    cards (a replacement binds itself: `CardActor.bind_slot`). -> the
    group's nodes, in its order. Where one fails, all of `handles` are
    stopped and its error raised."""
    try:
        nodes = results([h.node.remote() for h in handles])
        positions = gang.local_ranks(nodes)
        results([h.bind.remote(p, device)
                 for h, p in zip(handles, positions)])
    except BaseException:
        for h in handles:
            terminate(h)
        raise
    return nodes
