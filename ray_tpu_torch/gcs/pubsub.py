"""GCS-hosted pubsub.

Role of the reference's publisher/subscriber channels
(ray: src/ray/pubsub/publisher.h:296, subscriber.h:70; GCS wrapper
gcs/gcs_server/pubsub_handler.cc). Channels carry actor-state, node-state,
job, error and log messages. Instead of long-polling, the publisher pushes
one-way RPC frames to each subscriber's own RpcServer ("pubsub_message"
handler); dead subscribers are dropped on first send failure.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Set

from ray_tpu_torch._private.rpc import ClientPool, ConnectionLost, EventLoopThread

logger = logging.getLogger(__name__)

# Channel names
ACTOR_CHANNEL = "ACTOR"
NODE_CHANNEL = "NODE"
JOB_CHANNEL = "JOB"
ERROR_CHANNEL = "ERROR"
LOG_CHANNEL = "LOG"
PG_CHANNEL = "PLACEMENT_GROUP"
WORKER_CHANNEL = "WORKER"


class Publisher:
    """Pushes (channel, key, message) to every subscriber of the channel."""

    def __init__(self, loop_thread: EventLoopThread):
        self._lt = loop_thread
        self._pool = ClientPool(loop_thread)
        # channel -> set of subscriber rpc addresses
        self._subs: Dict[str, Set[str]] = {}
        # invoked as on_drop(channel, addr) when a dead subscriber is
        # discarded (lets the GCS prune its persisted subscription table)
        self.on_drop = None

    def subscribe(self, channel: str, subscriber_address: str) -> None:
        self._subs.setdefault(channel, set()).add(subscriber_address)

    def unsubscribe(self, channel: str, subscriber_address: str) -> None:
        self._subs.get(channel, set()).discard(subscriber_address)

    def unsubscribe_all(self, subscriber_address: str) -> None:
        for subs in self._subs.values():
            subs.discard(subscriber_address)

    def publish(self, channel: str, key: Any, message: Any) -> None:
        for addr in list(self._subs.get(channel, ())):
            self._lt.submit(self._push(channel, addr, key, message))

    async def _push(self, channel: str, addr: str, key: Any, message: Any):
        client = self._pool.get(addr)
        try:
            await client.send_async("pubsub_message", (channel, key, message))
        except (ConnectionLost, OSError):
            self._subs.get(channel, set()).discard(addr)
            self._pool.invalidate(addr)
            if self.on_drop is not None:
                try:
                    self.on_drop(channel, addr)
                except Exception:  # noqa: BLE001
                    logger.exception("pubsub on_drop failed")

    def close(self):
        self._pool.close_all()
