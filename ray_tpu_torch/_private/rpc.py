"""The port's copy of `ray_tpu/_private/rpc.py`'s `find_free_port`, which a
gang's rank 0 uses to pick the port of its TCP rendezvous. The rest of that
module is the runtime's RPC plane, which the port does not need."""

from __future__ import annotations

import socket


def find_free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
