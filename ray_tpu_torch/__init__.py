"""ray_tpu_torch: the PyTorch/CUDA counterpart of `ray_tpu`, for NVIDIA Hopper.

Module names follow the JAX package so each counterpart is easy to find
(`ray_tpu.models.llama` -> `ray_tpu_torch.models.llama`). The package imports
torch and numpy only: nothing of JAX and nothing of `ray_tpu`.

It carries its own runtime core (tasks, actors, objects and placement
groups over its own GCS, raylet, core worker and shm object store), with the
same public surface as `ray_tpu`: `init`, `remote`, `get`, `put`, `wait`,
`kill`, `cancel`, `get_actor`. Importing the package, and so starting a
worker, imports no torch: the runtime's modules load it only when a tensor
is pickled or a task asks for it, and `device_info` / `resolve_device` load
on first use.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA and no explicit CPU request they raise (see `_private.device`).
"""

# Arm the runtime lock-order / blocking-call sanitizer BEFORE any
# submodule import creates a lock (RAY_TPU_SANITIZE=1; no-op otherwise).
# Spawned workers inherit the env, so one export covers the whole node.
from ray_tpu_torch._private import lock_sanitizer as _lock_sanitizer

_lock_sanitizer.maybe_install_from_env()

from ray_tpu_torch import exceptions  # noqa: F401,E402
from ray_tpu_torch._raylet import ObjectRef, ObjectRefGenerator  # noqa: F401,E402
from ray_tpu_torch.actor import ActorClass, ActorHandle, method  # noqa: F401,E402
from ray_tpu_torch.api import (  # noqa: F401,E402
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.remote_function import RemoteFunction  # noqa: F401,E402
from ray_tpu_torch.actor import exit_actor  # noqa: F401,E402
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "device_info",
    "exceptions",
    "get",
    "get_actor",
    "exit_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "resolve_device",
    "shutdown",
    "wait",
    "__version__",
]


def __getattr__(name):
    # torch loads here, on first use, not when a worker imports the package
    if name in ("device_info", "resolve_device"):
        from ray_tpu_torch._private import device

        return getattr(device, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
