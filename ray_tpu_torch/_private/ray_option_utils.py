"""Validation/merging of `@remote`/`.options()` arguments.

Reference: ray python/ray/_private/ray_option_utils.py — the single table that
validates every option a task or actor can carry.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import CONFIG

_UNSET = object()  # sentinel: "use the per-kind default CPU"

_COMMON_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "max_retries",
    "retry_exceptions", "max_calls", "num_returns",
    "scheduling_strategy", "name",
    "namespace", "lifetime", "max_restarts", "max_task_retries",
    "max_concurrency", "get_if_exists", "runtime_env", "memory",
    "placement_group", "placement_group_bundle_index",
    "max_pending_calls", "concurrency_groups", "label_selector",
    "deadline_s", "_metadata",
}

TASK_ONLY = {"max_retries", "retry_exceptions", "max_calls", "deadline_s"}
ACTOR_ONLY = {
    "max_restarts", "max_task_retries", "max_concurrency", "lifetime",
    "get_if_exists", "max_pending_calls", "concurrency_groups",
}


def validate_options(options: Dict[str, Any], *, is_actor: bool) -> Dict[str, Any]:
    for k in options:
        if k not in _COMMON_OPTIONS:
            raise ValueError(f"Unknown option '{k}'")
        if is_actor and k in TASK_ONLY:
            raise ValueError(f"Option '{k}' is only valid for tasks")
        if not is_actor and k in ACTOR_ONLY:
            raise ValueError(f"Option '{k}' is only valid for actors")
    nr = options.get("num_returns")
    if nr is not None and nr != "streaming" and (not isinstance(nr, int) or nr < 0):
        raise ValueError("num_returns must be a non-negative int or 'streaming'")
    mc = options.get("max_calls")
    if mc is not None and (not isinstance(mc, int) or isinstance(mc, bool)
                           or mc < 0):
        raise ValueError("max_calls must be a non-negative int (0 = unlimited)")
    for key in ("num_cpus", "num_gpus", "memory"):
        v = options.get(key)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            raise ValueError(f"{key} must be a non-negative number")
    # A lease binds whole cards, or a share of one (raylet._pick_cards)
    gpus = options.get("num_gpus")
    if gpus is not None and gpus > 1 and gpus != int(gpus):
        raise ValueError("num_gpus above 1 must be a whole number of cards")
    dl = options.get("deadline_s")
    if dl is not None and (not isinstance(dl, (int, float))
                           or isinstance(dl, bool) or dl <= 0):
        raise ValueError("deadline_s must be a positive number of seconds")
    return options


def resources_from_options(options: Dict[str, Any], *, is_actor: bool,
                           default_cpu: Optional[float] = _UNSET):
    """Translate @remote options to a resource dict. default_cpu=None means
    'no CPU unless explicitly requested' (used for actor HELD resources)."""
    resources = dict(options.get("resources") or {})
    if "num_cpus" in options and options["num_cpus"] is not None:
        resources["CPU"] = float(options["num_cpus"])
    else:
        if default_cpu is _UNSET:
            default_cpu = (CONFIG.default_actor_num_cpus if is_actor
                           else CONFIG.default_task_num_cpus)
        if default_cpu is not None:
            resources.setdefault("CPU", default_cpu)
    if options.get("num_gpus"):
        resources["GPU"] = float(options["num_gpus"])
    if options.get("memory"):
        resources["memory"] = float(options["memory"])
    return resources


def actor_resources_from_options(options: Dict[str, Any]):
    """-> (held, placement): resources an actor HOLDS for its lifetime vs the
    resources used for the placement decision. Matches the reference (ray
    actor default: schedules with 1 CPU, holds 0 — required_resources vs
    required_placement_resources in TaskSpec), so idle actors don't pin CPUs
    and a 4-CPU node can host hundreds of actors."""
    held = resources_from_options(options, is_actor=True, default_cpu=None)
    placement = dict(held)
    if "CPU" not in held:
        placement["CPU"] = CONFIG.default_actor_num_cpus
    return held, placement


def merge_options(base: Optional[Dict[str, Any]], overrides: Dict[str, Any]):
    out = dict(base or {})
    out.update(overrides)
    return out
