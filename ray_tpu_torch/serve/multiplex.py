"""Model multiplexing (reference: ray python/ray/serve/multiplex.py:22
_ModelMultiplexWrapper LRU + api.py:609 @serve.multiplexed +
get_multiplexed_model_id): one replica serves many models, loading on
demand and evicting least-recently-used beyond max_num_models_per_replica.

NOTE on structure: all runtime state (locks, LRU caches) lives at module
level and every helper is a module-level function — the wrapper closure is
pickled into replicas, and cloudpickle serializes dynamic closures' captured
globals by value (a captured lock would fail).
"""

from __future__ import annotations

import functools
import inspect
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

from ray_tpu_torch.serve.context import (
    get_multiplexed_model_id,
    set_multiplexed_model_id,
)

_mux_lock = threading.Lock()
_mux_caches: dict = {}


def _cache_get(load_fn: Callable, instance, model_id: str):
    with _mux_lock:
        cache = _mux_caches.setdefault(
            (id(load_fn), id(instance)), OrderedDict())
        if model_id in cache:
            cache.move_to_end(model_id)
            return cache[model_id], True
    return None, False


def _cache_put(load_fn: Callable, instance, model_id: str, model: Any,
               max_models: int) -> None:
    with _mux_lock:
        cache = _mux_caches.setdefault(
            (id(load_fn), id(instance)), OrderedDict())
        cache[model_id] = model
        cache.move_to_end(model_id)
        while len(cache) > max_models:
            cache.popitem(last=False)


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    def wrap(load_fn: Callable):
        params = list(inspect.signature(load_fn).parameters)
        is_method = bool(params) and params[0] == "self"
        is_async = inspect.iscoroutinefunction(load_fn)

        @functools.wraps(load_fn)
        def sync_wrapper(*args):
            instance, model_id = (args[0], args[1]) if is_method \
                else (None, args[0])
            set_multiplexed_model_id(model_id)
            model, hit = _cache_get(load_fn, instance, model_id)
            if hit:
                return model
            model = load_fn(*args)
            _cache_put(load_fn, instance, model_id, model,
                       max_num_models_per_replica)
            return model

        @functools.wraps(load_fn)
        async def async_wrapper(*args):
            instance, model_id = (args[0], args[1]) if is_method \
                else (None, args[0])
            set_multiplexed_model_id(model_id)
            model, hit = _cache_get(load_fn, instance, model_id)
            if hit:
                return model
            model = await load_fn(*args)
            _cache_put(load_fn, instance, model_id, model,
                       max_num_models_per_replica)
            return model

        return async_wrapper if is_async else sync_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


__all__ = ["multiplexed", "get_multiplexed_model_id"]
