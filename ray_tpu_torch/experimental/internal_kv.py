"""GCS-backed internal KV (reference: ray python/ray/experimental/
internal_kv.py — the KV used by libraries for cluster-wide metadata;
C++ side gcs_kv_manager.cc)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch._raylet import get_core_worker


def _kv():
    return get_core_worker()


def internal_kv_initialized() -> bool:
    from ray_tpu_torch._raylet import global_state

    return global_state.core_worker is not None


def _ns_key(key: bytes, namespace: Optional[bytes]) -> bytes:
    key = key.encode() if isinstance(key, str) else key
    if namespace:
        ns = namespace.encode() if isinstance(namespace, str) else namespace
        return ns + b"::" + key
    return key


def internal_kv_put(key, value, overwrite: bool = True,
                    namespace: Optional[bytes] = None) -> bool:
    value = value.encode() if isinstance(value, str) else value
    return _kv().kv_put(_ns_key(key, namespace), value, overwrite=overwrite)


def internal_kv_get(key, namespace: Optional[bytes] = None) -> Optional[bytes]:
    return _kv().kv_get(_ns_key(key, namespace))


def internal_kv_exists(key, namespace: Optional[bytes] = None) -> bool:
    return _kv().kv_exists(_ns_key(key, namespace))


def internal_kv_del(key, del_by_prefix: bool = False,
                    namespace: Optional[bytes] = None) -> int:
    return _kv().kv_del(_ns_key(key, namespace), del_by_prefix=del_by_prefix)


def internal_kv_list(prefix, namespace: Optional[bytes] = None) -> List[bytes]:
    return _kv().kv_keys(_ns_key(prefix, namespace))
