"""External object-spill storage backends.

Reference: ray python/ray/_private/external_storage.py:451 — spilled
objects can target S3-style remote storage (smart_open URIs) instead of
node-local disk, so objects spilled from a preemptible node survive the
node. Design here: one small backend interface, three implementations —

* ``LocalDirBackend`` (default): node-local directory, exactly the
  pre-existing behavior. Dies with the node's disk.
* ``FileUriBackend`` (``file:///mnt/shared/...``): a mounted shared
  filesystem (NFS, GCS-fuse on TPU-VMs). Remote in the sense that
  another raylet incarnation — same node or another node — can restore
  from it.
* ``FsspecBackend`` (``s3://``, ``gs://``, ...): any fsspec-supported
  object store; gated on fsspec being importable (not a baked dependency).

Remote backends register each spilled object's URI in the GCS internal KV
(namespace ``_spill``), so restores survive raylet restarts: a fresh
raylet with an empty in-memory spill map falls back to the cluster-wide
registry before declaring an object lost.

Configure with ``RT_OBJECT_SPILLING_URI``; unset keeps local-disk spill.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

logger = logging.getLogger(__name__)

# GCS internal-KV namespace for the cluster-wide spill registry.
SPILL_KV_NAMESPACE = "_spill"


class SpillBackend:
    """Where spilled object bytes live. put() returns a URI that get() and
    delete() accept; is_remote says whether the bytes outlive this node
    (and therefore belong in the cluster-wide registry)."""

    is_remote = False

    def put(self, key_hex: str, data) -> str:
        raise NotImplementedError

    def get(self, uri: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class LocalDirBackend(SpillBackend):
    """Node-local spill directory (the default)."""

    def __init__(self, directory: str):
        self.directory = directory

    def put(self, key_hex: str, data) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, key_hex)
        tmp = f"{path}.tmp.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def get(self, uri: str) -> Optional[bytes]:
        try:
            with open(uri, "rb") as f:
                return f.read()
        except OSError:
            return None

    def delete(self, uri: str) -> None:
        try:
            os.unlink(uri)
        except OSError:
            pass


class FileUriBackend(LocalDirBackend):
    """file://<dir> — a mounted shared filesystem. Same IO as local, but
    treated as surviving the node: URIs go to the cluster registry and
    any raylet may restore them."""

    is_remote = True

    def __init__(self, uri: str):
        super().__init__(uri[len("file://"):] or "/")

    def put(self, key_hex: str, data) -> str:
        return "file://" + super().put(key_hex, data)

    def get(self, uri: str) -> Optional[bytes]:
        return super().get(uri[len("file://"):])

    def delete(self, uri: str) -> None:
        super().delete(uri[len("file://"):])


class FsspecBackend(SpillBackend):
    """s3:// gs:// etc. through fsspec, when installed."""

    is_remote = True

    def __init__(self, base_uri: str):
        import fsspec  # gated: not a baked dependency

        self.base_uri = base_uri.rstrip("/")
        self._fs, _ = fsspec.core.url_to_fs(self.base_uri)

    def put(self, key_hex: str, data) -> str:
        uri = f"{self.base_uri}/{key_hex}"
        with self._fs.open(uri, "wb") as f:
            f.write(bytes(data))
        return uri

    def get(self, uri: str) -> Optional[bytes]:
        try:
            with self._fs.open(uri, "rb") as f:
                return f.read()
        except Exception:  # noqa: BLE001 — missing key / transient
            return None

    def delete(self, uri: str) -> None:
        try:
            self._fs.rm(uri)
        except Exception:  # noqa: BLE001 — already gone
            logger.debug("spill delete failed for %s", uri, exc_info=True)


def backend_from_config(node_id_hex: str) -> SpillBackend:
    from ray_tpu_torch._private.config import CONFIG

    uri = getattr(CONFIG, "object_spilling_uri", "") or ""
    if not uri:
        return LocalDirBackend(os.path.join(
            CONFIG.object_store_fallback_dir, node_id_hex))
    if uri.startswith("file://"):
        return FileUriBackend(uri)
    try:
        return FsspecBackend(uri)
    except Exception as e:  # noqa: BLE001 — missing fsspec OR a bad URI:
        # either way the node must degrade to local-disk spill, never
        # lose its whole object store to a config typo (the caller's
        # blanket except would null the store server AND client).
        logger.warning(
            "RT_OBJECT_SPILLING_URI=%s unusable (%s); falling back to "
            "node-local disk spill", uri, e)
        return LocalDirBackend(os.path.join(
            CONFIG.object_store_fallback_dir, node_id_hex))
