"""Native (C++) components of the port's runtime.

The reference implements its runtime hot paths in C++ (plasma store,
raylet, core worker — SURVEY §2.1); the port keeps the same split as the
JAX package: the node-local object store lives in C++ here
(`src/shm_store.cc`), bound into Python with ctypes (no pybind11 in the
image).

Libraries are compiled on demand with g++ and cached in `build/` beside
the sources (keyed by a source hash), as `lib<name>-<hash>.so`: the host
libraries are named after their `src/*.cc` (`libshm_store-...`), apart from
the nvcc outputs of `ops/_build.py` there, which are named after their
`ops/csrc/*.cu` (`libflash_fwd-...`). The repo carries sources, not
binaries.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_lock = threading.Lock()
_built: dict = {}


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str, sources: Optional[list] = None) -> str:
    """Compile ray_tpu_torch/_native/src/<name>.cc into a cached .so; return path.

    RT_NATIVE_SANITIZE=thread|address builds with the matching
    -fsanitize flag (reference: the TSAN/ASAN bazel configs,
    .bazelrc:104-121); sanitized builds cache under a distinct tag and
    report races/UB on the processes' stderr at runtime.
    """
    sources = sources or [os.path.join(_SRC_DIR, f"{name}.cc")]
    sanitize = os.environ.get("RT_NATIVE_SANITIZE", "")
    with _lock:
        key = (name, sanitize)
        if key in _built:
            return _built[key]
        h = hashlib.sha256(sanitize.encode())
        for s in sources:
            with open(s, "rb") as f:
                h.update(f.read())
        tag = h.hexdigest()[:16]
        out = os.path.join(_BUILD_DIR, f"lib{name}-{tag}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = out + f".tmp.{os.getpid()}"
            extra = []
            if sanitize in ("thread", "address"):
                extra = [f"-fsanitize={sanitize}", "-fno-omit-frame-pointer",
                         "-O1"]
            cmd = [
                "g++", "-O2", "-g", "-std=c++17", "-shared", "-fPIC",
                "-pthread", *extra, "-o", tmp, *sources,
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"g++ failed for {name}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        _built[key] = out
        return out


def try_build_library(name: str) -> Optional[str]:
    """build_library, or None when no toolchain is available."""
    try:
        return build_library(name)
    except (NativeBuildError, FileNotFoundError, OSError):
        return None
