"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` on
its own into `ray_tpu_torch/_native/build/lib<name>-<hash>.so`, where the
hash covers every source under `csrc/` and the flags, so an edited source
builds anew and an unchanged one is loaded as it is. The sources include no
PyTorch header, which keeps a build to seconds. Nothing is built when a
module is imported: the first launch builds, or a caller (such as
`chip_smoke.py`) calls `build` up front to time it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_native" / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's messages, including ptxas registers and spills


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(*names: str) -> Dict[str, Built]:
    """Build the named kernels that are not built yet, one nvcc each, all
    started together. Raises with nvcc's output if any build fails."""
    out: Dict[str, Built] = {}
    running: Dict[str, Tuple[subprocess.Popen, Path, float]] = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = Built(name, path, 0.0, "")
            continue
        if not (CSRC / f"{name}.cu").exists():
            raise FileNotFoundError(CSRC / f"{name}.cu")
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Unique temporary name, renamed into place: a concurrent build
        # never loads a half-written library.
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(nvcc, name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        path = library_path(name)
        os.replace(tmp, path)
        out[name] = Built(name, path, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for `name`, building it first if needed. Callers
    keep the handle (the kernel modules cache theirs)."""
    return ctypes.CDLL(str(build(name)[name].path))
