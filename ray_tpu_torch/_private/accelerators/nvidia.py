"""What an NVIDIA card can do at best, for MFU and roofline bounds.

Counterpart of `ray_tpu/_private/accelerators/tpu.py`'s
`bf16_peak_flops_per_chip`. Dense rates without sparsity and device-memory
bandwidths from NVIDIA's H100 data sheet, keyed by the part a
`torch.cuda.get_device_name` string names. Unlike the TPU table, a card it
does not know raises: a wrong peak would give a wrong MFU without a word.

Also the counterpart of `detect_tpu` and `apply_tpu_detection`: the host's
cards (`detect_gpu`), merged into a node's resources and labels
(`apply_gpu_detection`), and the environment that binds a rank to its card
before its first CUDA call (`visible_devices_env`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

# part -> (dense bf16 FLOP/s, device-memory bytes/s)
_PEAKS = {
    "H100 SXM": (989e12, 3.35e12),
    "H100 PCIe": (756e12, 2.0e12),
    "H100 NVL": (835e12, 3.9e12),
}


def _part(name: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'H100 SXM'; raises for an unknown card."""
    if "H100" in name:
        if "NVL" in name:
            return "H100 NVL"
        if "PCIe" in name:
            return "H100 PCIe"
        if "SXM" in name or "HBM3" in name:
            return "H100 SXM"
    raise ValueError(f"no peak rates known for the card {name!r}; add its "
                     "data-sheet figures to ray_tpu_torch/_private/"
                     "accelerators/nvidia.py")


def peaks(name: str) -> Tuple[float, float]:
    """(dense bf16 FLOP/s, device-memory bytes/s) of the named card."""
    return _PEAKS[_part(name)]


# part -> dense fp32 FLOP/s outside the tensor cores (no TF32)
_FP32_PEAKS = {"H100 SXM": 67e12, "H100 PCIe": 51e12, "H100 NVL": 60e12}


def fp32_peak_flops_per_device(name: str) -> float:
    """fp32 peak of the named card without the tensor cores, for work that
    runs in full fp32 (TF32 off): H100 SXM 67e12, PCIe 51e12, NVL 60e12."""
    return _FP32_PEAKS[_part(name)]


def bf16_peak_flops_per_device(name: str) -> float:
    """Dense bf16 peak of the card named `name`
    (`torch.cuda.get_device_name`): H100 SXM 989e12, PCIe 756e12, NVL
    835e12. Raises for a card not in the table."""
    return peaks(name)[0]


# -- detection and per-rank binding -------------------------------------------
#
# Counterpart of `ray_tpu/_private/accelerators/tpu.py`'s `detect_tpu` and
# `apply_tpu_detection`: what this host's cards are, merged into a node's
# resources and labels, and the environment that binds a rank to its card.

ACCELERATOR_TYPE_LABEL = "ray_tpu_torch.io/accelerator-type"


@dataclasses.dataclass(frozen=True)
class GpuInfo:
    """The host's CUDA cards as `torch.cuda` sees them: how many, each one's
    name and device memory in bytes."""
    count: int
    names: Tuple[str, ...]
    memory_bytes: Tuple[int, ...]

    @property
    def accelerator_type(self) -> str:
        """The part of the first card ('H100 SXM'), or its name as torch
        gives it where the peak table does not know it."""
        try:
            return _part(self.names[0])
        except ValueError:
            return self.names[0]


def detect_gpu() -> Optional[GpuInfo]:
    """The visible CUDA cards, or None on a host without any. Reads
    `torch.cuda.get_device_properties`, which initialises CUDA in this
    process: a launcher that binds ranks to cards calls it in a probe
    process (`_private.backend_probe`) or after binding."""
    import torch

    if not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n == 0:
        return None
    props = [torch.cuda.get_device_properties(i) for i in range(n)]
    return GpuInfo(n, tuple(p.name for p in props),
                   tuple(int(p.total_memory) for p in props))


def apply_gpu_detection(resources: Dict[str, float],
                        labels: Optional[Dict[str, str]] = None,
                        info: Optional[GpuInfo] = None
                        ) -> Optional[GpuInfo]:
    """Merge the detected cards into a node's advertisement: the `GPU`
    count and the accelerator-type label. Values the caller set win (a node
    started with resources={"GPU": 2} keeps 2). Mutates both dicts;
    returns the detection (None, and no change, without cards)."""
    info = detect_gpu() if info is None else info
    if info is None:
        return None
    resources.setdefault("GPU", float(info.count))
    if labels is not None:
        labels.setdefault(ACCELERATOR_TYPE_LABEL, info.accelerator_type)
    return info


def visible_devices_env(ids: Sequence[int],
                        env: Optional[Mapping[str, str]] = None
                        ) -> Dict[str, str]:
    """A copy of `env` (default os.environ) that binds a process to the
    cards `ids` of the allotment `env` already names: the ids pick entries
    of its CUDA_VISIBLE_DEVICES when that is set (a job given cards 4-7 binds
    id 1 to card 5, never to another job's card 1), physical indices when
    it is not. An id past the allotment raises. It takes effect only if it
    is in the process's environment before its first CUDA call; the process
    then sees its cards as cuda:0, cuda:1, ... An empty `ids` hides every
    card."""
    out = dict(os.environ if env is None else env)
    allotted = out.get("CUDA_VISIBLE_DEVICES")
    if allotted is None:
        cards = [str(int(i)) for i in ids]
    else:
        given = [c.strip() for c in allotted.split(",") if c.strip()]
        if any(not 0 <= int(i) < len(given) for i in ids):
            raise RuntimeError(f"cards {list(ids)} asked of an allotment of "
                               f"{len(given)} (CUDA_VISIBLE_DEVICES="
                               f"{allotted!r})")
        cards = [given[int(i)] for i in ids]
    out["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
    return out
