"""What an NVIDIA card can do at best, for MFU and roofline bounds.

Counterpart of `ray_tpu/_private/accelerators/tpu.py`'s
`bf16_peak_flops_per_chip`. Dense rates without sparsity and device-memory
bandwidths from NVIDIA's H100 data sheet, keyed by the part a
`torch.cuda.get_device_name` string names. Unlike the TPU table, a card it
does not know raises: a wrong peak would give a wrong MFU without a word.

Also the counterpart of `detect_tpu`, `apply_tpu_detection` and
`RuntimeContext.get_accelerator_ids`: the host's cards, read by a probe
process (`probe_gpu`), a node's advertisement of them
(`node_advertisement`, the `resources=` and `labels=` a node of the runtime
is started with; `python -m ray_tpu_torch._private.accelerators` prints
the resources as JSON), the cards a worker was given (`accelerator_ids`),
and the environment that binds a rank to its card before its first CUDA
call (`visible_devices_env`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ray_tpu_torch._private import backend_probe

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


def typed_resource(info: GpuInfo) -> str:
    """The typed resource of `info`'s part, the counterpart of
    `TPU-<type>`: 'GPU-H100-SXM' (a card the peak table does not know:
    its name, spaces as hyphens)."""
    return "GPU-" + "-".join(info.accelerator_type.split())


def allotted(info: GpuInfo, env: Optional[Mapping[str, str]] = None
             ) -> Optional[GpuInfo]:
    """The cards of `info` (all of the host's) that the allotment in `env`
    (default os.environ) leaves a process, in the allotment's order: the
    entries of its CUDA_VISIBLE_DEVICES up to the first one that names no
    card, as CUDA enumerates them; all of them when it is unset. An
    allotment by UUID raises: `info` has no UUIDs to match (a probe
    started under that environment applies it, `node_advertisement`
    without `info`). None when nothing is left."""
    allot = (os.environ if env is None else env).get("CUDA_VISIBLE_DEVICES")
    if allot is None:
        ids = list(range(info.count))
    else:
        ids = []
        for entry in (e.strip() for e in allot.split(",")):
            if not entry:
                break
            if not entry.lstrip("-").isdigit():
                raise ValueError(f"CUDA_VISIBLE_DEVICES={allot!r} names a "
                                 "card by UUID; probe the cards under that "
                                 "environment instead of passing info")
            if not 0 <= int(entry) < info.count:
                break
            ids.append(int(entry))
    if not ids:
        return None
    return GpuInfo(len(ids), tuple(info.names[i] for i in ids),
                   tuple(info.memory_bytes[i] for i in ids))


def probe_gpu(env: Optional[Mapping[str, str]] = None,
              timeout_s: Optional[float] = None) -> Optional[GpuInfo]:
    """The cards a fresh process started under `env` (default os.environ)
    sees, read in that process (`backend_probe.probe_cards`), so that this
    one never initialises CUDA; None without any. A probe that crashes or
    times out raises."""
    cards = backend_probe.probe_cards(timeout_s, env)
    if not cards:
        return None
    return GpuInfo(len(cards), tuple(n for n, _ in cards),
                   tuple(m for _, m in cards))


def node_advertisement(resources: Optional[Mapping[str, float]] = None,
                       labels: Optional[Mapping[str, str]] = None, *,
                       info: Optional[GpuInfo] = None,
                       env: Optional[Mapping[str, str]] = None
                       ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """The `resources` and `labels` a node of the runtime advertises its
    cards with, the counterpart of `apply_tpu_detection`, which the JAX
    package's raylet runs: `GPU`, the cards of the allotment; the typed
    `GPU-<part>` (`typed_resource`) at the advertised `GPU` count, so a
    gang can pin the part it was sized for; and the accelerator-type
    label. Values the caller set win, and a host without cards gets
    nothing added. -> new dicts; the caller's are left as they were.

    `info` (default: a probe process started under `env`, `probe_gpu`,
    which raises if it crashes or times out) is the host's cards; the
    allotment in `env` (default os.environ), its CUDA_VISIBLE_DEVICES,
    then picks among them (`allotted`). Pass the result to the runtime's
    own arguments: `ray_tpu.init(resources=...)`,
    `Cluster.add_node(resources=..., labels=...)`, or `ray-tpu start
    --resources "$(python -m ray_tpu_torch._private.accelerators)"`."""
    resources, labels = dict(resources or {}), dict(labels or {})
    info = probe_gpu(env) if info is None else allotted(info, env)
    if info is None:
        return resources, labels
    resources.setdefault("GPU", float(info.count))
    resources.setdefault(typed_resource(info), resources["GPU"])
    labels.setdefault(ACCELERATOR_TYPE_LABEL, info.accelerator_type)
    return resources, labels


def accelerator_ids(ctx: Any, env: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, List[str]]:
    """The cards visible to this worker, the counterpart of the runtime
    context's `get_accelerator_ids`: {"GPU": [...]} from
    CUDA_VISIBLE_DEVICES in `env` (default os.environ) when it names any,
    else the indices of the `GPU` count the runtime assigned to the
    running task or actor. `ctx` is the runtime context the caller passes
    in (`ray_tpu.get_runtime_context()`); the port imports none."""
    visible = (os.environ if env is None else env).get("CUDA_VISIBLE_DEVICES")
    if visible:
        return {"GPU": [c.strip() for c in visible.split(",") if c.strip()]}
    n = int(ctx.get_assigned_resources().get("GPU", 0))
    return {"GPU": [str(i) for i in range(n)]}


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
