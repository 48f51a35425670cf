"""What an NVIDIA card can do at best, for MFU and roofline bounds.

Counterpart of `ray_tpu/_private/accelerators/tpu.py`'s
`bf16_peak_flops_per_chip`. Dense rates without sparsity and device-memory
bandwidths from NVIDIA's H100 data sheet, keyed by the part a
`torch.cuda.get_device_name` string names. Unlike the TPU table, a card it
does not know raises: a wrong peak would give a wrong MFU without a word.
"""

from __future__ import annotations

from typing import Tuple

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


def bf16_peak_flops_per_device(name: str) -> float:
    """Dense bf16 peak of the card named `name`
    (`torch.cuda.get_device_name`): H100 SXM 989e12, PCIe 756e12, NVL
    835e12. Raises for a card not in the table."""
    return peaks(name)[0]
