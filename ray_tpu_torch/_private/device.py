"""Device selection for the port's entry points.

The port's work is meant for the card, so an entry point given no device
takes `cuda` and raises when there is none. The CPU is used only when a
caller asks for it by name, as the CPU tests do: a silent fallback would let
a run on the wrong device pass for a run on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> cuda (raises without CUDA); "cpu" -> cpu; "cuda[:i]" -> it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain CPU path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")


def device_info() -> dict:
    """Name and count of the CUDA devices; raises without CUDA."""
    resolve_device()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
