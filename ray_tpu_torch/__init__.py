"""ray_tpu_torch: the PyTorch/CUDA counterpart of `ray_tpu`, for NVIDIA Hopper.

Module names follow the JAX package so each counterpart is easy to find
(`ray_tpu.models.llama` -> `ray_tpu_torch.models.llama`). The package imports
torch and numpy only: nothing of JAX and nothing of `ray_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA and no explicit CPU request they raise (see `_private.device`).
"""

from ray_tpu_torch._private.device import device_info, resolve_device  # noqa: F401
