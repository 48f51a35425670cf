"""`chip_smoke.py`'s phase (u), the port's own runtime on the card,
rehearsed on the CPU.

The node fakes one card (`resources={"GPU": 1}` and a fake `GpuInfo`),
the engine is the tiny config in fp32 on the CPU, and the tensor, the
prompts and the round trips are small. Everything of (u) runs as on the
card (the GPU actor's binding and spawn, its `forward` logits and tokens
against the driver's copy, the tensor there and back through the native
store, the round trips) except the kernel: on the CPU `forward` takes the
plain attention, so the checks that fail are those of the actor's
flash_fwd launches.
"""

import dataclasses
import os

import torch

import chip_smoke as cs
from ray_tpu_torch._private.accelerators import nvidia
from ray_tpu_torch.models import llama

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def test_chip_smoke_phase_u_rehearsed_on_the_cpu(monkeypatch):
    fake = nvidia.GpuInfo(1, (CARD.split(",")[0],), (85899345920,))
    for name, value in (
            ("DEVICE", "cpu"),
            ("RUNTIME_CONFIG", dataclasses.replace(
                llama.LlamaConfig.tiny(vocab_size=64), dtype=torch.float32)),
            ("RUNTIME_PROMPTS", (3, 5, 9, 12)), ("RUNTIME_NEW", 4),
            ("RUNTIME_MAX_LEN", 32), ("RUNTIME_TENSOR_BYTES", 1 << 18),
            ("RUNTIME_ITERS", 2), ("RUNTIME_CALLS", 20),
            ("RUNTIME_INIT", dict(num_cpus=2, resources={"GPU": 1},
                                  _gpu_info=fake))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # the phase puts the checkout on PYTHONPATH for its workers
    monkeypatch.setenv("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    out = cs.phase_runtime(CARD)
    assert failed == ["(u-2) the GPU actor never launched flash_fwd",
                      "(u-2) the actor launched flash_fwd 0 times, not one a "
                      "layer a prompt (8)"]
    assert out["flash_fwd_launches"] == 0
    assert out["to_actor_gb_s"] > 0 and out["from_actor_gb_s"] > 0
    assert out["task_round_trip_p50_ms"] > 0
    assert out["card_uuids"] is None  # one card: (u-4) not run
