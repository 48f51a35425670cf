"""Compile-check entry of the port: the counterpart of
`__graft_entry__.entry()`.

`entry(device)` returns the forward step of the flagship model (Llama-3-8B
head shapes at d_model 1024, 4 layers; `__graft_entry__._flagship_config`)
with example arguments sized for one card: tokens [1, 512]. The step
compiles under `torch.compile(fn, fullgraph=True)`; the flash forward is a
custom operator inside its graph. Weights come from a seeded
`torch.Generator` (torch cannot reproduce `jax.random`; the tests carry the
JAX `init(PRNGKey(0))` across with `models/convert.py`). The multi-chip dry
run (`dryrun_multichip`) waits for the multi-GPU slice.
"""

from __future__ import annotations

import torch

from ray_tpu_torch._private.device import resolve_device


def flagship_config():
    """Llama-3-8B head shapes (d_head 128, GQA) at reduced width and depth,
    as the JAX entry's."""
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=32_000, d_model=1024, n_layers=4, n_heads=8,
        n_kv_heads=4, d_head=128, d_ff=3584, max_seq_len=2048,
    )


def entry(device=None):
    """-> (fn, example_args): the flagship forward step, (params, tokens)
    -> logits [1, 512, vocab] fp32, and its arguments on `device` (cuda by
    default; raises without it unless given "cpu")."""
    from ray_tpu_torch.models import llama

    dev = resolve_device(device)
    config = flagship_config()
    params = llama.init(config, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.zeros((1, 512), dtype=torch.int64, device=dev)

    def forward_step(params, tokens):
        return llama.forward(params, tokens, config)

    return forward_step, (params, tokens)
