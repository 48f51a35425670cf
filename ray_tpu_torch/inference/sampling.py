"""Token sampling with the JAX package's semantics (`ray_tpu/inference/
sampling.py`): greedy is argmax; top-k keeps every logit >= the k-th
largest, ties included; top-p keeps the smallest sorted prefix whose
cumulative probability reaches top_p. Random draws come from an explicit
`torch.Generator`; they cannot reproduce `jax.random`'s, so tests hold the
two on the kept support, and greedy exactly."""

from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits, top_k: int = 0, top_p: float = 1.0):
    """logits [B, vocab] (already divided by the temperature) -> the same
    with every token outside the top-k / top-p support set to -inf."""
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= top_p; an index
        # past the end (rounding) clamps to the last, as JAX's gather does.
        cutoff_idx = torch.sum(cum < top_p, dim=-1).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_token(logits, generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
    """logits: [B, vocab] -> [B] int64 token ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits.float() / temperature, top_k, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
