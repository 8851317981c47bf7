"""Token sampling on the logits' device (counterpart of
`qwen3_asr_gguf_tpu/ops/sampling.py`): the llama.cpp chain top_k(50) ->
top_p -> temperature -> categorical, or greedy when temperature == 0.

The random draw comes from an explicit `torch.Generator` on the logits'
device; it gives other numbers than the JAX key for the same seed.
"""

from __future__ import annotations

import torch


def sample_topk_topp(
    logits: torch.Tensor,  # [V] f32
    generator: torch.Generator,
    temperature: float,
    top_p: float = 1.0,
    top_k: int = 50,
) -> torch.Tensor:
    vals, idx = torch.topk(logits, min(top_k, logits.shape[-1]))  # exact, sorted
    scaled = vals / max(temperature, 1e-6)
    # top-p over the top-k candidates; keep a token while the probability
    # mass before it is < top_p, so at least one survives
    probs = torch.softmax(scaled, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    masked = torch.where(cum_before < top_p, scaled, torch.full_like(scaled, -float("inf")))
    choice = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)
    return idx[choice[0]]


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: float,
    top_p: float = 1.0,
    top_k: int = 50,
) -> torch.Tensor:
    """Greedy at temperature <= 0, else the top-k/top-p chain."""
    if temperature <= 0.0:
        return sample_greedy(logits)
    return sample_topk_topp(logits, generator, temperature, top_p, top_k)
