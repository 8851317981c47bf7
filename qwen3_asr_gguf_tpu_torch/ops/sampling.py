"""Token sampling on the logits' device (counterpart of
`qwen3_asr_gguf_tpu/ops/sampling.py`): the llama.cpp chain top_k(50) ->
top_p -> temperature -> categorical, or greedy when temperature == 0.

The random draw comes from an explicit `torch.Generator` on the logits'
device; it gives other numbers than the JAX key for the same seed.
"""

from __future__ import annotations

import torch


def _topk_topp_draw(logits: torch.Tensor, generator: torch.Generator,
                    temperature: torch.Tensor | float, top_p: float, top_k: int) -> torch.Tensor:
    """logits [B, V], temperature a float or [B, 1] -> one token per row."""
    vals, idx = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)  # exact, sorted
    if isinstance(temperature, torch.Tensor):
        scaled = vals / torch.clamp(temperature, min=1e-6)
    else:
        scaled = vals / max(temperature, 1e-6)
    # top-p over the top-k candidates; keep a token while the probability
    # mass before it is < top_p, so at least one survives
    probs = torch.softmax(scaled, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    masked = torch.where(cum_before < top_p, scaled, torch.full_like(scaled, -float("inf")))
    choice = _categorical(torch.softmax(masked, dim=-1), generator)
    return torch.gather(idx, -1, choice)[:, 0]


def _categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of `probs` [B, N] -> [B, 1]: the draw of
    `torch.multinomial(probs, 1, generator=generator)` (its one-sample path:
    argmax of p / q, q ~ Exp(1), from the same generator stream), without
    its checks of the probabilities, which read them back to the host and
    so would stop the host at every sampled token on the card."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1, keepdim=True)


def sample_topk_topp(
    logits: torch.Tensor,  # [V] f32
    generator: torch.Generator,
    temperature: float,
    top_p: float = 1.0,
    top_k: int = 50,
) -> torch.Tensor:
    return _topk_topp_draw(logits[None], generator, temperature, top_p, top_k)[0]


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


def sample_rows(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator,
    temperatures: torch.Tensor,  # [B] f32
    greedy: torch.Tensor,  # [B] bool
    dones: torch.Tensor,  # [B] bool, rows latched done
    toks: torch.Tensor,  # [B] int64, the tokens fed this step
    eos_ids: torch.Tensor,  # [E] int64
    top_p: float = 1.0,
    top_k: int = 50,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of per-row sampling for the batched decode (the JAX
    batcher's `sample_row`, continuous.py:400-409) -> (next tokens, next
    done latches, emitted). Greedy rows take the exact argmax, the others
    the top-k/top-p chain at their own temperature; every row draws from
    the one `generator`. A row already done keeps its token and emits -1;
    a row that samples an EOS latches done."""
    sampled = _topk_topp_draw(logits, generator, temperatures[:, None], top_p, top_k)
    nxt = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    emitted = torch.where(dones, torch.full_like(toks, -1), toks)
    next_dones = dones | torch.isin(nxt, eos_ids)
    return torch.where(dones, toks, nxt), next_dones, emitted
