"""Port parity: the sampling chain of qwen3_asr_gguf_tpu_torch/ops/sampling.py
against the JAX package. The two frameworks draw different random numbers,
so the test holds the port's draws against the JAX chain's exact
distribution (top-k candidates, top-p cut, temperature): every draw lies in
the kept set, and 4000 seeded draws land within 0.03 of each probability."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.ops import sampling as js
from qwen3_asr_gguf_tpu_torch.ops import sampling as ts

DRAWS = 4000


def _logits(seed, v=1000):
    return (np.random.default_rng(seed).standard_normal(v) * 2.0).astype(np.float32)


def _jax_distribution(logits, temperature, top_p, top_k=50) -> dict[int, float]:
    """Token -> probability of the JAX chain (`sample_topk_topp` up to the
    categorical draw)."""
    vals, idx = js._topk_blocked(jnp.asarray(logits), top_k)
    scaled = vals / max(temperature, 1e-6)
    probs = jax.nn.softmax(scaled)
    keep = (jnp.cumsum(probs) - probs) < top_p
    final = jax.nn.softmax(jnp.where(keep, scaled, -jnp.inf))
    return {int(i): float(p) for i, p in zip(np.asarray(idx), np.asarray(final)) if p > 0}


@pytest.mark.parametrize("temperature,top_p", [(0.4, 1.0), (1.0, 1.0), (0.4, 0.9), (2.0, 0.7)])
def test_draws_follow_the_jax_distribution(temperature, top_p):
    logits = _logits(int(temperature * 10) + int(top_p * 100))
    want = _jax_distribution(logits, temperature, top_p)
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(logits)
    draws = [int(ts.sample(x, gen, temperature, top_p=top_p)) for _ in range(DRAWS)]
    assert set(draws) <= set(want)
    counts = np.bincount(draws, minlength=len(logits)) / DRAWS
    assert max(abs(counts[t] - p) for t, p in want.items()) < 0.03


def test_greedy_equals_jax():
    for seed in range(5):
        logits = _logits(seed)
        gen = torch.Generator().manual_seed(0)
        got = int(ts.sample(torch.from_numpy(logits), gen, 0.0))
        assert got == int(js.sample(jnp.asarray(logits), None, 0.0, greedy=True))


def test_sample_rows_per_row_chain_and_latches():
    """The batched per-row sampler: each row draws from the JAX chain at
    its own temperature; greedy rows take the JAX argmax; a row already
    done keeps its token and emits -1; sampling an EOS latches done."""
    temps = [0.4, 2.0, 0.0, 1.0]
    rows = np.stack([_logits(40 + i) for i in range(4)])
    rows[2, 7] = rows[2].max() + 1.0  # the greedy row's argmax
    x = torch.from_numpy(rows)
    t = torch.tensor([max(v, 1e-6) for v in temps])
    greedy = torch.tensor([v <= 0 for v in temps])
    fed = torch.tensor([11, 12, 13, 14])
    eos = torch.tensor([7, 999])
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(DRAWS // 4):
        nxt, dones, emitted = ts.sample_rows(x, gen, t, greedy, torch.tensor([0, 0, 0, 1]).bool(),
                                            fed, eos)
        assert emitted.tolist() == [11, 12, 13, -1] and int(nxt[3]) == 14  # row 3 is done
        assert int(nxt[2]) == 7 and bool(dones[2]) and bool(dones[3])  # greedy hit an EOS
        assert bool(dones[0]) == (int(nxt[0]) in (7, 999))
        draws.append(nxt.tolist())
    draws = np.array(draws)
    for r in (0, 1):
        want = _jax_distribution(rows[r], temps[r], 1.0)
        assert set(draws[:, r].tolist()) <= set(want)
        counts = np.bincount(draws[:, r], minlength=rows.shape[1]) / len(draws)
        assert max(abs(counts[tok] - p) for tok, p in want.items()) < 0.05
    assert int(nxt[2]) == int(js.sample(jnp.asarray(rows[2]), None, 0.0, greedy=True))
