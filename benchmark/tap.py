"""What the port's logits put first at each token it samples.

The port samples from its top 50 at the cell's temperature, so a served
token tells little of how exactly its logits were computed. This tap wraps
the single-stream sampler (`runtime/generate.py`'s `sample`) and keeps, for
every token sampled, the token the logits put first beside the one drawn:
the greedy token of that position, which the reference judges by its gap
below the reference's best.

The record lives on the device and is written by device operations alone
(an argmax, a concatenation, an index copy at a device counter, the
counter's increment): nothing is read back while the port runs, and the
same operations stay valid inside a captured CUDA graph. It is read once,
after the window. Installed before the engine is built, so that warm-up
and any capture see it; `reset()` at the window's open.
"""

from __future__ import annotations

import numpy as np
import torch

CAPACITY = 1 << 20  # sampled tokens a window can hold (16 MiB)


class ArgmaxTap:
    def __init__(self, device, capacity: int = CAPACITY):
        self.capacity = capacity
        self.buf = torch.full((capacity, 2), -1, dtype=torch.int64, device=device)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)
        self._module = self._inner = None

    def install(self) -> None:
        from qwen3_asr_gguf_tpu_torch.runtime import generate

        inner = generate.sample
        buf, ctr, last = self.buf, self.ctr, self.capacity - 1

        def sample(logits, *a, **k):
            tok = inner(logits, *a, **k)
            pair = torch.cat([logits.argmax(-1).view(1), tok.view(1).to(torch.int64)])
            buf.index_copy_(0, ctr.clamp(max=last), pair.view(1, 2))
            ctr.add_(1)
            return tok

        self._module, self._inner = generate, inner
        generate.sample = sample

    def remove(self) -> None:
        if self._module is not None:
            self._module.sample = self._inner
            self._module = None

    def reset(self) -> None:
        self.buf.fill_(-1)
        self.ctr.zero_()

    def read(self) -> tuple[np.ndarray, np.ndarray, bool]:
        """(argmax, sampled) of every token since `reset`, in device order,
        and whether the record overflowed."""
        n = int(self.ctr.item())
        rec = self.buf[: min(n, self.capacity)].cpu().numpy()
        return rec[:, 0], rec[:, 1], n > self.capacity


def firsts(served: list, argmax: np.ndarray, sampled: np.ndarray) -> list:
    """For each served token after the first, the token the port's logits
    put first where it sampled it, or None where the record does not hold
    the served run. A chunk or feed samples its first token apart from the
    rest (`_start`), and the rest as one run, so the run served[1:] is
    looked up whole in the record."""
    out: list = [None] * len(served)
    run = np.asarray(served[1:], dtype=np.int64)
    if len(run) == 0 or len(sampled) < len(run):
        return out
    hits = np.flatnonzero(sampled[: len(sampled) - len(run) + 1] == run[0])
    for p in hits:
        if np.array_equal(sampled[p:p + len(run)], run):
            out[1:] = [int(t) for t in argmax[p:p + len(run)]]
            break
    return out
