"""Run the reference over a run's sampled jobs and read the gaps.

At each served position the reference judges two tokens of the port:

- the token the port's logits put first there (`firsts`, kept by
  `benchmark/tap.py`): its gap below the reference's best logit, 0 where
  the two agree. This is the greedy comparison, and it reads how exactly
  the port computed its logits whatever token it then drew;
- the token served: the port draws from its top 50, so a sound served
  token lies within the reference's top 100 (twice the sampler's reach, so
  that near-ties at the 50th do not count); its gap below the reference's
  100th best, 0 inside.

A position's gap is the larger of the two. The control is the reference
computed one step below the configuration's precisions (`model.py`), put
in the port's place: at the same prompts and served tokens, the token that
it puts first is judged the same way.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import gguf
from ..tokenizer import BPETokenizer
from . import model, weights

SERVED_K = 100


def tokenizer(ckpt: Path) -> BPETokenizer:
    kv = gguf.Reader(str(ckpt / "qwen3_asr_llm.q4_k.gguf")).kv
    return BPETokenizer(list(kv["tokenizer.ggml.tokens"]), list(kv["tokenizer.ggml.merges"]),
                        [int(t) for t in kv["tokenizer.ggml.token_type"]],
                        eos_token_id=kv.get("tokenizer.ggml.eos_token_id"))


def numbers(gaps: list) -> dict:
    """The compared numbers of a run from its jobs' (gaps, judged) pairs:
    the widest and the mean gap over the judged positions, and how many
    positions the port's first tokens were judged at."""
    d = np.concatenate([g for g, _ in gaps]) if gaps else np.zeros(0)
    judged = int(sum(int(m.sum()) for _, m in gaps))
    return {"gap_widest": float(d.max()) if len(d) else None,
            "gap_mean": float(d.mean()) if len(d) else None, "judged": judged}


class Reference:
    """The configuration's ASR model in float32 on `device`, or with
    `control` ("fp8" or "int4dec", `model.Precision`) the control."""

    def __init__(self, ckpt: Path, cfg: dict, device, control: str | None = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.a, self.t = cfg["model"]["audio"], cfg["model"]["text"]
        prec = cfg["engine"]["precision"]
        self.device = torch.device(device)
        self.enc = weights.encoder(ckpt, prec, self.device)
        self.dec = weights.decoder(ckpt / "qwen3_asr_llm.q4_k.gguf", self.t, prec, self.device)
        self.filters = torch.from_numpy(np.load(ckpt / "mel_filters.npy")).to(self.device)
        self.prec = model.Precision(control)

    def _embeddings(self, parts: list) -> torch.Tensor:
        rows = []
        for part in parts:
            if part[0] == "ids":
                rows.append(self.dec["embed"][torch.as_tensor(part[1], dtype=torch.long,
                                                              device=self.device)])
            else:
                _, samples, n = part
                mel = model.log_mel(torch.as_tensor(samples, device=self.device), self.filters)
                rows.append(model.encode(self.enc, self.a, mel, self.prec)[:n])
        return torch.cat(rows)

    @torch.no_grad()
    def logits(self, job: dict) -> torch.Tensor:
        """[len(served), V]: the logits at each served position, the prompt
        and the served tokens before it as input."""
        served = job["served"]
        prompt = self._embeddings(job["parts"])
        feed = self.dec["embed"][torch.as_tensor(served[:-1], dtype=torch.long,
                                                 device=self.device)]
        emb = torch.cat([prompt, feed]) if len(served) > 1 else prompt
        at = torch.arange(prompt.shape[0] - 1, emb.shape[0], device=self.device)
        self.prec.decode_from = prompt.shape[0]
        out = model.decode_logits(self.dec, self.t, emb, at, self.prec)
        self.prec.decode_from = None
        return out

    @torch.no_grad()
    def gaps(self, job: dict, keep: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(gap per served position, where the port's first token was
        judged) of the port; with `keep`, the logits stay in job["ref"] for
        the control."""
        ref = self.logits(job)
        mask = np.array([f is not None for f in job["firsts"]], dtype=bool)
        firsts = torch.as_tensor([f if f is not None else 0 for f in job["firsts"]],
                                 device=self.device)
        g = ref.amax(-1) - ref.gather(1, firsts[:, None])[:, 0]
        g = torch.where(torch.as_tensor(mask, device=self.device), g, torch.zeros_like(g))
        if keep:
            job["ref"] = ref
        return torch.maximum(g, self._served_gap(ref, job)).cpu().numpy(), mask

    @torch.no_grad()
    def control_gaps(self, job: dict) -> tuple[np.ndarray, np.ndarray]:
        """The control's gaps at the positions the port was judged at, the
        float32 reference's logits taken from job["ref"]."""
        ref = job["ref"]
        mine = self.logits(job).argmax(-1)
        mask = np.array([f is not None for f in job["firsts"]], dtype=bool)
        g = ref.amax(-1) - ref.gather(1, mine[:, None])[:, 0]
        g = torch.where(torch.as_tensor(mask, device=self.device), g, torch.zeros_like(g))
        return torch.maximum(g, self._served_gap(ref, job)).cpu().numpy(), mask

    def _served_gap(self, ref: torch.Tensor, job: dict) -> torch.Tensor:
        kth = ref.topk(SERVED_K, dim=-1).values[:, -1]
        got = ref.gather(1, torch.as_tensor(job["served"], device=self.device)[:, None])[:, 0]
        return (kth - got).clamp(min=0)
