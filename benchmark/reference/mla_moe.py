"""The plain reference of the DeepSeek-V3 text decoder (multi-head latent
attention, sparse experts) behind the Qwen3-ASR audio tower, in float32
PyTorch with TF32 off: the benchmark's frozen copy of the port's
`models/mla_moe_ref.py`, with the controls' precisions (`model.Precision`)
and the weights read from the checkpoint's bytes one layer at a time. It
imports nothing of the port or of the JAX package.

The equations (Moonlight-16B-A3B's config.json; transformers'
`modeling_deepseek_v3.py`), `t` the decoder's fields:

    x = rms(h) * attn_norm
    q = x W_q^T [T, H, nope + rope]; [c | k_pe] = x W_kv_a^T; c = rms(c) * kv_a_norm
    [k_nope | v] = c W_kv_b^T per head; RoPE on q's rope dims and on k_pe, adjacent
    pairs (2i, 2i + 1) at theta^(-2i / rope) (the stated layout)
    o = softmax((q_nope k_nope + q_pe k_pe) / sqrt(nope + rope), causal) v; h += o W_o^T
    y = rms(h) * mlp_norm; a dense layer adds SwiGLU(y); a MoE layer adds
    sum_i w_i SwiGLU_i(y) + SwiGLU_shared(y), the experts the top_k of
    sigmoid(y W_r^T) + bias, w_i their sigmoid scores renormalised times
    routed_scaling_factor

The control rounds every activation that enters a product (the router's,
the experts' and the attention's projections included) and the cache's c
and k_pe as `model.Precision` says; W_kv_b's products stay f32, as the port
computes them.

Weights at the configuration's "int4": q4_k and q4_0 matrices exact; the
q6_k head re-fitted to factored int4 (`quant.int4_factored`), as the port
repacks it; f32 norms, router and bias. One layer's weights exist in f32 at
a time (`Decoder.layer`), decoded on the device from the checkpoint's bytes,
which are kept there.

Routing. With random weights the router's sigmoid scores of 64 experts lie
close together: at Moonlight's widths the margin between the 6th and the
7th biased score is under 1e-3 at ~6% of a layer's rows, and a bf16
rounding of the router's input swaps an expert at 1-3% of them (measured
on an H100 with the cell's checkpoint). A swap changes that row's layer output by ~30%, and over 26
layers the port's and an f32 forward's hidden states part by ~40%, whatever
the precision. So the reference routes each row with the experts the port
chose (`forced`, from the architecture's tap) and judges the choice apart:
each forced choice's gap below the reference's own k-th best biased score
(0 where they agree), so that a router that chooses wrong fails, and a
swap at a near-tie passes. `near_ties` counts the margins under NEAR_TIE.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import gguf, quant
from .. import q4_0 as q40
from . import check, model, weights

NEAR_TIE = 1e-3
ATTN = {"attn_norm": "attn_norm.weight", "wq": "attn_q.weight",
        "wkv_a": "attn_kv_a_mqa.weight", "kv_a_norm": "attn_kv_a_norm.weight",
        "wkv_b": "attn_kv_b.weight", "wo": "attn_output.weight", "mlp_norm": "ffn_norm.weight"}
DENSE = {"gate": "ffn_gate.weight", "up": "ffn_up.weight", "down": "ffn_down.weight"}
MOE = {"router": "ffn_gate_inp.weight", "router_bias": "exp_probs_b.bias",
       "gate_exps": "ffn_gate_exps.weight", "up_exps": "ffn_up_exps.weight",
       "down_exps": "ffn_down_exps.weight", "gate_shexp": "ffn_gate_shexp.weight",
       "up_shexp": "ffn_up_shexp.weight", "down_shexp": "ffn_down_shexp.weight"}


class Decoder:
    """The checkpoint's decoder on `device`: every tensor's bytes, and the
    embed, final norm and head in f32; `layer(i)` decodes layer i."""

    def __init__(self, path: Path, t: dict, precision: str, device):
        self.t, self.device = t, torch.device(device)
        r = gguf.Reader(str(path))
        self.raw = {name: (shape, typ, torch.from_numpy(np.array(b)).to(self.device))
                    for name, (shape, typ, b) in r.tensors.items()}
        self.precision = precision
        self.embed = self._get("token_embd.weight")
        self.final_norm = self._get("output_norm.weight")
        head = self._get("output.weight")
        self.lm_head = quant.int4_factored(head) if precision == "int4" else head

    def __getitem__(self, key: str) -> torch.Tensor:
        return {"embed": self.embed, "final_norm": self.final_norm, "lm_head": self.lm_head}[key]

    def _get(self, name: str) -> torch.Tensor:
        shape, typ, b = self.raw[name]
        if typ == gguf.F32:
            return b.view(torch.float32).reshape(shape)
        if typ == gguf.F16:
            return b.view(torch.float16).float().reshape(shape)
        rows = b.reshape(int(np.prod(shape[:-1])), -1)
        fn = {gguf.Q4_K: quant.decode_q4_k, gguf.Q6_K: quant.decode_q6_k,
              q40.Q4_0: q40.decode_q4_0}[typ]
        return fn(rows, shape[-1]).reshape(shape)

    def layer(self, i: int) -> dict:
        names = dict(ATTN, **(DENSE if i < self.t["first_k_dense_replace"] else MOE))
        return {mine: self._get(f"blk.{i}.{suffix}") for mine, suffix in names.items()}


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_pairs(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.double()[:, None] * inv[None]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = ang.cos().float().reshape(shape), ang.sin().float().reshape(shape)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).reshape(x.shape)


def swiglu(y, gate, up, down, prec: model.Precision):
    return prec.mm(F.silu(prec.mm(y, gate)) * prec.mm(y, up), down)


def attention(lw: dict, t: dict, x: torch.Tensor, prec: model.Precision) -> torch.Tensor:
    n, h = x.shape[0], t["num_heads"]
    nope, rope, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["kv_lora_rank"]
    pos = torch.arange(n, device=x.device)
    q = prec.mm(x, lw["wq"]).reshape(n, h, nope + rope)
    ckv = prec.mm(x, lw["wkv_a"])
    c = prec.cache(rms(ckv[:, :r], lw["kv_a_norm"], t["rms_norm_eps"]))
    k_pe = prec.cache(rope_pairs(ckv[:, r:], pos, t["rope_theta"]))
    q_pe = rope_pairs(q[..., nope:], pos, t["rope_theta"])
    kv = (c @ lw["wkv_b"].t()).reshape(n, h, -1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    s = (torch.einsum("thd,shd->hts", q[..., :nope], k_nope)
         + torch.einsum("thd,sd->hts", q_pe, k_pe)) / math.sqrt(nope + rope)
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    o = torch.einsum("hts,shd->thd", torch.softmax(s.masked_fill(~mask, float("-inf")), -1), v)
    return prec.mm(o.reshape(n, -1), lw["wo"])


def moe(lw: dict, t: dict, y: torch.Tensor, prec: model.Precision, forced, stats: dict
        ) -> torch.Tensor:
    """The MoE layer over all rows: every expert chosen by some row runs on
    every row (so each product sees the rows the control rounds together)
    and is weighted by the routing, 0 where it was not chosen. `forced`
    [n, k] (or None): the experts of the first n rows, as the port chose
    them; the weights are this pass's own scores at those experts. `stats`
    gathers the routing: the choices made ("chosen"), each forced row's gap
    below this pass's k-th best biased score ("gaps", 0 where the forced
    experts are this pass's top k), the rows whose choice differs ("flips")
    and the near-ties."""
    k = t["num_experts_per_tok"]
    scores = torch.sigmoid(prec.act(y) @ lw["router"].t())
    biased = scores + lw["router_bias"]
    top = torch.topk(biased, k + 1, dim=-1)
    stats.setdefault("near_ties", []).append(
        int((top.values[:, k - 1] - top.values[:, k] < NEAR_TIE).sum()))
    idx = top.indices[:, :k]
    if forced is not None:
        n = forced.shape[0]
        gap = (top.values[:n, k - 1, None] - biased[:n].gather(1, forced)).amax(-1).clamp(min=0)
        stats.setdefault("gaps", []).append(gap)
        own = torch.zeros_like(biased[:n], dtype=torch.bool).scatter(1, idx[:n], True)
        stats.setdefault("flips", []).append(int((~own.gather(1, forced)).any(-1).sum()))
        idx = torch.cat([forced, idx[n:]])
    stats.setdefault("chosen", []).append(idx)
    w = scores.gather(-1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * t["routed_scaling_factor"]
    dense = torch.zeros_like(scores).scatter(1, idx, w)
    out = swiglu(y, lw["gate_shexp"], lw["up_shexp"], lw["down_shexp"], prec)
    for e in torch.unique(idx).tolist():
        out += dense[:, e:e + 1] * swiglu(y, lw["gate_exps"][e], lw["up_exps"][e],
                                          lw["down_exps"][e], prec)
    return out


def decode_logits(dec: Decoder, t: dict, emb: torch.Tensor, at: torch.Tensor,
                  prec: model.Precision, forced: list | None = None,
                  stats: dict | None = None) -> torch.Tensor:
    """Input embeddings [T, D] at positions 0..T-1 -> head logits at rows
    `at`, decoding one layer's weights at a time; `forced` gives each MoE
    layer's forced experts (see `moe`), `stats` gathers the routing."""
    eps = t["rms_norm_eps"]
    stats = {} if stats is None else stats
    x = emb
    for i in range(t["num_layers"]):
        lw = dec.layer(i)
        x = x + attention(lw, t, rms(x, lw["attn_norm"], eps), prec)
        y = rms(x, lw["mlp_norm"], eps)
        if i < t["first_k_dense_replace"]:
            x = x + swiglu(y, lw["gate"], lw["up"], lw["down"], prec)
        else:
            layer_forced = None if forced is None else forced[i - t["first_k_dense_replace"]]
            x = x + moe(lw, t, y, prec, layer_forced, stats)
        del lw
    x = rms(x[at], dec.final_norm, eps)
    k = prec.decode_from  # the head's rows: `at`, renumbered from 0
    prec.decode_from = None if k is None else max(0, k - int(at[0]))
    out = prec.mm(x, dec.lm_head)
    prec.decode_from = k
    return out


class Reference(check.Reference):
    """`check.Reference` (the gaps of the port's first and served tokens)
    with this decoder: `t` is the decoder's fields (`architectures/mla_moe.
    text_config`). `logits` routes each MoE layer's rows as `job["routes"]`
    says (the port's choices, one [rows, k] array per MoE layer, kept by the
    architecture's tap) where the job has them, and keeps the routing's
    statistics of the last job in `stats`."""

    def __init__(self, ckpt: Path, cfg: dict, t: dict, device, control: str | None = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.a, self.t = cfg["model"]["audio"], t
        prec = cfg["engine"]["precision"]
        self.device = torch.device(device)
        self.enc = weights.encoder(ckpt, prec, self.device)
        self.dec = Decoder(ckpt / "qwen3_asr_llm.q4_k.gguf", t, prec, self.device)
        self.filters = torch.from_numpy(np.load(ckpt / "mel_filters.npy")).to(self.device)
        self.prec = model.Precision(control)
        self.stats: dict = {}

    @torch.no_grad()
    def logits(self, job: dict, prec: model.Precision | None = None,
               forced="job") -> torch.Tensor:
        """[len(served), V] at each served position. `prec` (default this
        reference's); `forced` each MoE layer's experts ([rows, k]), the
        job's "routes" by default, None for this pass's own routing."""
        prec = self.prec if prec is None else prec
        if isinstance(forced, str):
            forced = job.get("routes")
        if forced is not None:
            forced = [torch.as_tensor(r, dtype=torch.long, device=self.device)
                      for r in forced]
        served = job["served"]
        prompt = self._embeddings(job["parts"], prec)
        feed = self.dec["embed"][torch.as_tensor(served[:-1], dtype=torch.long,
                                                 device=self.device)]
        emb = torch.cat([prompt, feed]) if len(served) > 1 else prompt
        at = torch.arange(prompt.shape[0] - 1, emb.shape[0], device=self.device)
        prec.decode_from = prompt.shape[0]
        self.stats = {}
        out = decode_logits(self.dec, self.t, emb, at, prec, forced, self.stats)
        prec.decode_from = None
        return out

    def _embeddings(self, parts: list, prec: model.Precision | None = None) -> torch.Tensor:
        keep = self.prec
        self.prec = self.prec if prec is None else prec
        try:
            return super()._embeddings(parts)
        finally:
            self.prec = keep
