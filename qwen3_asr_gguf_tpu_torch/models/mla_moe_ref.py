"""The plain reference of the DeepSeek-V3 text decoder (multi-head latent
attention, sparse experts) in float32 PyTorch: one sequence, a full causal
forward from input embeddings to logits, with no kernels, no cache and no
batching. It imports nothing of this package or of the JAX package, so that
it stands apart from the code it checks.

The equations (Moonlight-16B-A3B's config.json, `model_type` deepseek_v3;
transformers' `modeling_deepseek_v3.py`), with `t` the config's fields:

    x = rms(h) * attn_norm
    q = x W_q^T -> [T, H, nope + rope]; [c | k_pe] = x W_kv_a^T
    c = rms(c) * kv_a_norm; [k_nope | v] = c W_kv_b^T -> [T, H, nope + v]
    RoPE on q's rope dims and on k_pe (one for all heads): adjacent pairs
    (2i, 2i + 1) turned by pos * theta^(-2i / rope) (HF's default
    `rope_interleave`, stated as the layout)
    o = softmax((q_nope k_nope + q_pe k_pe) / sqrt(nope + rope), causal) v
    h += o W_o^T
    y = rms(h) * mlp_norm
    dense layer (l < first_k_dense_replace): h += SwiGLU(y)
    MoE layer: s = sigmoid(y W_r^T) in f32; the top_k experts of s + bias;
    weights s_i / sum(s_chosen) * routed_scaling_factor;
    h += sum_i w_i SwiGLU_i(y) + SwiGLU_shared(y)
    logits = (rms(h) * final_norm) W_head^T

Weights: {"embed", "final_norm", "lm_head", "layers"} with each layer a dict
of f32 tensors: attn_norm, wq, wkv_a, kv_a_norm, wkv_b, wo, mlp_norm, and
gate / up / down ([M, D], [M, D], [D, M]) in a dense layer, or router
[E, D], router_bias [E], gate_exps / up_exps [E, M, D], down_exps
[E, D, M], gate_shexp / up_shexp [S*M, D], down_shexp [D, S*M] in a MoE
layer. `layers` may be any sequence, so a caller can build one layer at a
time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_pairs(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, ..., d]: pair (2i, 2i + 1) of row t turned by pos[t] *
    theta^(-2i / d), the angles in float64."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.double()[:, None] * inv[None]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
    cos, sin = ang.cos().float().reshape(shape), ang.sin().float().reshape(shape)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).reshape(x.shape)


def swiglu(y, gate, up, down):
    return (F.silu(y @ gate.t()) * (y @ up.t())) @ down.t()


def route(y: torch.Tensor, router, bias, top_k: int, scale: float, norm: bool = True):
    """(experts [T, top_k], weights [T, top_k]) of rows y [T, D]."""
    scores = torch.sigmoid(y.float() @ router.float().t())
    idx = torch.topk(scores + bias, top_k, dim=-1).indices
    w = scores.gather(-1, idx)
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def moe(lw: dict, t: dict, y: torch.Tensor) -> torch.Tensor:
    idx, w = route(y, lw["router"], lw["router_bias"], t["num_experts_per_tok"],
                   t["routed_scaling_factor"], t.get("norm_topk_prob", True))
    dense = torch.zeros(y.shape[0], lw["router"].shape[0], device=y.device).scatter(1, idx, w)
    out = swiglu(y, lw["gate_shexp"], lw["up_shexp"], lw["down_shexp"])
    for e in torch.unique(idx).tolist():
        rows = (dense[:, e] != 0).nonzero()[:, 0]
        out[rows] += dense[rows, e:e + 1] * swiglu(y[rows], lw["gate_exps"][e],
                                                    lw["up_exps"][e], lw["down_exps"][e])
    return out


def attention(lw: dict, t: dict, x: torch.Tensor) -> torch.Tensor:
    n, h = x.shape[0], t["num_heads"]
    nope, rope, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["kv_lora_rank"]
    pos = torch.arange(n, device=x.device)
    q = (x @ lw["wq"].t()).reshape(n, h, nope + rope)
    ckv = x @ lw["wkv_a"].t()
    c = rms(ckv[:, :r], lw["kv_a_norm"], t["rms_norm_eps"])
    k_pe = rope_pairs(ckv[:, r:], pos, t["rope_theta"])
    q_pe = rope_pairs(q[..., nope:], pos, t["rope_theta"])
    kv = (c @ lw["wkv_b"].t()).reshape(n, h, -1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    s = (torch.einsum("thd,shd->hts", q[..., :nope], k_nope)
         + torch.einsum("thd,sd->hts", q_pe, k_pe)) / math.sqrt(nope + rope)
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v).reshape(n, -1)
    return o @ lw["wo"].t()


@torch.no_grad()
def logits(p: dict, t: dict, emb: torch.Tensor) -> torch.Tensor:
    """Input embeddings [T, D] at positions 0..T-1 -> logits [T, V] (f32)."""
    eps = t["rms_norm_eps"]
    x = emb.float()
    for i in range(t["num_layers"]):
        lw = p["layers"][i]
        x = x + attention(lw, t, rms(x, lw["attn_norm"], eps))
        y = rms(x, lw["mlp_norm"], eps)
        if i < t["first_k_dense_replace"]:
            x = x + swiglu(y, lw["gate"], lw["up"], lw["down"])
        else:
            x = x + moe(lw, t, y)
    return rms(x, p["final_norm"], eps) @ p["lm_head"].t()
