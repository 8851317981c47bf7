"""The DeepSeek-V3 text decoder (multi-head latent attention, sparse experts;
`models/mla_config.py`) on the port's path: the same entry points as
`models/decoder.py` (`init_cache`, `forward_prefill`, `forward_prefill_at`,
`forward_step_layers`), which the Generator calls for an `MLAMoEConfig`.

Parameters: `decoder.py`'s dict ({"embed", "layers", "final_norm",
"lm_head"}) with per-layer dicts of
    attn_norm, kv_a_norm, mlp_norm    f32 norms
    wq    [H * (nope + rope), D]      decode: `Q4KWeight` (kernel 1)
    wkv_a [R + rope, D]               decode: `Q4Weight` (kernel 6; R + rope = 576
                                      is no whole 512-row tile of kernel 1)
    wkv_b [H * (nope + v), R]         f32, dense (the decode step absorbs it)
    wo    [D, H * v]                  decode: `Q4KWeight`
and in a dense layer `decoder.py`'s MLP (gateup_proj / down_proj), in a MoE
layer `router` (f32 [E, D]), `router_bias` (f32 [E]) and `experts`
(`ops.moe.ExpertWeights` for decode, `DenseExperts` in the prefill copy).

The cache is latent: {"kv": [L x [S, R]], "pe": [L x [S, rope]]}: per slot
the normed latent c and the roped k_pe (bf16 or f32), in place of k and v.

- Prefill runs MLA uncompressed: W_kv_b expands the latents (the reused
  prefix's from the cache, the prompt's fresh) to per-head k_nope and v, and
  the attention is causal at qk dim nope + rope and v dim v, in f32.
- The decode step absorbs W_kv_b: q_nope W_UK gives each head's query in
  the latent space, the scores are latent . q_lat + k_pe . q_pe over the
  window's slots <= pos (read on the device), the output latent goes
  through W_UV and then W_o. Plain torch in f32 on the bf16 cache, inside
  the captured step.
- A MoE layer routes in f32 (`ops.moe.route`); decode runs the chosen
  experts and the shared SwiGLU (as `n_shared` experts of weight 1) through
  kernel 8 with the ids on the device; prefill through `ops.moe.
  grouped_experts`, one `moe.prefill` device span per layer, and each
  layer's per-expert row counts appended to `hists` (device tensors) where
  a list is given.
"""

from __future__ import annotations

import torch

from ..ops import attn as attn_ops
from ..ops import moe, qmm
from ..ops.qtensor import Q4Weight, dense_matmul, matmul
from ..utils import profiling
from . import decoder as dec
from .mla_config import MLAMoEConfig

MASKED = dec.MASKED


def init_cache(cfg: MLAMoEConfig, max_len: int, dtype=torch.bfloat16, device="cpu",
               rows: int | None = None) -> dict[str, list]:
    """The latent cache: per layer [max_len, R] latents and [max_len, rope]
    roped k_pe."""
    if rows is not None:
        raise NotImplementedError("the latent cache has no row-batched form")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"latent cache dtype {dtype} (bf16 or f32)")
    n = cfg.num_layers
    return {
        "kv": [torch.zeros(max_len, cfg.kv_lora_rank, dtype=dtype, device=device)
               for _ in range(n)],
        "pe": [torch.zeros(max_len, cfg.qk_rope_head_dim, dtype=dtype, device=device)
               for _ in range(n)],
    }


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions [T] -> (cos, sin) [T, dim // 2] f32: pair i turns at
    theta^(-2i / dim)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = positions.float()[:, None] * (1.0 / (theta ** exps))[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, ..., dim] with adjacent pairs (2i, 2i + 1) rotated by the row's
    angle i; cos / sin [T, dim // 2]. Computed in f32, returned in x's dtype."""
    shape = x.shape
    xf = x.float().reshape(shape[0], -1, shape[-1] // 2, 2)
    c, s = cos[:, None, :], sin[:, None, :]
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.reshape(shape).to(x.dtype)


def _latent_qkv(layer, cfg: MLAMoEConfig, x: torch.Tensor, cos, sin):
    """x [T, D] (normed) -> q_nope [T, H, nope], roped q_pe [T, H, rope],
    the normed latent c [T, R] and the roped k_pe [T, rope], in x's dtype."""
    t = x.shape[0]
    q = matmul(x, layer["wq"]).reshape(t, cfg.num_heads, cfg.qk_head_dim)
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_pe = apply_rope(q[..., cfg.qk_nope_head_dim:], cos, sin)
    w = layer["wkv_a"]
    # the decode weight goes through kernel 6, never a dense fallback
    ckv = qmm.q4_matmul(x, w) if isinstance(w, Q4Weight) else matmul(x, w)
    c = dec.rms_norm(ckv[:, : cfg.kv_lora_rank], layer["kv_a_norm"], cfg.rms_norm_eps)
    k_pe = apply_rope(ckv[:, cfg.kv_lora_rank:], cos, sin)
    return q_nope, q_pe, c, k_pe


def _attention(layer, cfg: MLAMoEConfig, q_nope, q_pe, c, k_pe, mask) -> torch.Tensor:
    """Uncompressed MLA over the slots of c [S, R] and k_pe [S, rope]:
    q [T, H, *], mask [T, S] -> [T, H * v] in q's dtype, in f32."""
    s_len, h = c.shape[0], cfg.num_heads
    kv = dense_matmul(c.float(), layer["wkv_b"]).reshape(s_len, h, -1)
    k_nope, v = kv[..., : cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]
    scores = (torch.einsum("thd,shd->hts", q_nope.float(), k_nope)
              + torch.einsum("thd,sd->hts", q_pe.float(), k_pe.float()))
    scores = (scores * cfg.qk_head_dim ** -0.5).masked_fill(~mask[None], MASKED)
    out = torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v)
    return out.reshape(q_nope.shape[0], -1).to(q_nope.dtype)


def _moe_prefill(layer, cfg: MLAMoEConfig, y: torch.Tensor, hists, valid) -> torch.Tensor:
    idx, w = moe.route(y, layer["router"], layer["router_bias"], cfg.num_experts_per_tok,
                       cfg.routed_scaling_factor, cfg.norm_topk_prob)
    ids, wts = moe.with_shared(idx, w, cfg.n_routed_experts, cfg.n_shared_experts)
    experts = layer["experts"]
    if not isinstance(experts, moe.DenseExperts):
        raise TypeError("the MoE prefill takes the experts' dense copy "
                        "(models.params.dequant_prefill_params), not "
                        f"{type(experts).__name__}")
    with profiling.span("moe.prefill", device=y.device):
        return moe.grouped_experts(y, experts, ids, wts, hists, cfg.n_routed_experts, valid)


def _ffn_prefill(layer, cfg: MLAMoEConfig, l: int, h: torch.Tensor, hists, valid=None
                 ) -> torch.Tensor:
    y = dec.rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps)
    if not cfg.is_moe(l):
        return dec._mlp(layer, y)
    return _moe_prefill(layer, cfg, y, hists, valid)


def _prefill(params, cfg: MLAMoEConfig, embd, cache, start: int, prefix_window: int,
             mask, hists, length=None):
    t = embd.shape[0]
    # the prompt's rows (not its padding), for the routing counts
    valid = None if length is None else torch.arange(t, device=embd.device) < length
    cos, sin = rope_cos_sin(start + torch.arange(t, device=embd.device), cfg.qk_rope_head_dim,
                            cfg.rope_theta)
    h = embd
    for l, layer in enumerate(params["layers"]):
        x = dec.rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, c, k_pe = _latent_qkv(layer, cfg, x, cos, sin)
        if prefix_window:
            c_all = torch.cat([cache["kv"][l][:prefix_window].to(c.dtype), c])
            pe_all = torch.cat([cache["pe"][l][:prefix_window].to(k_pe.dtype), k_pe])
        else:
            c_all, pe_all = c, k_pe
        attn = _attention(layer, cfg, q_nope, q_pe, c_all, pe_all, mask)
        h = h + matmul(attn, layer["wo"])
        if cache is not None:
            cache["kv"][l][start:start + t] = c.to(cache["kv"][l].dtype)
            cache["pe"][l][start:start + t] = k_pe.to(cache["pe"][l].dtype)
        h = h + _ffn_prefill(layer, cfg, l, h, hists, valid)
    return dec.rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


def forward_prefill(params, cfg: MLAMoEConfig, embd: torch.Tensor, cache: dict | None, *,
                    length: int | None = None, tp_group=None, hists: list | None = None):
    """Causal prefill from position 0 -> (hidden [T, D], cache); `length`
    masks padding keys, `cache=None` writes nothing."""
    if tp_group is not None:
        raise NotImplementedError("the latent-attention decoder runs on one device")
    pos = torch.arange(embd.shape[0], device=embd.device)
    mask = pos[:, None] >= pos[None, :]
    if length is not None:
        mask = mask & (pos[None, :] < length)
    return _prefill(params, cfg, embd, cache, 0, 0, mask, hists, length)


def forward_prefill_at(params, cfg: MLAMoEConfig, embd: torch.Tensor, cache: dict, start: int,
                       *, prefix_window: int, length=None, tp_group=None,
                       hists: list | None = None):
    """Prefill of a suffix at positions [start, start + T) on top of the
    cache's slots [0, start) (read from the first `prefix_window` slots, the
    rest masked), written at [start, start + T)."""
    if tp_group is not None:
        raise NotImplementedError("the latent-attention decoder runs on one device")
    t = embd.shape[0]
    rel = torch.arange(t, device=embd.device)
    pcols = torch.arange(prefix_window, device=embd.device)
    causal = rel[:, None] >= rel[None, :]
    if length is not None:
        causal = causal & (rel[None, :] < length)
    mask = torch.cat([(pcols[None, :] < start).expand(t, prefix_window), causal], dim=1)
    return _prefill(params, cfg, embd, cache, start, prefix_window, mask, hists, length)


def _absorbed_attention(layer, cfg: MLAMoEConfig, q_nope, q_pe, c_win, pe_win, valid
                        ) -> torch.Tensor:
    """One token's attention over the latent window: q_nope [H, nope], q_pe
    [H, rope], c_win [W, R], pe_win [W, rope], valid [W] -> [1, H * v] f32."""
    h, nope = cfg.num_heads, cfg.qk_nope_head_dim
    wkv_b = layer["wkv_b"].reshape(h, nope + cfg.v_head_dim, cfg.kv_lora_rank)
    q_lat = torch.einsum("hn,hnr->hr", q_nope.float(), wkv_b[:, :nope])
    c = c_win.float()
    scores = q_lat @ c.t() + q_pe.float() @ pe_win.float().t()
    scores = (scores * cfg.qk_head_dim ** -0.5).masked_fill(~valid[None], MASKED)
    o_lat = torch.softmax(scores, dim=-1) @ c
    return torch.einsum("hvr,hr->hv", wkv_b[:, nope:], o_lat).reshape(1, -1)


def forward_step_layers(layer_list: list, final_norm: torch.Tensor, cfg: MLAMoEConfig,
                        embd: torch.Tensor, cache: dict, pos, *,
                        attn_window: int | None = None, fused_mlp: bool = False,
                        tp_group=None):
    """One decode step for the token at `pos` (a 1-element int32 device
    tensor, or a host int): each layer writes its latent and k_pe at `pos`
    and then attends to the first `attn_window` slots (slot <= pos). No host
    value of the step, the routing included. Returns (hidden [D], cache)."""
    if tp_group is not None or fused_mlp:
        raise NotImplementedError("the latent-attention decoder has no fused int8 MLP "
                                  "and runs on one device")
    s_max = cache["kv"][0].shape[0]
    win = s_max if attn_window is None else min(attn_window, s_max)
    dev = embd.device
    pos_t = attn_ops.decode_pos(pos, dev)
    idx = pos_t.to(torch.int64)
    cos, sin = rope_cos_sin(pos_t, cfg.qk_rope_head_dim, cfg.rope_theta)
    valid = torch.arange(win, device=dev) <= pos_t
    eps = cfg.rms_norm_eps
    h = embd[None, :]
    for l, layer in enumerate(layer_list):
        x = dec.rms_norm(h, layer["attn_norm"], eps)
        q_nope, q_pe, c, k_pe = _latent_qkv(layer, cfg, x, cos, sin)
        cache["kv"][l].index_copy_(0, idx, c.to(cache["kv"][l].dtype))
        cache["pe"][l].index_copy_(0, idx, k_pe.to(cache["pe"][l].dtype))
        attn = _absorbed_attention(layer, cfg, q_nope[0], q_pe[0], cache["kv"][l][:win],
                                   cache["pe"][l][:win], valid)
        h = h + matmul(attn.to(h.dtype), layer["wo"])
        if not cfg.is_moe(l):
            h = h + dec._mlp(layer, h, pre_norm=(layer["mlp_norm"], eps))
            continue
        y = dec.rms_norm(h, layer["mlp_norm"], eps)
        ids, w = moe.route(y, layer["router"], layer["router_bias"], cfg.num_experts_per_tok,
                           cfg.routed_scaling_factor, cfg.norm_topk_prob)
        ids, w = moe.with_shared(ids, w, cfg.n_routed_experts, cfg.n_shared_experts)
        h = h + moe.expert_matvec(y, layer["experts"], ids.to(torch.int32), w)
    return dec.rms_norm(h, final_norm, eps)[0], cache
