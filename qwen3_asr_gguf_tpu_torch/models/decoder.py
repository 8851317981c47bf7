"""Qwen3 text decoder in PyTorch (counterpart of
`qwen3_asr_gguf_tpu/models/decoder.py`).

Pre-norm blocks of [RMSNorm -> GQA attention with per-head RMSNorm on q/k ->
residual] and [RMSNorm -> SwiGLU MLP -> residual], final RMSNorm, untied LM
head, rotate-half RoPE. Norms, softmax and RoPE compute in f32; matmul
activations keep the embedding dtype (bf16 for the quantized engines).

Parameters are a plain dict: {"embed": [V, D], "layers": [per-layer dict,
...], "final_norm": [D], "lm_head": weight}; a layer weight is a dense
[N, K] tensor or a quantized container (`ops.qtensor.matmul` dispatches).
The KV cache is {"k": [L x [S, Hkv, hd]], "v": [...]}, updated in place; an
int8 cache adds f32 per-(slot, head) scales {"k_s": [L x [S, Hkv]], "v_s"}.
The batched serving step (`forward_step_rows`) takes the same layout with a
leading row axis: [B, S, Hkv, hd] and [B, S, Hkv], and so does the
batchers' admission prefill (`forward_prefill_lanes`), which runs a cohort
of P prompts as one pass over P x T rows, its attention in lane groups.

Tensor parallelism (`tp_group`, a process group; None runs the whole
model): the weights are one rank's Megatron tiles (`parallel.sharding`), the
config is the local one (heads and kv heads over tp) and the KV cache holds
the local kv heads. Each layer then ends its o_proj and down_proj partial
products in one all-reduce each, the only collectives of a layer, as in the
JAX package's `tp_axis`; `lm_logits` gathers the vocab tiles. The
collectives are autograd-aware (`parallel.collectives`), so the same
forward trains under tensor parallelism.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..ops import attn as attn_ops
from ..ops import mlp as mlp_ops
from ..ops.qtensor import Int8Weight, matmul, matmul_normed
from ..parallel.collectives import copy_to_tp, gather_from_tp, reduce_from_tp
from .configs import TextDecoderConfig

Params = dict[str, Any]
MASKED = -1e30  # masked score: a fully masked row gives a uniform softmax, not NaN
# f32 attention scores of one lane group of a cohort prefill
# (`forward_prefill_lanes`): at the 1.7B widths 4 lanes at T = 2048, 28 at 768
PREFILL_SCORE_BYTES = 1 << 30


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [T] int -> (cos, sin) [T, head_dim] f32 (half-duplicated)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, hd]; cos/sin [T, hd]. HF rotate-half convention."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, None, :] + rotated * sin[:, None, :]
    return out.to(x.dtype)


def _gqa_attention(q, k, v, mask, scale):
    """q [..., T, Hq, d], k/v [..., S, Hkv, d], mask [..., T, S] bool ->
    [..., T, Hq, d]; the leading dims (the lanes of a cohort prefill) are
    the same in all four. Products of the operands' dtype, summed in f32."""
    *lead, t, hq, d = q.shape
    hkv = k.shape[-2]
    g = hq // hkv
    qg = q.reshape(*lead, t, hkv, g, d).movedim(-4, -2).float()  # [..., Hkv, G, T, d]
    kg = k.transpose(-3, -2).float()  # [..., Hkv, S, d]
    vg = v.transpose(-3, -2)
    scores = torch.matmul(qg, kg.unsqueeze(-3).transpose(-1, -2)) * scale  # [..., Hkv, G, T, S]
    scores = scores.masked_fill(~mask[..., None, None, :, :], MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(vg.dtype).float(), vg.unsqueeze(-3).float())  # [..., Hkv, G, T, d]
    return out.movedim(-2, -4).reshape(*lead, t, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# shapes and cache
# --------------------------------------------------------------------------


def init_shapes(cfg: TextDecoderConfig) -> dict:
    """Parameter shape tree with stacked layers (leading axis = layer), the
    layout of the JAX package's `init_params` and of checkpoint writing."""
    d, l = cfg.hidden_size, cfg.num_layers
    hq, hkv, hd, m = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (l, d),
            "q_proj": (l, hq * hd, d),
            "k_proj": (l, hkv * hd, d),
            "v_proj": (l, hkv * hd, d),
            "o_proj": (l, d, hq * hd),
            "q_norm": (l, hd),
            "k_norm": (l, hd),
            "mlp_norm": (l, d),
            "gate_proj": (l, m, d),
            "up_proj": (l, m, d),
            "down_proj": (l, d, m),
        },
        "final_norm": (d,),
        "lm_head": (cfg.lm_head_dim, d),
    }


def init_cache(cfg: TextDecoderConfig, max_len: int, dtype=torch.bfloat16,
               device="cpu", rows: int | None = None) -> dict[str, list]:
    """KV cache as per-layer tensors [max_len, H_kv, hd], or [rows, max_len,
    H_kv, hd] for the row-batched serving cache. `dtype=torch.int8` is the
    quantized cache: int8 values with one f32 scale per (slot, head)."""
    lead = () if rows is None else (rows,)
    shape = (*lead, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "k": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
    }
    if dtype == torch.int8:
        sshape = shape[:-1]
        cache["k_s"] = [torch.zeros(sshape, device=device) for _ in range(cfg.num_layers)]
        cache["v_s"] = [torch.zeros(sshape, device=device) for _ in range(cfg.num_layers)]
    return cache


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, hd] -> (int8 values, f32 scale [..., H]); divides by the
    scale and rounds half to even, as the JAX package does."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _dequant_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s[..., None]).to(dtype)


def _write_cache(cache: dict, l: int, index, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write layer l's new K/V at `index` (a slot slice, or (rows, slots)
    for the row-batched cache) in place, quantizing for an int8 cache."""
    if cache["k"][l].dtype == torch.int8:
        kq, ksc = _quant_kv(k)
        vq, vsc = _quant_kv(v)
        cache["k"][l][index], cache["k_s"][l][index] = kq, ksc
        cache["v"][l][index], cache["v_s"][l][index] = vq, vsc
    else:
        cache["k"][l][index] = k.to(cache["k"][l].dtype)
        cache["v"][l][index] = v.to(cache["v"][l].dtype)


def _write_cache_at(cache: dict, l: int, slot: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """Write layer l's one new K/V row (k/v [1, Hkv, hd]) at the slot held in
    the 1-element device tensor `slot`, in place: an index on the device, so
    the write needs no host value."""
    idx = slot.to(torch.int64)
    if cache["k"][l].dtype == torch.int8:
        kq, ksc = _quant_kv(k)
        vq, vsc = _quant_kv(v)
        cache["k"][l].index_copy_(0, idx, kq)
        cache["k_s"][l].index_copy_(0, idx, ksc)
        cache["v"][l].index_copy_(0, idx, vq)
        cache["v_s"][l].index_copy_(0, idx, vsc)
    else:
        cache["k"][l].index_copy_(0, idx, k.to(cache["k"][l].dtype))
        cache["v"][l].index_copy_(0, idx, v.to(cache["v"][l].dtype))


def _read_cache_window(cache: dict, l: int, win: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer l's first `win` cache slots as dense (k, v), dequantizing int8."""
    if cache["k"][l].dtype == torch.int8:
        return (_dequant_kv(cache["k"][l][:win], cache["k_s"][l][:win], dtype),
                _dequant_kv(cache["v"][l][:win], cache["v_s"][l][:win], dtype))
    return cache["k"][l][:win].to(dtype), cache["v"][l][:win].to(dtype)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _layer_qkv(layer: Params, cfg: TextDecoderConfig, x: torch.Tensor, cos, sin,
               pre_norm: tuple | None = None, tp_group=None):
    """pre_norm=(weight, eps): x is the raw residual stream and the rms_norm
    fuses into the qkv matvec kernel where supported (decode step)."""
    if pre_norm is not None and "qkv_proj" not in layer:
        x = rms_norm(x, *pre_norm)
        pre_norm = None
    x = copy_to_tp(x, tp_group)
    t = x.shape[0]
    hd = cfg.head_dim
    nq = cfg.num_heads * hd
    nkv = cfg.num_kv_heads * hd
    if "qkv_proj" in layer:
        if pre_norm is not None:
            qkv = matmul_normed(x, layer["qkv_proj"], *pre_norm)
        else:
            qkv = matmul(x, layer["qkv_proj"])
        q = qkv[:, :nq].reshape(t, cfg.num_heads, hd)
        k = qkv[:, nq: nq + nkv].reshape(t, cfg.num_kv_heads, hd)
        v = qkv[:, nq + nkv:].reshape(t, cfg.num_kv_heads, hd)
    else:
        q = matmul(x, layer["q_proj"]).reshape(t, cfg.num_heads, hd)
        k = matmul(x, layer["k_proj"]).reshape(t, cfg.num_kv_heads, hd)
        v = matmul(x, layer["v_proj"]).reshape(t, cfg.num_kv_heads, hd)
    q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _can_fuse_mlp(layer: Params, x: torch.Tensor) -> bool:
    """Whether the fused int8 MLP kernel applies: separate per-layer int8
    gate/up/down weights, a single token row, a tile-aligned intermediate
    dimension."""
    if x.ndim != 2 or x.shape[0] != 1:
        return False
    if not all(isinstance(layer.get(k), Int8Weight)
               for k in ("gate_proj", "up_proj", "down_proj")):
        return False
    m, d = layer["gate_proj"].q.shape
    return m % 512 == 0 and d % 128 == 0


def _mlp(layer: Params, x: torch.Tensor, pre_norm: tuple | None = None, *,
         fused_kernel: bool = False, tp_group=None) -> torch.Tensor:
    """`fused_kernel`: the whole MLP of one token through
    `ops.mlp.fused_mlp_matvec` (each int8 weight read once); the rms_norm is
    then applied first, not fused into a matvec. Only the single-stream
    decode step asks for it, on layers from `split_mlp_weights`; a layer it
    cannot take is an error, not a quiet unfused MLP. Under `tp_group` the
    down_proj partial product ends in the layer's second all-reduce."""
    if pre_norm is not None and ("gateup_proj" not in layer or fused_kernel):
        x = rms_norm(x, *pre_norm)
        pre_norm = None
    x = copy_to_tp(x, tp_group)
    if fused_kernel:
        if not _can_fuse_mlp(layer, x):
            raise ValueError("fused MLP asked for on a layer it cannot take (needs split int8 "
                             "gate/up/down weights, one row, M % 512 == 0, D % 128 == 0)")
        g, u, d = layer["gate_proj"], layer["up_proj"], layer["down_proj"]
        return mlp_ops.fused_mlp_matvec(x, g.q, g.scale, u.q, u.scale, d.q, d.scale)
    if "gateup_proj" in layer:
        m = layer["gateup_proj"].shape[0] // 2  # [2M, D] (dense or packed)
        if pre_norm is not None:
            gu = matmul_normed(x, layer["gateup_proj"], *pre_norm)
        else:
            gu = matmul(x, layer["gateup_proj"])
        gate, up = gu[:, :m], gu[:, m:]
    else:
        gate = matmul(x, layer["gate_proj"])
        up = matmul(x, layer["up_proj"])
    act = F.silu(gate.float()).to(x.dtype) * up
    return reduce_from_tp(matmul(act, layer["down_proj"]), tp_group)


def _block(layer: Params, cfg: TextDecoderConfig, h, cos, sin, attend, tp_group=None):
    """Prefill block body over the rows h [N, D]; `attend(q, k, v)` takes
    this layer's fresh q/k/v rows ([N, heads, hd]) to the attention output
    (N x Hq x hd values). Returns (h, k, v)."""
    n = h.shape[0]
    attn_in = rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps)
    q, k, v = _layer_qkv(layer, cfg, attn_in, cos, sin, tp_group=tp_group)
    attn = attend(q, k, v)
    h = h + reduce_from_tp(matmul(attn.reshape(n, -1), layer["o_proj"]), tp_group)
    mlp_in = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps)
    return h + _mlp(layer, mlp_in, tp_group=tp_group), k, v


def forward_prefill(params: Params, cfg: TextDecoderConfig, embd: torch.Tensor,
                    cache: dict | None, *, length: int | None = None, tp_group=None):
    """Causal prefill from position 0 -> (hidden [T, D], cache). `length`
    (<= T) masks padding keys; `cache=None` skips the KV writes (and keeps
    the forward free of in-place writes, for autograd)."""
    t = embd.shape[0]
    scale = cfg.head_dim ** -0.5
    positions = torch.arange(t, device=embd.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = positions[:, None] >= positions[None, :]
    if length is not None:
        mask = mask & (positions[None, :] < length)
    h = embd
    for l, layer in enumerate(params["layers"]):
        h, k, v = _block(layer, cfg, h, cos, sin,
                         lambda q, k, v: _gqa_attention(q, k, v, mask, scale), tp_group)
        if cache is not None:
            _write_cache(cache, l, slice(0, t), k, v)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


def lane_groups(p: int, heads: int, t: int) -> list[slice]:
    """The lanes of a P-lane prefill at T tokens in groups whose f32
    attention scores ([lanes, heads, T, T]) fit PREFILL_SCORE_BYTES, one
    lane at the least."""
    per = max(1, PREFILL_SCORE_BYTES // (heads * t * t * 4))
    return [slice(i, min(i + per, p)) for i in range(0, p, per)]


def forward_prefill_lanes(params: Params, cfg: TextDecoderConfig, embd: torch.Tensor,
                          cache: dict, lengths, *, tp_group=None):
    """Causal prefill of P lanes from position 0, the lanes form of
    `forward_prefill` (the JAX package vmaps that over a cohort): embd
    [P, T, D]; `lengths` [P] (an integer tensor on embd's device; <= T)
    masks each lane's padding keys; `cache` is a row cache of P rows
    ([P, S >= T, ...]), written at slots [0, T) with one write per layer and
    cache tensor. The projections, norms and MLP run over all P x T rows at
    once (two all-reduces per layer under `tp_group`); the attention runs in
    `lane_groups`. Returns (hidden [P, T, D], cache)."""
    p, t, d = embd.shape
    dev = embd.device
    scale = cfg.head_dim ** -0.5
    positions = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos.repeat(p, 1), sin.repeat(p, 1)  # every lane starts at position 0
    lengths = torch.as_tensor(lengths, device=dev)
    mask = ((positions[:, None] >= positions[None, :])[None]
            & (positions[None, None, :] < lengths[:, None, None]))  # [P, T, T]
    groups = lane_groups(p, cfg.num_heads, t)

    def lanes(x):
        return x.reshape(p, t, *x.shape[1:])

    def attend(q, k, v):
        q, k, v = lanes(q), lanes(k), lanes(v)
        outs = [_gqa_attention(q[g], k[g], v[g], mask[g], scale) for g in groups]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    h = embd.reshape(p * t, d)
    for l, layer in enumerate(params["layers"]):
        h, k, v = _block(layer, cfg, h, cos, sin, attend, tp_group)
        _write_cache(cache, l, (slice(None), slice(0, t)), lanes(k), lanes(v))
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps).reshape(p, t, d), cache


def forward_prefill_at(params: Params, cfg: TextDecoderConfig, embd: torch.Tensor,
                       cache: dict, start: int, *, prefix_window: int,
                       length: int | None = None, tp_group=None):
    """Causal prefill of a suffix on top of a cache prefix: positions
    [start, start+T) attend to cache slots [0, start) and causally to the
    suffix; slots [start, prefix_window) are masked."""
    t = embd.shape[0]
    dev = embd.device
    scale = cfg.head_dim ** -0.5
    rel = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(start + rel, cfg.head_dim, cfg.rope_theta)
    pcols = torch.arange(prefix_window, device=dev)
    prefix_mask = (pcols[None, :] < start).expand(t, prefix_window)
    causal = rel[:, None] >= rel[None, :]
    if length is not None:
        causal = causal & (rel[None, :] < length)
    mask = torch.cat([prefix_mask, causal], dim=1)  # [t, prefix_window + t]
    h = embd
    for l, layer in enumerate(params["layers"]):
        k_pre, v_pre = _read_cache_window(cache, l, prefix_window, embd.dtype)
        h, k, v = _block(
            layer, cfg, h, cos, sin,
            lambda q, k, v: _gqa_attention(q, torch.cat([k_pre.to(k.dtype), k]),
                                           torch.cat([v_pre.to(v.dtype), v]), mask, scale),
            tp_group,
        )
        _write_cache(cache, l, slice(start, start + t), k, v)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


def split_mlp_weights(layer_list: list[Params]) -> list[Params]:
    """Each layer's fused `gateup_proj` as separate gate/up weights again
    (views of the same storage), which is what the fused decode MLP kernel
    takes."""
    out = []
    for layer in layer_list:
        layer = dict(layer)
        gu = layer.pop("gateup_proj", None)
        if gu is None:
            out.append(layer)
            continue
        if isinstance(gu, Int8Weight):
            m = gu.q.shape[0] // 2
            layer["gate_proj"] = Int8Weight(q=gu.q[:m], scale=gu.scale[:m])
            layer["up_proj"] = Int8Weight(q=gu.q[m:], scale=gu.scale[m:])
        else:
            m = gu.shape[0] // 2
            layer["gate_proj"], layer["up_proj"] = gu[:m], gu[m:]
        out.append(layer)
    return out


def forward_step_layers(layer_list: list[Params], final_norm: torch.Tensor,
                        cfg: TextDecoderConfig, embd: torch.Tensor, cache: dict,
                        pos, *, attn_window: int | None = None,
                        fused_mlp: bool = False, tp_group=None):
    """One decode step for the token at `pos` (embd [D]): each layer writes
    its K/V at `pos` BEFORE attending to the first `attn_window` slots
    (slot <= pos). `pos` is a 1-element int32 tensor on the device (the
    Generator's block keeps it there: the rope, the cache write, the int8
    mask and kernel 4 all read it on the device, so the step needs no host
    value), or a host int, made such a tensor once here. A bf16 or f32 cache
    attends through `ops.attn.gqa_decode_attention` on the full cache: on the
    card it launches kernel 4 or raises (the window must be whole 256-slot
    tiles); on the CPU it runs its plain version. An int8 cache keeps the
    plain attention on a dequantized window. `fused_mlp`: every layer's MLP
    through the fused int8 kernel (see `_mlp`). `tp_group`: local tiles and
    cache, two all-reduces per layer (see the module docstring). Returns
    (hidden [D], cache)."""
    s_max = cache["k"][0].shape[0]
    win = s_max if attn_window is None else min(attn_window, s_max)
    dev = embd.device
    scale = cfg.head_dim ** -0.5
    pos_t = attn_ops.decode_pos(pos, dev)
    cos, sin = rope_cos_sin(pos_t, cfg.head_dim, cfg.rope_theta)
    int8_kv = cache["k"][0].dtype == torch.int8
    if int8_kv:
        valid = (torch.arange(win, device=dev) <= pos_t)[None, :]
    h = embd[None, :]
    eps = cfg.rms_norm_eps
    for l, layer in enumerate(layer_list):
        q, k, v = _layer_qkv(layer, cfg, h, cos, sin, pre_norm=(layer["attn_norm"], eps),
                             tp_group=tp_group)
        _write_cache_at(cache, l, pos_t, k, v)
        if int8_kv:
            k_win, v_win = _read_cache_window(cache, l, win, k.dtype)
            attn = _gqa_attention(q, k_win, v_win, valid, scale)
        else:
            attn = attn_ops.gqa_decode_attention(q, cache["k"][l], cache["v"][l], pos_t, scale,
                                                  win)
        h = h + reduce_from_tp(matmul(attn.reshape(1, -1), layer["o_proj"]), tp_group)
        h = h + _mlp(layer, h, pre_norm=(layer["mlp_norm"], eps), fused_kernel=fused_mlp,
                     tp_group=tp_group)
    return rms_norm(h, final_norm, eps)[0], cache


def _gqa_attention_rows(q, kw, vw, mask, scale):
    """Per-row decode attention: q [B, Hq, d], kw/vw [B, S, Hkv, d],
    mask [B, S] -> [B, Hq, d]. Products of the operands' dtype, summed in f32."""
    b, hq, d = q.shape
    hkv = kw.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kw.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(vw.dtype).float(), vw.float())
    return out.reshape(b, hq, d).to(q.dtype)


def _gqa_attention_rows_q8(q, kw, ks, vw, vs, mask, scale):
    """int8-KV twin of `_gqa_attention_rows`: kw/vw int8 [B, S, Hkv, d] with
    f32 per-(slot, head) scales ks/vs [B, S, Hkv] folded into the dots
    (score * ks, p * vs rounded to q's dtype before the PV dot). The plain
    version of `ops.attn.gqa_rows_q8_attention`."""
    b, hq, d = q.shape
    hkv = kw.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kw.to(q.dtype).float())
    scores = scores * (ks.permute(0, 2, 1)[:, :, None, :] * scale)
    scores = scores.masked_fill(~mask[:, None, None, :], MASKED)
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * vs.permute(0, 2, 1)[:, :, None, :]).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", pv.float(), vw.to(q.dtype).float())
    return out.reshape(b, hq, d).to(q.dtype)


def forward_step_rows(layer_list: list[Params], final_norm: torch.Tensor,
                      cfg: TextDecoderConfig, embd: torch.Tensor, caches: dict,
                      poss: torch.Tensor, *, attn_window: int | None = None,
                      tp_group=None):
    """Batched decode step, one token per row (embd [B, D], poss [B] int64
    on the device, each a valid slot): activations stay [B, K], so a
    quantized weight streams once per step for all rows (`ops.q4k.
    q4k_matmul_rows` at B % 8 == 0). Each layer writes its K/V at the rows'
    positions in place before attending to their first `attn_window` slots
    (slot <= pos). An int8 cache attends through `ops.attn.
    gqa_rows_q8_attention`: on the card it launches kernel 5 or raises (the
    window must pass `rows_q8_supported`); on the CPU it runs its plain
    version. `tp_group`: local tiles and caches split on the kv heads, two
    all-reduces per layer. Returns (hidden [B, D], caches)."""
    b = embd.shape[0]
    s_max = caches["k"][0].shape[1]
    win = s_max if attn_window is None else min(attn_window, s_max)
    scale = cfg.head_dim ** -0.5
    cos, sin = rope_cos_sin(poss, cfg.head_dim, cfg.rope_theta)  # [B, hd]
    rows = torch.arange(b, device=embd.device)
    mask = torch.arange(win, device=embd.device)[None, :] <= poss[:, None]
    int8_kv = caches["k"][0].dtype == torch.int8
    h = embd
    eps = cfg.rms_norm_eps
    for l, layer in enumerate(layer_list):
        q, k, v = _layer_qkv(layer, cfg, rms_norm(h, layer["attn_norm"], eps), cos, sin,
                             tp_group=tp_group)
        _write_cache(caches, l, (rows, poss), k, v)
        k_c, v_c = caches["k"][l], caches["v"][l]
        if int8_kv:
            attn = attn_ops.gqa_rows_q8_attention(
                q, k_c, caches["k_s"][l], v_c, caches["v_s"][l], poss, scale, win)
        else:
            attn = _gqa_attention_rows(q, k_c[:, :win], v_c[:, :win], mask, scale)
        h = h + reduce_from_tp(matmul(attn.reshape(b, -1), layer["o_proj"]), tp_group)
        h = h + _mlp(layer, rms_norm(h, layer["mlp_norm"], eps), tp_group=tp_group)
    return rms_norm(h, final_norm, eps), caches


def lm_logits(params: Params, hidden: torch.Tensor, n_out: int | None = None,
              tp_group=None) -> torch.Tensor:
    """hidden [..., D] -> f32 logits [..., V]; `n_out` slices away the
    padded head rows (their logits are exactly 0 and would win an argmax
    over all-negative rows). Under `tp_group` the head is this rank's vocab
    tile and the tiles' logits are gathered along the vocabulary."""
    out = matmul(copy_to_tp(hidden, tp_group), params["lm_head"]).float()
    out = gather_from_tp(out, tp_group, -1)
    if n_out is not None and out.shape[-1] != n_out:
        out = out[..., :n_out]
    return out


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][token_ids]


def splice_prompt(params: Params, ids: torch.Tensor, audio_mask: torch.Tensor,
                  audio_embd: torch.Tensor) -> torch.Tensor:
    """Text-token embeddings with the audio-embedding stream merged in at the
    audio slots (the official masked_scatter merge): ids and audio_mask [T]
    with audio_embd [Ta, D], or the lanes of a cohort, [P, T] with
    [P, Ta, D] (each lane's stream zero-padded to the longest)."""
    text_embd = embed_tokens(params, ids)
    apos = torch.clamp(torch.cumsum(audio_mask.to(torch.int64), dim=-1) - 1, 0,
                       audio_embd.shape[-2] - 1)
    if ids.ndim == 2:
        gathered = audio_embd[torch.arange(ids.shape[0], device=ids.device)[:, None], apos]
    else:
        gathered = audio_embd[apos]
    return torch.where(audio_mask[..., None], gathered.to(text_embd.dtype), text_embd)
