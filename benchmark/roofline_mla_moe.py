"""The least time of a DeepSeek-V3 decoder's work (latent attention, sparse
experts), in `roofline.Work` pieces: the counterpart of `roofline.py`'s
dense Qwen3 pieces, from the decoder's fields as the port's `MLAMoEConfig`
names them (`architectures/mla_moe.text_config`).

Per token, a MoE layer runs `num_experts_per_tok` routed experts and the
shared SwiGLU (`n_shared_experts` experts' width), each 3 x M x D weights.
Weights are counted at the int4 byte budget (144 bytes per 256, q4_k and
q4_0 alike), the router at f32, the latent cache (c and k_pe) at bf16.

- `decode_step(t, ctx)`: one token at context `ctx`: the attention weights,
  the dense layers' MLP, the chosen experts' and the shared expert's
  weights, the routers, the head, each once; the latent cache read once;
  the absorbed attention's products;
- `expert_step(t)`: of that, the experts' part alone (kernel 8's work);
- `prefill(t, new, start)`: `new` prompt tokens after `start` cached ones:
  every weight once (every expert is chosen at a few hundred rows), the
  tokens' products through their chosen experts, the latents expanded by
  W_kv_b at every slot, the uncompressed attention, the head at the last
  token.
"""

from __future__ import annotations

from benchmark.roofline import ACT_BYTES, Q4K_BYTES_PER_WEIGHT, Work

F32 = 4


def attention_params(t: dict) -> int:
    """One layer's attention weights (q, kv_a, kv_b, o)."""
    d, h, r = t["hidden_size"], t["num_heads"], t["kv_lora_rank"]
    nope, rope, v = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d


def expert_params(t: dict) -> int:
    """One expert of the routed width: gate, up and down."""
    return 3 * t["hidden_size"] * t["moe_intermediate_size"]


def counts(t: dict) -> dict:
    """Layers by kind and the weights a token reads per kind."""
    dense = t["first_k_dense_replace"]
    moe = t["num_layers"] - dense
    slots = t["num_experts_per_tok"] + t["n_shared_experts"]
    return {"dense": dense, "moe": moe, "slots": slots,
            "attention": t["num_layers"] * attention_params(t),
            "dense_mlp": dense * 3 * t["hidden_size"] * t["intermediate_size"],
            "active_experts": moe * slots * expert_params(t),
            "all_experts": moe * (t["n_routed_experts"] + t["n_shared_experts"])
            * expert_params(t),
            "router": moe * t["n_routed_experts"] * t["hidden_size"],
            "head": t["vocab_size"] * t["hidden_size"]}


def _latent_bytes(t: dict, ctx: float) -> float:
    return ctx * (t["kv_lora_rank"] + t["qk_rope_head_dim"]) * ACT_BYTES * t["num_layers"]


def _act_bytes_per_token(t: dict) -> float:
    """Activations in and out of each product (bf16), the logits (f32)."""
    d, h, r = t["hidden_size"], t["num_heads"], t["kv_lora_rank"]
    q = h * (t["qk_nope_head_dim"] + t["qk_rope_head_dim"])
    c = counts(t)
    attn = d + q + d + (r + t["qk_rope_head_dim"]) + h * t["v_head_dim"] + d
    mlp_dense = d + 3 * t["intermediate_size"] + d
    mlp_moe = d + c["slots"] * 3 * t["moe_intermediate_size"] + d
    return (ACT_BYTES * (t["num_layers"] * attn + c["dense"] * mlp_dense + c["moe"] * mlp_moe)
            + F32 * t["vocab_size"])


def expert_step(t: dict) -> Work:
    """The chosen experts of one token (routed and shared), every MoE layer."""
    c = counts(t)
    act = c["moe"] * c["slots"] * (2 * t["hidden_size"] + 3 * t["moe_intermediate_size"])
    return Work(2.0 * c["active_experts"],
                c["active_experts"] * Q4K_BYTES_PER_WEIGHT + ACT_BYTES * act)


def _absorbed_flops(t: dict, ctx: float) -> float:
    h, r, rope = t["num_heads"], t["kv_lora_rank"], t["qk_rope_head_dim"]
    per_slot = 2.0 * h * (r + rope) + 2.0 * h * r  # scores, then the output latent
    absorb = 2.0 * h * r * (t["qk_nope_head_dim"] + t["v_head_dim"])  # W_UK, then W_UV
    return t["num_layers"] * (per_slot * ctx + absorb)


def decode_step(t: dict, ctx: float) -> Work:
    c = counts(t)
    weights = c["attention"] + c["dense_mlp"] + c["active_experts"] + c["head"]
    flops = 2.0 * (weights + c["router"]) + _absorbed_flops(t, ctx)
    nbytes = (weights * Q4K_BYTES_PER_WEIGHT + F32 * c["router"] + _latent_bytes(t, ctx)
              + _act_bytes_per_token(t))
    return Work(flops, nbytes)


def prefill(t: dict, new: int, start: int = 0) -> Work:
    """`new` tokens after `start` cached ones; the head at the last token."""
    c = counts(t)
    h = t["num_heads"]
    per_token = c["attention"] + c["dense_mlp"] + c["active_experts"] + c["router"]
    ctx = start + new
    expand = 2.0 * ctx * t["kv_lora_rank"] * h * (t["qk_nope_head_dim"] + t["v_head_dim"])
    mean_ctx = start + (new + 1) / 2
    attn = 2.0 * new * mean_ctx * h * (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
                                       + t["v_head_dim"])
    flops = 2.0 * per_token * new + 2.0 * c["head"] + t["num_layers"] * (expand + attn)
    weights = c["attention"] + c["dense_mlp"] + c["all_experts"] + c["head"]
    nbytes = (weights * Q4K_BYTES_PER_WEIGHT + F32 * c["router"] + _latent_bytes(t, ctx)
              + new * (_act_bytes_per_token(t) - F32 * t["vocab_size"]) + F32 * t["vocab_size"])
    return Work(flops, nbytes)
