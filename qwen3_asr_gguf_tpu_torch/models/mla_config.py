"""The DeepSeek-V3 decoder block (multi-head latent attention and sparse
experts) behind the Qwen3-ASR audio tower: its config and presets.

`models/configs.py` is a verbatim copy of the JAX package's, held to it by
a test, so this config lives here and importing this module adds its
presets to that module's `PRESETS` (as `configs.preset` reads them).

Layer equations (Moonlight-16B-A3B's config.json, `model_type`
deepseek_v3; transformers' `modeling_deepseek_v3.py`):

- attention: q = W_q x ([heads, nope + rope]); [c | k_pe] = W_kv_a x, c
  RMS-normed (`kv_a_layernorm`); [k_nope | v] = W_kv_b c per head; RoPE on
  the `qk_rope_head_dim` dims of q and of the one k_pe every head shares,
  adjacent pairs (2i, 2i + 1) rotated at theta^(-2i / rope_dim) (the
  `rope_interleave` layout); softmax scale (nope + rope)^-0.5;
- the first `first_k_dense_replace` layers' MLP is a SwiGLU of
  `intermediate_size`; every later layer routes: f32 logits of the router,
  sigmoid scores, the `num_experts_per_tok` experts of highest score plus
  `e_score_correction_bias` (one group), weighted by their unbiased scores
  renormalised (`norm_topk_prob`) times `routed_scaling_factor`, each a
  SwiGLU of `moe_intermediate_size`; plus `n_shared_experts` shared ones
  as one SwiGLU of n_shared * moe_intermediate_size, weight 1.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from . import configs
from .configs import ThinkerConfig


@dataclass(frozen=True)
class MLAMoEConfig:
    """A DeepSeek-V3 text decoder (Moonlight-16B-A3B's widths by default),
    its LM head untied, of `vocab_size` rows."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    q_lora_rank: int | None = None  # None: q_proj straight from the hidden state
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264  # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50_000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def lm_head_dim(self) -> int:
        return self.vocab_size

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


def is_mla(cfg) -> bool:
    return isinstance(cfg, MLAMoEConfig)


def refuse(cfg, what: str) -> None:
    """Raise for a path this decoder does not run (the batchers' rows
    steps, tensor parallelism)."""
    if is_mla(cfg):
        raise NotImplementedError(
            f"{what} does not run the latent-attention sparse-expert decoder "
            "(MLAMoEConfig): its rows paths and tensor parallelism are not ported")


MOONLIGHT_16B_A3B = MLAMoEConfig()

PRESETS: dict[str, ThinkerConfig] = {
    # Moonlight-16B-A3B's decoder at its published widths behind the 1.7B's tower
    "qwen3-asr-1.7b-moonlight-16b-a3b": ThinkerConfig(
        audio=configs.PRESETS["qwen3-asr-1.7b"].audio, text=MOONLIGHT_16B_A3B),
    # for tests: every mechanism, two MoE layers after one dense; the widths
    # that the int4 checkpoint stores as q4_k are whole 256-superblocks
    "tiny-mla-moe": ThinkerConfig(
        audio=replace(configs.PRESETS["tiny"].audio, output_dim=256),
        text=MLAMoEConfig(
            vocab_size=512, hidden_size=256, num_layers=3, num_heads=2, kv_lora_rank=64,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=128, intermediate_size=256,
            moe_intermediate_size=64, n_routed_experts=8, n_shared_experts=2,
            num_experts_per_tok=3, first_k_dense_replace=1, rope_theta=10_000.0),
    ),
}
for _name, _cfg in PRESETS.items():
    configs.PRESETS.setdefault(_name, _cfg)
