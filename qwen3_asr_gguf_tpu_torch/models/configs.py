"""Model architecture configs.

Semantics follow the official Qwen3-ASR model family (reference:
qwen_asr/core/transformers_backend/configuration_qwen3_asr.py:83-277):
an audio tower (conv2d downsampler + pre-LN transformer encoder) feeding a
Qwen3 text decoder (RMSNorm, per-head q/k norm, GQA, SwiGLU,
rope_theta=5e6, interleaved mrope degenerate to 1-D RoPE for ASR).

Real checkpoints carry their own hyperparameters (config.json / GGUF
metadata); the presets here are for synthetic benchmarking at the published
parameter counts and for tiny test models.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class AudioEncoderConfig:
    """Audio tower (reference configuration_qwen3_asr.py:83-123)."""

    num_mel_bins: int = 128
    d_model: int = 1024
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    downsample_hidden_size: int = 480
    output_dim: int = 2048  # text decoder hidden size
    # mel frames per conv chunk (1 s). Equals the REFERENCE config's
    # 2*n_window: shipped checkpoints set n_window=50 and convolve
    # 2*n_window-frame chunks (modeling_qwen3_asr.py:682-694); the %100
    # length formula (:309-317) only works for 100-frame chunks.
    # convert_hf_checkpoint doubles the HF value on import.
    n_window: int = 100
    n_window_infer: int = 400  # attention window in mel frames (400 = 52 tokens)
    conv_chunksize: int = 500
    max_source_positions: int = 1500
    activation: str = "gelu"
    # "full" = product behavior (all-zeros additive mask per <=80 s chunk,
    #          reference encoder.py:192-206);
    # "windowed" = official block-diagonal cu_seqlens attention
    #          (reference modeling_qwen3_asr.py:719-726)
    attention_mode: str = "full"

    @property
    def conv_feat_dim(self) -> int:
        """Flattened conv output feature dim entering conv_out."""
        f = self.num_mel_bins
        for _ in range(3):
            f = (f + 1) // 2
        return f * self.downsample_hidden_size

    @property
    def tokens_per_window(self) -> int:
        """Encoder tokens produced per full n_window-frame chunk (13 for 100)."""
        t = self.n_window
        for _ in range(3):
            t = (t - 1) // 2 + 1
        return t


@dataclass(frozen=True)
class TextDecoderConfig:
    """Qwen3 text decoder (reference configuration_qwen3_asr.py:230-277)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 6144
    rms_norm_eps: float = 1e-6
    rope_theta: float = 5_000_000.0
    tie_word_embeddings: bool = False
    # ForcedAligner checkpoints replace lm_head with a classifier of
    # `classify_num` timestamp classes (reference modeling_qwen3_asr.py:1085-1088,
    # 80 ms steps, max 3750+ classes); None = regular LM head.
    classify_num: Optional[int] = None

    @property
    def n_rep(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def lm_head_dim(self) -> int:
        return self.classify_num if self.classify_num is not None else self.vocab_size


@dataclass(frozen=True)
class ThinkerConfig:
    """Full ASR model = audio tower + text decoder (reference :280-355)."""

    audio: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    text: TextDecoderConfig = field(default_factory=TextDecoderConfig)
    audio_token_id: int = 151646
    audio_start_token_id: int = 151647
    # special tokens used by the prompt protocol (reference asr.py:67-71)
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    asr_text_token_id: int = 151704
    audio_end_token_id: int = 151648
    eos_token_ids: tuple[int, ...] = (151645, 151643)
    timestamp_token_id: int = 151705  # aligner slot token
    timestamp_segment_ms: float = 80.0


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------

_TEXT_06B = TextDecoderConfig(
    hidden_size=1024, num_layers=28, num_heads=16, num_kv_heads=8,
    head_dim=128, intermediate_size=3072,
)
_TEXT_17B = TextDecoderConfig(
    hidden_size=2048, num_layers=28, num_heads=16, num_kv_heads=8,
    head_dim=128, intermediate_size=6144,
)
_AUDIO_06B = AudioEncoderConfig(d_model=896, encoder_layers=18, encoder_attention_heads=14,
                                encoder_ffn_dim=3584, output_dim=1024)
_AUDIO_17B = AudioEncoderConfig(d_model=1024, encoder_layers=24, encoder_attention_heads=16,
                                encoder_ffn_dim=4096, output_dim=2048)

PRESETS: dict[str, ThinkerConfig] = {
    "qwen3-asr-0.6b": ThinkerConfig(audio=_AUDIO_06B, text=_TEXT_06B),
    "qwen3-asr-1.7b": ThinkerConfig(audio=_AUDIO_17B, text=_TEXT_17B),
    "qwen3-forced-aligner-0.6b": ThinkerConfig(
        audio=_AUDIO_06B, text=replace(_TEXT_06B, classify_num=5000)
    ),
    # tiny configs for tests
    "tiny": ThinkerConfig(
        audio=AudioEncoderConfig(
            num_mel_bins=128, d_model=64, encoder_layers=2, encoder_attention_heads=4,
            encoder_ffn_dim=128, downsample_hidden_size=32, output_dim=48,
        ),
        text=TextDecoderConfig(
            vocab_size=512, hidden_size=48, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=96,
        ),
    ),
}


def preset(name: str) -> ThinkerConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
