"""Public dataclasses / configs.

API-compatible with the reference product schema
(reference: qwen_asr_gguf/inference/schema.py:28-103), minus the
multiprocessing message protocol — on TPU the encode/decode/align stages are
asynchronous device computations inside one process, so there is no queue
protocol to mirror (reference schema.py:7-26 is intentionally dropped).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DecodeResult:
    """Normalized output of one LLM chunk decode (reference schema.py:28-38)."""

    text: str = ""
    new_text: str = ""
    stable_tokens: List[int] = field(default_factory=list)
    t_prefill: float = 0.0
    t_generate: float = 0.0
    n_prefill: int = 0
    n_generate: int = 0
    is_aborted: bool = False


@dataclass(frozen=True)
class ForcedAlignItem:
    """One aligned word/char (reference schema.py:40-45)."""

    text: str
    start_time: float  # seconds
    end_time: float  # seconds


@dataclass
class ForcedAlignResult:
    """Aligned item collection (reference schema.py:47-60)."""

    items: List[ForcedAlignItem]
    performance: Optional[dict] = None

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> ForcedAlignItem:
        return self.items[idx]


@dataclass
class AlignerConfig:
    """Forced-aligner engine configuration (reference schema.py:62-72).

    ``model_dir`` may contain either a native checkpoint directory produced by
    ``qwen3_asr_gguf_tpu.export`` or GGUF/safetensors files; filenames below
    are resolved relative to it.
    """

    model_dir: str
    # In the TPU build the encoder is one jitted program, not two ONNX
    # sessions; `encoder_fn` points at its weights. The GGUF decoder file name
    # matches the reference default so model dirs are drop-in compatible.
    encoder_fn: str = "qwen3_aligner_encoder.safetensors"
    llm_fn: str = "qwen3_aligner_llm.q4_k.gguf"
    n_ctx: int = 2048
    # decoder compute precision: "int8" (MXU prefill path — right for the
    # aligner's NAR single-prefill workload) | "int4" | "q4_k" | "bf16" | "f32"
    precision: str = "int8"
    use_dml: bool = False  # accepted & ignored (reference API compatibility)
    # Korean L-dictionary for soynlp-style segmentation. Resolution order:
    # this path if set -> "korean_dict.dict" / the reference's
    # "korean_dict_jieba.dict" inside model_dir -> derived from the model
    # vocabulary (korean_scores_from_vocab). File format = the reference's
    # bundled asset: one "word freq tag" line per entry (aligner.py:19-30).
    ko_dict_path: Optional[str] = None


@dataclass
class ASREngineConfig:
    """ASR engine configuration (reference schema.py:74-96)."""

    model_dir: str
    encoder_fn: str = "qwen3_asr_encoder.safetensors"
    llm_fn: str = "qwen3_asr_llm.q4_k.gguf"
    n_ctx: int = 2048  # ~20 tokens per second of audio+text
    chunk_size: float = 40.0  # seconds per chunk -> 520 audio tokens
    memory_num: int = 1  # carried (audio embd, text) chunks
    verbose: bool = True
    enable_aligner: bool = False
    align_config: Optional[AlignerConfig] = None
    # "int4": decode streams 4-bit q4_k weights through the MXU matvec
    # kernel (fastest, ops/pallas_q4k.py); "int8": per-channel MXU path
    precision: str = "int4"
    use_dml: bool = False  # accepted & ignored (reference API compatibility)
    # TPU-specific knobs
    max_new_tokens: int = 512
    decode_block: int = 64  # device-resident tokens per host round-trip
    mesh_shape: Optional[dict] = None  # e.g. {"data": 1, "model": 4}
    # keep the constant prompt prefix's KV in the cache across chunks
    # instead of re-prefilling it. EXACT at every chunk: chunk 1 reuses
    # [header | chunk-0 audio] (identical context), chunks >= 2 reuse the
    # header only and re-prefill the memory audio at its new positions —
    # transcripts are bit-identical to kv_prefix_reuse=False (reference
    # recompute semantics, asr.py:269-393), just with fewer prefill tokens
    kv_prefix_reuse: bool = True
    # device-side chunk chaining: chunk i+1's prompt tail assembles on
    # device from chunk i's emitted tokens, overlapping the per-chunk
    # device->host fetch with compute (active when
    # max_new_tokens == decode_block)
    pipelined_dispatch: bool = True
    # "bf16" (exact), "int8" (per-slot-per-head scales: half the attention
    # HBM traffic and cache memory; llama.cpp's q8_0 KV analogue), "f32"
    kv_cache_dtype: str = "bf16"

    def __post_init__(self) -> None:
        if self.align_config is None:
            self.align_config = AlignerConfig(
                model_dir=self.model_dir,
                precision=self.precision,
            )


@dataclass
class TranscribeResult:
    """Transcription result (reference schema.py:98-103)."""

    text: str
    alignment: Optional[ForcedAlignResult] = None
    performance: Optional[dict] = None
    # forced language, or the merged auto-detected language(s) when the
    # engine ran with detect_language=True (official parse_asr_output /
    # merge_languages protocol); "" when unknown
    language: str = ""
