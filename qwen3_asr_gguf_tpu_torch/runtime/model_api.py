"""High-level batch API matching the official `Qwen3ASRModel` wrapper.

Reference: qwen_asr/inference/qwen3_asr.py:175-497 — `from_pretrained` /
`transcribe(audio=[...], context=..., language=..., return_time_stamps=...)`
over lists of heterogeneous inputs (paths, arrays, (array, sr) pairs,
base64), with >20-minute audio split at low-energy boundaries, per-chunk
language parsing/merging and repetition scrubbing.

The backend here is the TPU engine (and the batched generator for short
utterances) instead of HF Transformers / vLLM.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from ..audio.io import (
    MAX_ASR_INPUT_SECONDS,
    MIN_INPUT_SECONDS,
    load_audio,
)
from ..audio.split import split_audio_into_chunks
from ..schema import ASREngineConfig, AlignerConfig, ForcedAlignItem
from ..text.parsing import collapse_repetitions, merge_languages
from ..utils.languages import resolve_language

SAMPLE_RATE = 16_000

AudioInput = Union[str, np.ndarray, tuple]


@dataclasses.dataclass
class ASRResult:
    """Official-output shape (reference qwen3_asr.py transcribe returns)."""

    text: str
    language: str
    time_stamps: Optional[List[ForcedAlignItem]] = None


class Qwen3ASRModel:
    """`from_pretrained`-style wrapper over the TPU engine."""

    def __init__(self, engine):
        self.engine = engine

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        *,
        precision: str = "int8",
        n_ctx: int = 2048,
        chunk_size: float = 40.0,
        enable_aligner: bool = False,
        verbose: bool = False,
        **kwargs,
    ) -> "Qwen3ASRModel":
        cfg = ASREngineConfig(
            model_dir=model_dir,
            precision=precision,
            n_ctx=n_ctx,
            chunk_size=chunk_size,
            enable_aligner=enable_aligner,
            verbose=verbose,
            **kwargs,
        )
        if enable_aligner:
            cfg.align_config = AlignerConfig(model_dir=model_dir, precision=precision)
        from .engine import QwenASREngine

        return cls(QwenASREngine(cfg))

    # -- API ----------------------------------------------------------------

    def transcribe(
        self,
        audio: Union[AudioInput, Sequence[AudioInput]],
        context: str = "",
        language: Optional[str] = None,
        return_time_stamps: bool = False,
        temperature: float = 0.0,
        max_chunk_sec: float = MAX_ASR_INPUT_SECONDS,
    ) -> List[ASRResult]:
        """Batch transcription (reference qwen3_asr.py:299-446).

        Long inputs are split at low-energy boundaries; per-piece texts are
        concatenated and languages merged; repetition runs are scrubbed.
        """
        # a batch is a list; single inputs are str / ndarray / (array, sr)
        items = list(audio) if isinstance(audio, list) else [audio]
        language = resolve_language(language)

        results: List[ASRResult] = []
        for item in items:
            pcm = load_audio(item)
            if len(pcm) < MIN_INPUT_SECONDS * SAMPLE_RATE:
                results.append(ASRResult(text="", language=language or ""))
                continue
            pieces = split_audio_into_chunks(pcm, chunk_sec=max_chunk_sec)
            texts: List[str] = []
            langs: List[str] = []
            stamps: List[ForcedAlignItem] = []
            for piece, offset in pieces:
                res = self.engine.asr(
                    piece,
                    context=context,
                    language=language,
                    chunk_size_sec=self.engine.config.chunk_size,
                    memory_chunks=self.engine.config.memory_num,
                    temperature=temperature,
                    # official auto mode: no forced language -> the prompt
                    # omits <asr_text> and the engine parses the emitted
                    # `language X<asr_text>` protocol (qwen3_asr.py:454-465)
                    detect_language=language is None,
                )
                texts.append(collapse_repetitions(res.text))
                langs.extend((language or res.language or "").split(","))
                if return_time_stamps and res.alignment:
                    stamps.extend(
                        ForcedAlignItem(
                            text=it.text,
                            start_time=it.start_time + offset,
                            end_time=it.end_time + offset,
                        )
                        for it in res.alignment.items
                    )
            results.append(
                ASRResult(
                    text="".join(texts),
                    language=merge_languages(langs),
                    time_stamps=stamps if return_time_stamps else None,
                )
            )
        return results
