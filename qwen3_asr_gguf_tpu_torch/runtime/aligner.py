"""Forced aligner: non-autoregressive word-level timestamps (counterpart of
`qwen3_asr_gguf_tpu/runtime/aligner.py`), on one torch device.

Encode the audio, tokenize the text per language, build the slot-filled
sequence

    <|audio_start|> AUDIO_EMBD <|audio_end|> w1 <TS> <TS> w2 <TS> <TS> ...

run ONE prefill with logits only at the <TS> positions, argmax over the
timestamp classes (x 80 ms), repair monotonicity with LIS, and reconcile
punctuation back into the timeline.

The aligner only ever prefills, so on the card its quantized layer weights
are dequantized once at init to dense bf16 (`dequant_prefill_params`, the JAX
package's accelerator branch); on the CPU the containers are kept, which
reproduces the JAX package's CPU results. `dense_prefill` overrides the
choice. Not ported (ROADMAP.md, perf work): `pre_encode` and the speculative
align dispatch, which overlap work with a device-to-host round trip and give
exactly `align()`'s result.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

from ..models import params as P
from ..schema import AlignerConfig, ForcedAlignItem, ForcedAlignResult
from ..text import align_text
from ..utils.languages import normalize_language_name, validate_language
from .encoder_runner import EncoderRunner
from .generate import SparseLogitsRunner

TIMESTAMP_CLASSES = 4000  # argmax window (reference aligner.py:322)
STEP_MS = 80.0


def _serialized(fn):
    """Serialize public entry points: an engine and a batcher's align pool
    may call one shared aligner concurrently (the word-token memo and the
    Korean dictionary are built on first use)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mutex:
            return fn(self, *args, **kwargs)

    return wrapper


class QwenForcedAligner:
    def __init__(self, config: AlignerConfig, device="cuda", dense_prefill: bool | None = None):
        self._mutex = threading.RLock()
        self.config = config
        self.device = torch.device(device)
        model_dir = config.model_dir
        thinker = P.load_thinker_config(model_dir)
        self.thinker = thinker

        enc_path = os.path.join(model_dir, config.encoder_fn)
        mel_path = os.path.join(model_dir, "mel_filters.npy")
        if config.precision == "int8":
            enc_cfg, enc_params = P.load_encoder_quantized(enc_path, kind="int8", device=self.device)
        elif config.precision in ("q4_k", "int4"):
            enc_cfg, enc_params = P.load_encoder_quantized(enc_path, kind="int4", device=self.device)
        else:
            enc_cfg, enc_params = P.load_encoder_safetensors(enc_path, device=self.device)
        self.encoder = EncoderRunner(
            enc_params, enc_cfg,
            mel_filters=np.load(mel_path) if os.path.exists(mel_path) else None,
            device=self.device,
        )

        llm_path = os.path.join(model_dir, config.llm_fn)
        dec_cfg, dec_params, tokenizer = P.load_decoder_gguf(
            llm_path, precision=config.precision, device=self.device
        )
        self.dec_cfg = dec_cfg
        self.tokenizer = tokenizer
        dec_params = P.fuse_layer_weights(dec_params)
        if dense_prefill is None:
            dense_prefill = self.device.type == "cuda"
        if dense_prefill:
            dec_params = P.dequant_prefill_params(dec_params)
        self.runner = SparseLogitsRunner(dec_params, dec_cfg, n_ctx=config.n_ctx,
                                         device=self.device)

        self.ID_AUDIO_START = thinker.audio_start_token_id
        self.ID_AUDIO_END = thinker.audio_end_token_id
        self.ID_TIMESTAMP = thinker.timestamp_token_id
        self.STEP_MS = thinker.timestamp_segment_ms or STEP_MS
        self._ko_scores: dict | None = None  # built lazily on first Korean align
        self._word_tok: dict[str, list[int]] = {}  # word -> token ids memo

    def _korean_scores(self) -> dict:
        """L-dictionary for Korean segmentation. A reference-format dict
        file wins when available (config.ko_dict_path, or a
        korean_dict*.dict dropped into the model dir — byte-compatible with
        the reference's bundled soynlp asset, aligner.py:19-30, so users
        can carry theirs over); otherwise derived from the model's own BPE
        vocabulary (the tokenizer's Hangul merges are the equivalent
        high-frequency word list and travel with every model — but lack the
        single-syllable stems a curated dict has, see
        test_jako_segmentation)."""
        if self._ko_scores is None:
            candidates = [self.config.ko_dict_path] if self.config.ko_dict_path else []
            candidates += [
                os.path.join(self.config.model_dir, "korean_dict.dict"),
                os.path.join(self.config.model_dir, "korean_dict_jieba.dict"),
            ]
            for path in candidates:
                if path and os.path.exists(path):
                    scores: dict[str, float] = {}
                    with open(path, encoding="utf-8") as f:
                        for line in f:
                            line = line.strip()
                            if line:
                                scores[line.split()[0]] = 1.0
                    self._ko_scores = scores
                    return self._ko_scores
            words = []
            for tid in range(self.tokenizer.n_vocab):
                try:
                    words.append(self.tokenizer.token_to_bytes(tid).decode("utf-8").strip())
                except (UnicodeDecodeError, KeyError):
                    continue
            self._ko_scores = align_text.korean_scores_from_vocab(words)
        return self._ko_scores

    def _prompt(self, words: list[str], n_audio: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, audio_mask, ts_positions) of the slot-filled align prompt:
        <|audio_start|>, `n_audio` audio slots, <|audio_end|>, then each
        word's tokens followed by its start and end <timestamp> slots."""
        pre_ids = [self.ID_AUDIO_START]
        post_ids = [self.ID_AUDIO_END]
        ts_positions: list[int] = []
        prefix_len = len(pre_ids) + n_audio + len(post_ids)
        post_len = 0
        for word in words:
            # word -> token memo: CJK alignment tokenizes per CHARACTER, so
            # a transcript's word set is tiny and heavily repeated
            word_tokens = self._word_tok.get(word)
            if word_tokens is None:
                word_tokens = self.tokenizer.encode(word, allow_special=False)
                if len(self._word_tok) < 50_000:
                    self._word_tok[word] = word_tokens
            post_ids.extend(word_tokens)
            post_len += len(word_tokens)
            for _ in range(2):  # start & end slots
                ts_positions.append(prefix_len + post_len)
                post_ids.append(self.ID_TIMESTAMP)
                post_len += 1

        n_total = len(pre_ids) + n_audio + len(post_ids)
        ids = np.zeros(n_total, dtype=np.int32)
        ids[: len(pre_ids)] = pre_ids
        ids[len(pre_ids) + n_audio :] = post_ids
        audio_mask = np.zeros(n_total, dtype=bool)
        audio_mask[len(pre_ids) : len(pre_ids) + n_audio] = True
        return ids, audio_mask, np.asarray(ts_positions, dtype=np.int32)

    @_serialized
    def align(
        self,
        audio: np.ndarray,
        text: str,
        language: str = "Chinese",
        offset_sec: float = 0.0,
    ) -> ForcedAlignResult:
        if language:
            language = normalize_language_name(language)
            validate_language(language)
        t_start = time.time()

        # embeddings stay on the device; only their count is needed on the
        # host. The full bucket-shaped tensor is passed through (the audio
        # span mask picks the n_audio valid rows).
        t_enc0 = time.time()
        audio_embd = self.encoder.encode(audio)
        n_audio = self.encoder.valid_tokens(int(audio.shape[-1]))
        t_enc = time.time() - t_enc0  # enqueue time: the device runs on under the prompt build

        ko_scores = self._korean_scores() if (language or "").lower() == "korean" else None
        words = align_text.tokenize(text, language, ko_scores=ko_scores)
        if not words:
            return ForcedAlignResult(items=align_text.reconcile(text, []), performance={
                "encoder_time": t_enc, "decoder_time": 0.0, "total_time": time.time() - t_start,
            })

        ids, audio_mask, ts_positions = self._prompt(words, n_audio)

        t_dec0 = time.time()
        limit = min(TIMESTAMP_CLASSES, self.dec_cfg.lm_head_dim)
        raw_ts = self.runner.argmax_at(ids, audio_mask, audio_embd, ts_positions, limit)
        t_dec = time.time() - t_dec0

        fixed = align_text.fix_timestamps(raw_ts)
        ms = np.asarray(fixed, dtype=np.float64) * self.STEP_MS
        items = [
            ForcedAlignItem(
                text=w,
                start_time=float(ms[i * 2] / 1000.0 + offset_sec),
                end_time=float(ms[i * 2 + 1] / 1000.0 + offset_sec),
            )
            for i, w in enumerate(words)
        ]
        final_items = align_text.reconcile(text, items)
        return ForcedAlignResult(
            items=final_items,
            performance={
                "encoder_time": t_enc,
                "decoder_time": t_dec,
                "total_time": time.time() - t_start,
            },
        )
