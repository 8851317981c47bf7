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
choice.

For the engine's align worker: `pre_encode` queues the encoder for a window
whose audio is known before its text, and `align(precomputed_key=...)`
takes that encode. `spec_align_start` queues the whole alignment of a decode
block that the host has not read yet, its prompt built on the device from
the block's emitted tokens through the word-class table
(`build_word_cls_table`, cached beside the model as
`align_word_cls_v1_{n_vocab}.npy`); `spec_align_collect` takes it only when
it is exactly `align()`'s prompt, and otherwise returns None for the caller
to run `align()`.

Spans (`utils.profiling`): `align.encode` (a device span) around each
encode, `align.decode` around each readout. A result's `performance`:
`encoder_time` the encode's stream seconds (its CUDA events), `decoder_time`
the readout's host time (its wait for the card included), `total_time` the
host's time from `align()`'s start, or from `spec_align_start`'s end, to
the result.
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
from ..utils import profiling
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
        self._pre: tuple | None = None  # (key, embd, n_audio, `align.encode` span) of a pre-encoded window
        # the speculative align: the word-class table (host and device) and
        # the dispatched alignment in flight
        self._word_cls: np.ndarray | None = None
        self._word_cls_dev: torch.Tensor | None = None
        self._spec: dict | None = None
        self._word_cls_path = os.path.join(
            model_dir, f"align_word_cls_v1_{self.tokenizer.n_vocab}.npy")
        if os.path.exists(self._word_cls_path):
            try:
                tab = np.load(self._word_cls_path)
                if tab.shape == (self.tokenizer.n_vocab,):
                    self._word_cls = tab.astype(np.int8)
            except (OSError, ValueError):
                pass

    def build_word_cls_table(self) -> np.ndarray:
        """Per-vocab-token word class for the speculative align prompt (JAX
        aligner.py:114-150):

          2  the token decodes to exactly one CJK character c and encode(c)
             round-trips to [token]: `align()` would give it the same
             `c TS TS` triplet (CJK text splits per character);
          1  droppable: the general tokenizer finds no word in it (pure
             punctuation or whitespace);
          0  anything else: only the host path aligns it.

        A token stream of classes 1 and 2 only concatenates to a text whose
        words are exactly its class-2 characters, so the device prompt is
        then `align()`'s prompt. Saved beside the model (best effort)."""
        n = self.tokenizer.n_vocab
        tab = np.zeros(n, dtype=np.int8)
        for tid in range(n):
            try:
                s = self.tokenizer.token_to_bytes(tid).decode("utf-8")
            except (UnicodeDecodeError, KeyError):
                continue
            if not align_text.tokenize_general(s):
                tab[tid] = 1
            elif (len(s) == 1 and align_text.is_cjk_char(s)
                  and self.tokenizer.encode(s, allow_special=False) == [tid]):
                tab[tid] = 2
        self._word_cls = tab
        try:
            np.save(self._word_cls_path, tab)
        except OSError:
            pass
        return tab

    @_serialized
    def pre_encode(self, audio, key) -> None:
        """Queue the encoder for an upcoming align window ahead of its text;
        `align(precomputed_key=key)` or `spec_align_start(key=key)` takes it."""
        with profiling.span("align.encode", device=self.device) as enc:
            embd = self.encoder.encode(audio)
        self._pre = (key, embd, self.encoder.valid_tokens(int(audio.shape[-1])), enc)

    @_serialized
    def spec_align_start(self, toks_dev: torch.Tensor, key, language: str,
                         drop_last: int = 0) -> None:
        """Queue the speculative alignment of a decode block still in flight:
        `toks_dev` is the block's emitted buffer on the device, and the
        window must have been `pre_encode`d under `key`. It is queued behind
        the block on the device's stream; `spec_align_collect` takes it."""
        self._spec = None
        lang = (language or "").lower()
        if lang in ("japanese", "korean"):  # tokenizers other than the general one
            return
        if self._word_cls is None or self._pre is None or self._pre[0] != key:
            return
        if self._word_cls_dev is None:
            self._word_cls_dev = torch.from_numpy(self._word_cls).to(self.device)
        _, audio_embd, n_audio, _ = self._pre  # kept: align() may still need it
        limit = min(TIMESTAMP_CLASSES, self.dec_cfg.lm_head_dim)
        out = self.runner.argmax_at_spec(
            toks_dev, self._word_cls_dev, audio_embd, n_audio, limit,
            (self.ID_AUDIO_START, self.ID_AUDIO_END, self.ID_TIMESTAMP), drop_last=drop_last)
        if out is not None:
            self._spec = {"key": key, "out": out, "lang": lang, "t0": time.monotonic()}

    @_serialized
    def spec_align_collect(self, stable_tokens: list, text: str, language: str,
                           offset_sec: float, key) -> ForcedAlignResult | None:
        """The `spec_align_start` alignment of `key`, or None (the caller runs
        `align()`). It is taken only when it is exact: every token is of
        class 1 or 2, the class-2 characters equal `align()`'s own
        `tokenize(text)`, and the device counted the same number of words.
        A None keeps the pre-encoded window for `align()`."""
        spec, self._spec = self._spec, None
        if spec is None or spec["key"] != key or (language or "").lower() != spec["lang"]:
            return None
        tab = self._word_cls
        toks = [int(t) for t in stable_tokens]
        if any(t < 0 or t >= len(tab) or tab[t] == 0 for t in toks):
            return None
        kept = [t for t in toks if tab[t] == 2]
        words = align_text.tokenize(text, language)
        if [self.tokenizer.token_to_bytes(t).decode("utf-8") for t in kept] != words:
            return None
        with profiling.span("align.decode") as readout:
            out = spec["out"].fetch()
        if int(out[-1]) != len(kept):
            return None
        if self._pre is not None and self._pre[0] == key:
            self._pre = None  # the result stands: the window is not needed again
        if not words:
            return ForcedAlignResult(items=align_text.reconcile(text, []), performance={
                "encoder_time": 0.0, "decoder_time": 0.0,
                "total_time": time.monotonic() - spec["t0"]})
        items = self._items(words, out[: 2 * len(kept)].tolist(), offset_sec)
        return ForcedAlignResult(items=align_text.reconcile(text, items), performance={
            "encoder_time": 0.0, "decoder_time": readout.seconds,
            "total_time": time.monotonic() - spec["t0"], "speculative": 1.0})

    def _items(self, words: list[str], raw_ts, offset_sec: float) -> list[ForcedAlignItem]:
        """Word items from the raw timestamp classes (LIS-repaired, x STEP_MS)."""
        fixed = align_text.fix_timestamps(raw_ts)
        ms = np.asarray(fixed, dtype=np.float64) * self.STEP_MS
        return [
            ForcedAlignItem(
                text=w,
                start_time=float(ms[i * 2] / 1000.0 + offset_sec),
                end_time=float(ms[i * 2 + 1] / 1000.0 + offset_sec),
            )
            for i, w in enumerate(words)
        ]

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
        precomputed_key=None,  # take a `pre_encode`d window when its key matches
    ) -> ForcedAlignResult:
        if language:
            language = normalize_language_name(language)
            validate_language(language)
        t_start = time.monotonic()

        # embeddings stay on the device; only their count is needed on the
        # host. The full bucket-shaped tensor is passed through (the audio
        # span mask picks the n_audio valid rows).
        if (precomputed_key is not None and self._pre is not None
                and self._pre[0] == precomputed_key):
            _, audio_embd, n_audio, enc = self._pre  # the pre_encode's own span
            self._pre = None
        else:
            with profiling.span("align.encode", device=self.device) as enc:
                audio_embd = self.encoder.encode(audio)
            n_audio = self.encoder.valid_tokens(int(audio.shape[-1]))

        ko_scores = self._korean_scores() if (language or "").lower() == "korean" else None
        words = align_text.tokenize(text, language, ko_scores=ko_scores)
        if not words:
            return ForcedAlignResult(items=align_text.reconcile(text, []), performance={
                "encoder_time": enc.device_seconds(enc.seconds), "decoder_time": 0.0,
                "total_time": time.monotonic() - t_start,
            })

        ids, audio_mask, ts_positions = self._prompt(words, n_audio)

        limit = min(TIMESTAMP_CLASSES, self.dec_cfg.lm_head_dim)
        with profiling.span("align.decode") as readout:
            raw_ts = self.runner.argmax_at(ids, audio_mask, audio_embd, ts_positions, limit)

        final_items = align_text.reconcile(text, self._items(words, raw_ts, offset_sec))
        return ForcedAlignResult(
            items=final_items,
            performance={
                "encoder_time": enc.device_seconds(enc.seconds),  # the readout waited
                "decoder_time": readout.seconds,
                "total_time": time.monotonic() - t_start,
            },
        )
