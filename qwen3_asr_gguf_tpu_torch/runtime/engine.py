"""QwenASREngine: chunked transcription with memory (counterpart of
`qwen3_asr_gguf_tpu/runtime/engine.py`), on one torch device.

Same semantics as the JAX engine's synchronous path:

- fixed `chunk_size`-second chunks (each zero-padded to the full chunk for
  the encoder) with a `memory_num`-chunk deque of (audio embeddings, text,
  tokens) carried as the prompt prefix;
- chat-protocol prompt [im_start]system ctx[im_end][im_start]user\\n
  [audio_start] AUDIO [audio_end][im_end][im_start]assistant\\n
  (language X)[asr_text] prefix, spliced with the audio on the device;
- KV prefix reuse: chunk 1 reuses [header | chunk-0 audio], later chunks the
  header only, which gives the same tokens as a full re-prefill;
- rollback of the last `rollback_num` tokens of every non-final chunk, the
  repetition circuit breaker and its temperature-escalation retries.

Precisions: "int4" (the q4_k decoder repacked for the int4 matvec kernels,
int4 encoder), "int8" (per-channel int8 decoder and encoder; on the card the
decode step's MLP runs through the fused int8 kernel unless `fused_mlp=False`),
"q4_k" (planar `Q4Weight` decoder through the fused dequant + matmul kernel,
int4 encoder), "bf16" / "f16" (a dense bf16 decoder, whose decode step is
cuBLAS products and the decode attention kernel, and the encoder's weights
rounded f32 -> f16 -> bf16 as the JAX package rounds them) and "f32"; KV
caches bf16, f32 or int8 (`kv_cache_dtype`; an f32 engine keeps f32 KV, as in
the JAX package). With `enable_aligner`, chunk i is force-aligned as soon as its
text is final, in the same windows and with the same offsets as the JAX
engine's align worker (which aligns chunk i-1 while chunk i decodes; here the
steps run one after the other and give the same items). `pipelined_dispatch`
runs this synchronous path, which gives the same tokens.

`mesh_shape` (e.g. {"model": 2}) runs the decoder tensor-parallel over the
initialised `torch.distributed` world (one process per rank, launched under
`torchrun`; `parallel.sharding.make_mesh`): the decoder's unfused weights
are cut into Megatron tiles, "int4" stays packed int4 where
`int4_tp_supported` holds and is served at "int8" otherwise, as in the JAX
package; the encoder and the aligner are replicated on every rank. Every
rank runs the same calls and gets the same text.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from codecs import getincrementaldecoder
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..models import params as P
from ..schema import (
    ASREngineConfig,
    DecodeResult,
    ForcedAlignItem,
    ForcedAlignResult,
    TranscribeResult,
)
from ..utils.languages import normalize_language_name, validate_language
from .encoder_runner import EncoderRunner
from .generate import Generator

logger = logging.getLogger(__name__)
SAMPLE_RATE = 16_000
_PUNCT_NEWLINE = re.compile(r"([，。？！：,\.])")
_KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


def align_offset(start: float, prev_items, prev_end: float) -> float:
    """Where a chunk's align window starts: where the previous chunk's last
    aligned item ended, at most 10 s before the previous chunk's end and
    never after it; at the chunk's own `start` when the previous chunk has
    no items (or there is none)."""
    if not prev_items:
        return start
    return min(prev_end, max(prev_items[-1].end_time, prev_end - 10.0))


@dataclasses.dataclass
class _Segment:
    idx: int
    audio_start: float
    audio_end: float
    text: str = ""
    lang: str = ""  # language detected for this chunk (auto mode)
    items: Optional[List[ForcedAlignItem]] = None


class QwenASREngine:
    def __init__(self, config: ASREngineConfig, device="cuda", *,
                 fused_mlp: bool | None = None):
        """`fused_mlp` goes to the Generator: None turns the fused int8 MLP
        kernel on for an "int8" engine on the card and off on the CPU."""
        if config.precision not in ("int4", "int8", "q4_k", "bf16", "f16", "f32"):
            raise ValueError(f"unknown precision {config.precision!r}")
        kv_name = "f32" if config.precision == "f32" else config.kv_cache_dtype
        if kv_name not in _KV_DTYPES:
            raise NotImplementedError(f"kv_cache_dtype {kv_name!r} is not ported yet")
        t_init = time.time()
        self.config = config
        self.verbose = config.verbose
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card by number: a worker thread's current card is card 0,
            # whatever this rank's card is
            self.device = torch.device("cuda", torch.cuda.current_device())
        model_dir = config.model_dir
        thinker = P.load_thinker_config(model_dir)
        self.thinker = thinker

        enc_path = os.path.join(model_dir, config.encoder_fn)
        if config.precision in ("int4", "q4_k", "int8"):
            enc_cfg, enc_params = P.load_encoder_quantized(
                enc_path, kind="int8" if config.precision == "int8" else "int4",
                device=self.device)
        elif config.precision in ("bf16", "f16"):
            enc_cfg, enc_params = P.load_encoder_half(enc_path, device=self.device)
        else:
            enc_cfg, enc_params = P.load_encoder_safetensors(enc_path, device=self.device)
        mel_path = os.path.join(model_dir, "mel_filters.npy")
        self.encoder = EncoderRunner(
            enc_params, enc_cfg,
            mel_filters=np.load(mel_path) if os.path.exists(mel_path) else None,
            device=self.device,
        )

        self.mesh = None
        dec_precision = {"f16": "bf16"}.get(config.precision, config.precision)
        if config.mesh_shape:
            from ..parallel import sharding as S

            self.mesh = S.make_mesh(dict(config.mesh_shape))
            _, tp = S.mesh_dim(self.mesh, "model")
            if dec_precision == "int4" and not S.int4_tp_supported(thinker.text, tp):
                logger.info("mesh inference: decoder precision int4 -> int8 "
                            "(geometry not TP-divisible)")
                dec_precision = "int8"
        dec_cfg, dec_params, tokenizer = P.load_decoder_gguf(
            os.path.join(model_dir, config.llm_fn), precision=dec_precision, device=self.device)
        self.dec_cfg = dec_cfg
        self.model = tokenizer  # the reference LlamaModel text API
        if self.mesh is None:
            # one qkv / gateup stream per layer; a row split of the fused
            # weights would cross the q / k / v sections under a mesh
            dec_params = P.fuse_layer_weights(dec_params)
        self.generator = Generator(
            dec_params, dec_cfg,
            n_ctx=config.n_ctx,
            eos_ids=thinker.eos_token_ids,
            block=config.decode_block,
            cache_dtype=_KV_DTYPES[kv_name],
            # only int4 prefills on a dense copy made once; the other
            # precisions go through `matmul` per call, as in the JAX package
            dequant_prefill=dec_precision == "int4",
            fused_mlp=fused_mlp,
            device=self.device,
            mesh=self.mesh,
        )
        self.ID_IM_START = thinker.im_start_token_id
        self.ID_IM_END = thinker.im_end_token_id
        self.ID_AUDIO_START = thinker.audio_start_token_id
        self.ID_AUDIO_END = thinker.audio_end_token_id
        self.ID_ASR_TEXT = thinker.asr_text_token_id

        self.aligner = None
        if config.enable_aligner and config.align_config is not None:
            from .aligner import QwenForcedAligner

            self.aligner = QwenForcedAligner(config.align_config, device=self.device)
        self.init_seconds = time.time() - t_init

    def shutdown(self) -> None:
        """No helper process to stop (API compatibility)."""

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- prompt ------------------------------------------------------------

    def _prompt_parts(self, prefix_text: str, context: Optional[str], language: Optional[str],
                      detect_language: bool = False) -> tuple[list, list]:
        """(header tokens through <|audio_start|>, suffix tokens from
        <|audio_end|> through the carried prefix text). With
        `detect_language` and no forced language the suffix stops at
        "assistant\\n", so the model emits ``language X<asr_text>body``."""
        key = (prefix_text, context, language, detect_language)
        memo = self.__dict__.setdefault("_prompt_parts_memo", {})
        if key in memo:
            return [*memo[key][0]], [*memo[key][1]]
        tk = self.model.tokenize
        prefix_str = f"system\n{context or 'You are a helpful assistant.'}"
        prefix_tokens = (
            [self.ID_IM_START] + tk(prefix_str) + [self.ID_IM_END]
            + [self.ID_IM_START] + tk("user\n") + [self.ID_AUDIO_START]
        )
        suffix_head = "assistant\n"
        if language:
            suffix_head += f"language {language}"
        suffix_tokens = [self.ID_AUDIO_END, self.ID_IM_END, self.ID_IM_START] + tk(suffix_head)
        if language or not detect_language:
            suffix_tokens += [self.ID_ASR_TEXT]
        suffix_tokens += tk(prefix_text)
        if len(memo) < 512:
            memo[key] = (list(prefix_tokens), list(suffix_tokens))
        return prefix_tokens, suffix_tokens

    def _build_prompt_ids(self, n_audio: int, prefix_text: str, context: Optional[str],
                          language: Optional[str], detect_language: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Full prompt as (token_ids, audio_mask)."""
        prefix_tokens, suffix_tokens = self._prompt_parts(
            prefix_text, context, language, detect_language)
        n_pre = len(prefix_tokens)
        total = n_pre + n_audio + len(suffix_tokens)
        ids = np.zeros(total, dtype=np.int32)
        ids[:n_pre] = prefix_tokens
        ids[n_pre + n_audio:] = suffix_tokens
        audio_mask = np.zeros(total, dtype=bool)
        audio_mask[n_pre: n_pre + n_audio] = True
        return ids, audio_mask

    @staticmethod
    def _suffix_prompt_ids(n_audio: int, suffix_tokens: list) -> tuple[np.ndarray, np.ndarray]:
        """[current-chunk audio placeholders | suffix tokens] for a prefill on
        a reused cache prefix."""
        total = n_audio + len(suffix_tokens)
        ids = np.zeros(total, dtype=np.int32)
        ids[n_audio:] = suffix_tokens
        audio_mask = np.zeros(total, dtype=bool)
        audio_mask[:n_audio] = True
        return ids, audio_mask

    # -- decode ------------------------------------------------------------

    def _decode(self, ids, audio_mask, audio_embd, rollback_num: int,
                is_last_chunk: bool = False, temperature: float = 0.4, reuse=None,
                retry_cache=None, max_new_tokens: int | None = None
                ) -> tuple[DecodeResult, dict]:
        """One chunk generation with rollback and the circuit breaker.
        Returns (result, KV cache). `retry_cache`: the cache of a failed
        attempt over the same prompt, re-sampled from its last position."""
        result = DecodeResult()
        result.n_prefill = int(ids.shape[0])
        gen = self.generator
        t0 = time.time()
        drop_first_emitted = False
        if retry_cache is not None:
            base = reuse[1] if reuse is not None else 0
            state = gen.restart_at(retry_cache, pos=base + int(ids.shape[0]) - 1,
                                   last_token=int(ids[-1]))
            drop_first_emitted = True  # the block emits the re-fed prompt token
        elif reuse is None:
            state = gen.start_spliced(ids, audio_mask, audio_embd, temperature=temperature)
        else:
            cache, start = reuse
            state = gen.start_spliced_at(ids, audio_mask, audio_embd, start=start, cache=cache,
                                         temperature=temperature)
        result.t_prefill = time.time() - t0  # the first-token readback synchronized

        t1 = time.time()
        display_queue: deque[int] = deque()
        stable_tokens: List[int] = []
        stable_text = ""
        text_decoder = getincrementaldecoder("utf-8")(errors="replace")
        n_gen = 0
        max_new = max_new_tokens if max_new_tokens is not None else self.config.max_new_tokens

        def emit(tok: int) -> str:
            piece = text_decoder.decode(self.model.token_to_bytes(tok))
            if piece and self.verbose:
                print(_PUNCT_NEWLINE.sub("\\1\n", piece), end="", flush=True)
            return piece

        while True:
            toks, state, finished, rep_aborted = gen.decode_block(state, temperature)
            if drop_first_emitted and toks:
                toks = toks[1:]
                drop_first_emitted = False
            for tok in toks:
                if n_gen >= max_new:
                    break
                n_gen += 1
                display_queue.append(tok)
                if len(display_queue) > rollback_num:
                    ready = display_queue.popleft()
                    stable_tokens.append(ready)
                    stable_text += emit(ready)
                if len(stable_tokens) > 15 and len(set(stable_tokens[-15:])) <= 3:
                    result.is_aborted = True
                    break
            if rep_aborted:
                result.is_aborted = True
            if finished or n_gen >= max_new or result.is_aborted:
                break
        result.t_generate = time.time() - t1

        if is_last_chunk and not result.is_aborted:
            while display_queue:
                stable_tokens.append(display_queue.popleft())
                stable_text += emit(stable_tokens[-1])
            tail = text_decoder.decode(b"", final=True)
            if tail:
                stable_text += tail
                if self.verbose:
                    print(tail, end="", flush=True)

        result.text = stable_text
        result.stable_tokens = stable_tokens
        result.n_generate = n_gen
        return result, state.cache

    def _safe_decode(self, ids, audio_mask, audio_embd, rollback_num: int, is_last_chunk: bool,
                     temperature: float, reuse=None, max_new_tokens: int | None = None
                     ) -> tuple[DecodeResult, dict]:
        """Circuit-breaker retries with temperature escalation (<= 4
        attempts, +0.3 each); a retry re-samples the same prompt from the
        failed attempt's cache."""
        res = DecodeResult()
        cache = reuse[0] if reuse is not None else None
        for attempt in range(4):
            r = reuse if reuse is None else (cache, reuse[1])
            res, cache = self._decode(
                ids, audio_mask, audio_embd, rollback_num, is_last_chunk, temperature,
                reuse=r, retry_cache=cache if attempt > 0 else None,
                max_new_tokens=max_new_tokens,
            )
            if not res.is_aborted:
                break
            temperature += 0.3
            res.text += "====decode aborted: repetition circuit breaker===="
            if self.verbose:
                print(f"\n\n[!] retrying with temperature {temperature:.1f}\n")
        return res, cache

    # -- stats -------------------------------------------------------------

    def _print_stats(self, stats: dict, audio_duration: float, t_total: float) -> None:
        rtf = t_total / audio_duration if audio_duration > 0 else 0.0
        pre = stats["prefill_tokens"] / stats["prefill_time"] if stats["prefill_time"] > 0 else 0
        gen = stats["decode_tokens"] / stats["decode_time"] if stats["decode_time"] > 0 else 0
        print("\n\nstats:")
        print(f"  RTF            : {rtf:.3f}")
        print(f"  audio duration : {audio_duration:.2f} s")
        print(f"  total time     : {t_total:.2f} s")
        print(f"  encode wait    : {stats['wait_time']:.2f} s")
        print(f"  align total    : {stats['align_enc_time'] + stats['align_dec_time']:.2f} s")
        print(f"  LLM prefill    : {stats['prefill_time']:.3f} s ({stats['prefill_tokens']} tok, {pre:.1f} tok/s)")
        print(f"  LLM generate   : {stats['decode_time']:.3f} s ({stats['decode_tokens']} tok, {gen:.1f} tok/s)")

    # -- public API --------------------------------------------------------

    def transcribe(self, audio_file: str, language: Optional[str] = None,
                   context: Optional[str] = None, start_second: float = 0.0,
                   duration: float = 0.0, temperature: float = 0.4,
                   rollback_num: int = 5) -> TranscribeResult:
        from ..audio.io import load_audio

        audio = load_audio(audio_file, start_second=start_second or None,
                           duration=duration or None)
        return self.asr(audio=audio, context=context or "", language=language,
                        chunk_size_sec=self.config.chunk_size,
                        memory_chunks=self.config.memory_num,
                        temperature=temperature, rollback_num=rollback_num)

    def asr(self, audio: np.ndarray, context: Optional[str], language: Optional[str],
            chunk_size_sec: float = 40.0, memory_chunks: int = 1, temperature: float = 0.4,
            rollback_num: int = 5, detect_language: bool = False) -> TranscribeResult:
        """Chunked transcription. `detect_language=True` with no language
        parses chunk 0's ``language X<asr_text>body`` output and forces the
        detected language on later chunks."""
        if language:
            language = normalize_language_name(language)
            validate_language(language)
        detecting = detect_language and not language
        cur_lang = language

        samples_per_chunk = int(chunk_size_sec * SAMPLE_RATE)
        total_len = len(audio)
        num_chunks = int(np.ceil(total_len / samples_per_chunk)) if total_len else 0
        total_duration = total_len / SAMPLE_RATE
        segments = [
            _Segment(idx=i, audio_start=i * chunk_size_sec,
                     audio_end=min((i + 1) * chunk_size_sec, total_duration))
            for i in range(num_chunks)
        ]
        memory: deque = deque(maxlen=memory_chunks)
        full_text = ""
        aligned_items: List[ForcedAlignItem] = []
        stats = {
            "prefill_time": 0.0, "decode_time": 0.0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "wait_time": 0.0, "encode_time": 0.0,
            "align_enc_time": 0.0, "align_dec_time": 0.0,
        }
        t_main = time.time()

        # every chunk zero-padded to the full chunk, uploaded once
        chunks_dev = None
        if num_chunks:
            padded = np.zeros((num_chunks, samples_per_chunk), np.float32)
            flat = np.asarray(audio, np.float32)[: num_chunks * samples_per_chunk]
            padded.reshape(-1)[: len(flat)] = flat
            chunks_dev = torch.from_numpy(padded).to(self.device)

        a_full = self.encoder.valid_tokens(samples_per_chunk)
        kv_cache = None

        def trim_prefix_tokens(ptoks: list, n_fixed: int) -> list:
            """Drop the oldest carried tokens if prompt + generation headroom
            would overflow n_ctx (the prefix is carried as raw tokens)."""
            budget = self.config.n_ctx - min(self.config.max_new_tokens, 256)
            overflow = n_fixed + len(ptoks) - budget
            if overflow <= 0:
                return ptoks
            return ptoks[overflow:] if overflow < len(ptoks) else []

        def full_prompt(i: int, audio_feature, lang, detect):
            """(ids, mask, embeddings) of a from-scratch chunk prompt."""
            carried = [t for m in memory for t in m[2]]
            combined = torch.cat([m[0] for m in memory] + [audio_feature]) if memory else audio_feature
            actual = min(samples_per_chunk, total_len - i * samples_per_chunk)
            n_audio_prompt = a_full * len(memory) + self.encoder.valid_tokens(actual)
            hdr, template = self._prompt_parts("", context, lang, detect)
            kept = trim_prefix_tokens(carried, len(hdr) + n_audio_prompt + len(template))
            suffix_tokens = template + kept
            total = len(hdr) + n_audio_prompt + len(suffix_tokens)
            ids = np.zeros(total, dtype=np.int32)
            ids[: len(hdr)] = hdr
            ids[len(hdr) + n_audio_prompt:] = suffix_tokens
            mask = np.zeros(total, dtype=bool)
            mask[len(hdr): len(hdr) + n_audio_prompt] = True
            return ids, mask, combined

        def align_window(idx: int) -> tuple[float, int, int]:
            """(offset_sec, start_sample, end_sample) of segment idx's align
            window (`align_offset`); valid once segment idx-1's items are
            known."""
            seg = segments[idx]
            prev = segments[idx - 1] if idx > 0 else None
            offset_sec = align_offset(seg.audio_start, prev and prev.items,
                                      prev.audio_end if prev else 0.0)
            return offset_sec, int(offset_sec * SAMPLE_RATE), int(seg.audio_end * SAMPLE_RATE)

        def run_align(idx: int) -> None:
            """Align segment idx once its text is final."""
            seg = segments[idx]
            if not seg.text.strip():
                seg.items = []
                return
            offset_sec, s, e = align_window(idx)
            try:
                ares = self.aligner.align(
                    audio[s:e], seg.text,
                    language=seg.lang or cur_lang or "Chinese",
                    offset_sec=offset_sec,
                )
            except Exception:
                # degrade to no timestamps for this chunk, and say so
                logger.warning(
                    "forced alignment failed for chunk %d [%0.1fs-%0.1fs]; "
                    "timestamps degraded to empty",
                    idx, offset_sec, seg.audio_end, exc_info=True,
                )
                seg.items = []
                return
            seg.items = list(ares.items)
            aligned_items.extend(ares.items)
            if ares.performance:
                stats["align_enc_time"] += ares.performance.get("encoder_time", 0)
                stats["align_dec_time"] += ares.performance.get("decoder_time", 0)

        for i in range(num_chunks):
            t_w = time.time()
            audio_feature = self.encoder.encode(chunks_dev[i])[:a_full]
            self._sync()
            stats["encode_time"] += time.time() - t_w
            stats["wait_time"] += time.time() - t_w  # no overlap: the encode is waited on

            actual_samples = min(samples_per_chunk, total_len - i * samples_per_chunk)
            n_valid_cur = self.encoder.valid_tokens(actual_samples)
            is_last = i == num_chunks - 1
            prefix_tokens, suffix_head = self._prompt_parts("", context, cur_lang, detecting)
            n_pre = len(prefix_tokens)
            start = n_pre + a_full
            use_reuse = (
                self.config.kv_prefix_reuse and memory_chunks == 1
                and len(memory) == 1 and kv_cache is not None
            )
            if use_reuse:
                carried = [t for m in memory for t in m[2]]
                kept = trim_prefix_tokens(carried, start + n_valid_cur + len(suffix_head))
                suffix_tokens = suffix_head + kept
                if i >= 2:
                    # only the header KV [0, n_pre) is carried; the memory
                    # audio re-prefills at its new positions with this chunk
                    ids, audio_mask = self._suffix_prompt_ids(a_full + n_valid_cur, suffix_tokens)
                    embd_in = torch.cat([memory[-1][0], audio_feature])
                    reuse = (kv_cache, n_pre)
                else:
                    # chunk 1: [header | chunk-0 audio] KV is exact as-is
                    ids, audio_mask = self._suffix_prompt_ids(n_valid_cur, suffix_tokens)
                    embd_in, reuse = audio_feature, (kv_cache, start)
            else:
                ids, audio_mask, embd_in = full_prompt(i, audio_feature, cur_lang, detecting)
                reuse = None
            res, kv_cache = self._safe_decode(ids, audio_mask, embd_in, rollback_num, is_last,
                                              temperature, reuse=reuse)

            chunk_text = res.text
            mem_tokens = list(res.stable_tokens)
            if detecting and cur_lang is None:
                from ..text.parsing import parse_asr_output

                d_lang, body = parse_asr_output(chunk_text)
                segments[i].lang = d_lang
                chunk_text = body
                if d_lang:
                    cur_lang = d_lang
                if self.ID_ASR_TEXT in mem_tokens:
                    mem_tokens = mem_tokens[mem_tokens.index(self.ID_ASR_TEXT) + 1:]
            segments[i].text = chunk_text
            memory.append((audio_feature, chunk_text, mem_tokens))
            full_text += chunk_text
            stats["prefill_tokens"] += res.n_prefill
            stats["prefill_time"] += res.t_prefill
            stats["decode_tokens"] += res.n_generate
            stats["decode_time"] += res.t_generate
            if self.aligner is not None:
                run_align(i)

        aligned_items.sort(key=lambda x: x.start_time)
        t_total = time.time() - t_main
        if self.verbose:
            self._print_stats(stats, total_duration, t_total)
        if language:
            result_language = language
        else:
            from ..text.parsing import merge_languages

            result_language = merge_languages([s.lang for s in segments])
        return TranscribeResult(
            text=full_text,
            alignment=ForcedAlignResult(items=aligned_items) if aligned_items else None,
            performance=stats, language=result_language,
        )

