"""QwenASREngine: chunked transcription with memory (counterpart of
`qwen3_asr_gguf_tpu/runtime/engine.py`), on one torch device.

Same semantics as the JAX engine:

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

The 3-stage pipeline encode(i+1) | decode(i) | align(i-1), as in the JAX
engine: chunk i+1's encode is queued before chunk i is decoded; a decode
queues block n+1 before it reads block n; and with one block per chunk
(`max_new_tokens == decode_block` and `pipelined_dispatch`, the bench
headline) chunk i+1's prompt is assembled on the device from chunk i's
emitted tokens and its prefill and block are queued before chunk i's tokens
are read (`_dispatch_chunk_spec`); an abort or a token-accounting mismatch
throws that work away and redoes the chunk on the synchronous path. With
`enable_aligner`, a one-thread align pool aligns chunk i-1 while chunk i
decodes, pre-encodes the next align window, and aligns chunk 0 and the last
chunk speculatively from their blocks' emitted tokens, taking that result
only when it is exactly `align()`'s. The aligner is brought up on a thread
of its own at init and joined at first use. Both threads queue on the
device's default stream, so the device runs their work in the order it was
queued. Every flow gives the same tokens, text and items.

Precisions: "int4" (the q4_k decoder repacked for the int4 matvec kernels,
int4 encoder), "int8" (per-channel int8 decoder and encoder; on the card the
decode step's MLP runs through the fused int8 kernel unless `fused_mlp=False`),
"q4_k" (planar `Q4Weight` decoder through the fused dequant + matmul kernel,
int4 encoder), "bf16" / "f16" (a dense bf16 decoder, whose decode step is
cuBLAS products and the decode attention kernel, and the encoder's weights
rounded f32 -> f16 -> bf16 as the JAX package rounds them) and "f32"; KV
caches bf16, f32 or int8 (`kv_cache_dtype`; an f32 engine keeps f32 KV, as in
the JAX package).

`mesh_shape` (e.g. {"model": 2}) runs the decoder tensor-parallel over the
initialised `torch.distributed` world (one process per rank, launched under
`torchrun`; `parallel.sharding.make_mesh`): the decoder's unfused weights
are cut into Megatron tiles, "int4" stays packed int4 where
`int4_tp_supported` holds and is served at "int8" otherwise, as in the JAX
package; the encoder and the aligner are replicated on every rank. Every
rank runs the same calls and gets the same text.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from codecs import getincrementaldecoder
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..models import params as P
from ..models.mla_config import refuse
from ..schema import (
    ASREngineConfig,
    DecodeResult,
    ForcedAlignItem,
    ForcedAlignResult,
    TranscribeResult,
)
from ..utils import profiling
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


class _StableStream:
    """The host side of one chunk's decode: the rollback display queue, the
    stable tokens and their UTF-8 text, and the repetition circuit breaker
    (<= 3 distinct among the last 15 stable tokens)."""

    def __init__(self, engine, rollback_num: int, max_new: int):
        self.engine, self.rollback, self.max_new = engine, rollback_num, max_new
        self.queue: deque[int] = deque()
        self.tokens: List[int] = []
        self.text = ""
        self.n_gen = 0
        self.decoder = getincrementaldecoder("utf-8")(errors="replace")

    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        piece = self.decoder.decode(self.engine.model.token_to_bytes(tok))
        if piece and self.engine.verbose:
            print(_PUNCT_NEWLINE.sub("\\1\n", piece), end="", flush=True)
        self.text += piece

    def take(self, toks: list) -> bool:
        """Take a block's tokens (up to max_new in all); True when the
        breaker trips."""
        for tok in toks:
            if self.n_gen >= self.max_new:
                break
            self.n_gen += 1
            self.queue.append(tok)
            if len(self.queue) > self.rollback:
                self._emit(self.queue.popleft())
            if len(self.tokens) > 15 and len(set(self.tokens[-15:])) <= 3:
                return True
        return False

    def close(self, result: DecodeResult, is_last_chunk: bool) -> None:
        """Flush the rollback tail of a final chunk and fill `result`."""
        if is_last_chunk and not result.is_aborted:
            while self.queue:
                self._emit(self.queue.popleft())
            tail = self.decoder.decode(b"", final=True)
            if tail:
                self.text += tail
                if self.engine.verbose:
                    print(tail, end="", flush=True)
        result.text = self.text
        result.stable_tokens = self.tokens
        result.n_generate = self.n_gen


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
        kernel on for an "int8" engine on the card and off on the CPU.
        `init_seconds` is the duration of the `engine.init` span (its
        children `engine.init.encoder`, `.decoder`, `.generator`)."""
        if config.precision not in ("int4", "int8", "q4_k", "bf16", "f16", "f32"):
            raise ValueError(f"unknown precision {config.precision!r}")
        kv_name = "f32" if config.precision == "f32" else config.kv_cache_dtype
        if kv_name not in _KV_DTYPES:
            raise NotImplementedError(f"kv_cache_dtype {kv_name!r} is not ported yet")
        with profiling.span("engine.init") as init:
            self._init(config, kv_name, device, fused_mlp)
        self.init_seconds = init.seconds

    def _init(self, config: ASREngineConfig, kv_name: str, device, fused_mlp) -> None:
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
        with profiling.span("engine.init.encoder"):
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

            refuse(thinker.text, "tensor parallelism (mesh_shape)")
            self.mesh = S.make_mesh(dict(config.mesh_shape))
            _, tp = S.mesh_dim(self.mesh, "model")
            if dec_precision == "int4" and not S.int4_tp_supported(thinker.text, tp):
                logger.info("mesh inference: decoder precision int4 -> int8 "
                            "(geometry not TP-divisible)")
                dec_precision = "int8"
        with profiling.span("engine.init.decoder"):
            dec_cfg, dec_params, tokenizer = P.load_decoder_gguf(
                os.path.join(model_dir, config.llm_fn), precision=dec_precision,
                device=self.device)
            if self.mesh is None:
                # one qkv / gateup stream per layer; a row split of the fused
                # weights would cross the q / k / v sections under a mesh
                dec_params = P.fuse_layer_weights(dec_params)
        self.dec_cfg = dec_cfg
        self.model = tokenizer  # the reference LlamaModel text API
        with profiling.span("engine.init.generator"):
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

        # the aligner and its word-class table come up on a thread of their
        # own, beside the caller's first steps; joined at first use
        self._aligner = None
        self._aligner_thread: Optional[threading.Thread] = None
        self._aligner_error: Optional[BaseException] = None
        if config.enable_aligner and config.align_config is not None:
            self._aligner_thread = threading.Thread(
                target=self._bring_up_aligner, args=(config.align_config,), daemon=True,
                name="aligner-bring-up")
            self._aligner_thread.start()

    def _bring_up_aligner(self, align_config) -> None:
        try:
            with self._on_device():
                from .aligner import QwenForcedAligner

                aligner = QwenForcedAligner(align_config, device=self.device)
                if aligner._word_cls is None:
                    aligner.build_word_cls_table()
            self._aligner = aligner
        except BaseException as e:  # raised at first use
            self._aligner_error = e

    def _on_device(self):
        """The engine's card as the current one, for work on another thread
        (a new thread's current card is card 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @property
    def aligner(self):
        """The forced aligner, or None; joins the bring-up thread on first
        use and raises its error."""
        if self._aligner_thread is not None:
            self._aligner_thread.join()
            self._aligner_thread = None
            if self._aligner_error is not None:
                raise self._aligner_error
        return self._aligner

    @aligner.setter
    def aligner(self, value) -> None:
        self.shutdown()
        self._aligner, self._aligner_thread, self._aligner_error = value, None, None

    def shutdown(self) -> None:
        """Join the aligner's bring-up thread (no helper process to stop)."""
        if self._aligner_thread is not None:
            self._aligner_thread.join()

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
        with profiling.span("engine.prompt"):
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
        attempt over the same prompt, re-sampled from its last position.
        `t_prefill` is the prefill's stream time (`decode.prefill`'s CUDA
        events; its host time where no block wait followed it, the context
        being full; 0 for a retry, which prefills nothing), `t_generate` the
        host's time from
        the first block's queueing to the last one's tokens taken
        (`engine.generate`)."""
        result = DecodeResult()
        result.n_prefill = int(ids.shape[0])
        gen = self.generator
        drop_first_emitted = False
        prefill = None
        if retry_cache is not None:
            base = reuse[1] if reuse is not None else 0
            state = gen.restart_at(retry_cache, pos=base + int(ids.shape[0]) - 1,
                                   last_token=int(ids[-1]))
            drop_first_emitted = True  # the block emits the re-fed prompt token
        else:
            with profiling.span("decode.prefill", device=self.device) as prefill:
                if reuse is None:
                    state = gen.start_spliced(ids, audio_mask, audio_embd,
                                              temperature=temperature)
                else:
                    cache, start = reuse
                    state = gen.start_spliced_at(ids, audio_mask, audio_embd, start=start,
                                                 cache=cache, temperature=temperature)

        with profiling.span("engine.generate") as generate:
            max_new = (max_new_tokens if max_new_tokens is not None
                       else self.config.max_new_tokens)
            stream = _StableStream(self, rollback_num, max_new)
            # 1-deep block pipeline (JAX engine.py:433-472): block n+1 is queued
            # before block n is read; a block queued after the latch holds it
            st, packed = gen.decode_block_dispatch(state, temperature)
            latest = st
            while True:
                spec = None
                if packed is not None and stream.n_gen + gen.block < max_new:
                    spec = gen.decode_block_dispatch(st, temperature)
                    latest = spec[0]
                toks, finished, rep_aborted = gen.collect_block(packed)
                if drop_first_emitted and toks:
                    toks = toks[1:]
                    drop_first_emitted = False
                if stream.take(toks) or rep_aborted:
                    result.is_aborted = True
                if finished or stream.n_gen >= max_new or result.is_aborted:
                    break
                if spec is None:
                    spec = gen.decode_block_dispatch(st, temperature)
                    latest = spec[0]
                st, packed = spec
        result.t_generate = generate.seconds
        result.t_prefill = (prefill.device_seconds(prefill.seconds)
                            if prefill is not None else 0.0)
        stream.close(result, is_last_chunk)
        return result, latest.cache

    def _dispatch_chunk(self, ids, audio_mask, audio_embd, temperature: float, reuse=None):
        """Prefill and ONE block, queued without waiting for the block's
        result (JAX engine.py:494-515; valid when max_new_tokens <= block;
        with CUDA graphs the host returns once the card is within
        `generate.GRAPH_LAG` steps of the block's end) -> a pending dict for
        `_collect_chunk`, or None when the context is full (the caller then
        takes `_safe_decode`)."""
        gen = self.generator
        with profiling.span("decode.prefill", device=self.device) as prefill:
            if reuse is None:
                st = gen.start_spliced(ids, audio_mask, audio_embd, temperature=temperature)
            else:
                cache, start = reuse
                st = gen.start_spliced_at(ids, audio_mask, audio_embd, start=start, cache=cache,
                                          temperature=temperature)
        with profiling.span("engine.generate") as block:
            st2, packed = gen.decode_block_dispatch(st, temperature)
        if packed is None:
            return None
        return {"state": st2, "packed": packed, "n_prefill": int(ids.shape[0]),
                "prefill": prefill, "block": block}

    def _dispatch_chunk_spec(self, template_ids, emitted, audio_embd, *, n_audio: int,
                             start: int, cache, temperature: float, rollback: int,
                             max_keep: int):
        """Chunk i+1 queued before chunk i is read (JAX engine.py:517-544):
        its prompt tail, chunk i's stable tokens, is assembled on the device
        from chunk i's emitted buffer. The caller checks its own token
        accounting at collect time and redoes the chunk on a mismatch or an
        abort (the cache prefix [0:start) stays valid: a decode reads only
        slots that the redo writes first)."""
        gen = self.generator
        with profiling.span("decode.prefill", device=self.device) as prefill:
            st = gen.start_spliced_at_spec(template_ids, emitted, audio_embd, n_audio=n_audio,
                                           start=start, cache=cache, rollback=rollback,
                                           max_keep=max_keep, temperature=temperature)
        bound = start + n_audio + len(template_ids) + max_keep
        with profiling.span("engine.generate") as block:
            st2, packed = gen.decode_block_dispatch(st, temperature, pos_bound=bound)
        if packed is None:
            return None
        return {"state": st2, "packed": packed,
                "n_prefill": n_audio + len(template_ids),  # + n_keep at collect
                "prefill": prefill, "block": block}

    def _collect_chunk(self, pend: dict, rollback_num: int, is_last_chunk: bool) -> DecodeResult:
        """Read a dispatched chunk's block and run `_decode`'s host-side token
        processing on it (JAX engine.py:546-596). Its times are those of the
        synchronous flow: the prefill's stream time, and the host's
        `engine.generate` spans, the block's queueing and here the wait for
        its result and the tokens taken."""
        with profiling.span("engine.generate") as collect:
            toks, _, rep_aborted = self.generator.collect_block(pend["packed"])
            result = DecodeResult()
            result.n_prefill = pend["n_prefill"]
            stream = _StableStream(self, rollback_num, self.config.max_new_tokens)
            result.is_aborted = stream.take(toks) or rep_aborted
        result.t_prefill = pend["prefill"].device_seconds(pend["prefill"].seconds)
        result.t_generate = pend["block"].seconds + collect.seconds
        stream.close(result, is_last_chunk)
        return result

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
        """The call's `performance` and its `engine.asr` span so far
        (`t_total`): prefill and encode in stream seconds, the rest host."""
        rtf = t_total / audio_duration if audio_duration > 0 else 0.0
        pre = stats["prefill_tokens"] / stats["prefill_time"] if stats["prefill_time"] > 0 else 0
        gen = stats["decode_tokens"] / stats["decode_time"] if stats["decode_time"] > 0 else 0
        print("\n\nstats:")
        print(f"  RTF            : {rtf:.3f}")
        print(f"  audio duration : {audio_duration:.2f} s")
        print(f"  total time     : {t_total:.2f} s")
        print(f"  encode         : {stats['encode_time']:.3f} s on the stream, "
              f"{stats['wait_time']:.3f} s queueing")
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
        """Chunked transcription in the 3-stage pipeline (JAX engine.py:
        671-1269), one `engine.asr` span. `detect_language=True` with no
        language parses chunk 0's ``language X<asr_text>body`` output and
        forces the detected language on later chunks.

        `performance`: `decode_time` (the chunks' `t_generate`, host),
        `decode_tokens`, `prefill_tokens`; `prefill_time`, `encode_time` and
        `align_enc_time` in stream seconds (the CUDA events of
        `decode.prefill`, `engine.encode`, `align.encode`: the time the
        stream took to pass the work, launches included, so close to the
        host's launch time while the card outruns the host); `wait_time` the
        host's time queueing the encodes; `align_dec_time` the aligner's
        readouts."""
        with profiling.span("engine.asr") as call:
            return self._asr(call, audio, context, language, chunk_size_sec, memory_chunks,
                             temperature, rollback_num, detect_language)

    def _asr(self, call, audio, context, language, chunk_size_sec, memory_chunks,
             temperature, rollback_num, detect_language) -> TranscribeResult:
        if language:
            language = normalize_language_name(language)
            validate_language(language)
        detecting = detect_language and not language
        cur = {"lang": language}  # the align worker reads it too
        # a per-call number in every align pre-encode / speculative key: a
        # window's samples alone can repeat across calls on other audio
        seq = self._align_seq = getattr(self, "_align_seq", 0) + 1

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

        # every chunk zero-padded to the full chunk, uploaded once
        chunks_dev = None
        if num_chunks:
            padded = np.zeros((num_chunks, samples_per_chunk), np.float32)
            flat = np.asarray(audio, np.float32)[: num_chunks * samples_per_chunk]
            padded.reshape(-1)[: len(flat)] = flat
            chunks_dev = torch.from_numpy(padded).to(self.device)

        a_full = self.encoder.valid_tokens(samples_per_chunk)
        enc_out: dict[int, torch.Tensor] = {}
        encodes: list = []  # the `engine.encode` spans, read after the last block's wait

        def send_enc(idx: int) -> None:
            """Queue chunk idx's encode (its valid rows)."""
            if 0 <= idx < num_chunks and idx not in enc_out:
                with profiling.span("engine.encode", device=self.device) as enc:
                    enc_out[idx] = self.encoder.encode(chunks_dev[idx])[:a_full]
                encodes.append(enc)

        def wait_enc(idx: int) -> torch.Tensor:
            """Chunk idx's embeddings on the device; nothing waits (the device
            runs the encode before any later work on them). Entries older
            than idx - 1 are dropped."""
            for k in [k for k in enc_out if k < idx - 1]:
                del enc_out[k]
            return enc_out[idx]

        def align_window(idx: int) -> tuple[float, int, int]:
            """(offset_sec, start_sample, end_sample) of segment idx's align
            window (`align_offset`); valid once segment idx-1's items are
            known."""
            seg = segments[idx]
            prev = segments[idx - 1] if idx > 0 else None
            offset_sec = align_offset(seg.audio_start, prev and prev.items,
                                      prev.audio_end if prev else 0.0)
            return offset_sec, int(offset_sec * SAMPLE_RATE), int(seg.audio_end * SAMPLE_RATE)

        # the speculative aligns (chunk 0 and the last chunk): idx ->
        # {"tokens": the chunk's stable tokens once the main loop has them}
        spec_aligns: dict[int, dict] = {}

        def take_items(seg: _Segment, ares) -> None:
            seg.items = list(ares.items)
            aligned_items.extend(ares.items)
            if ares.performance:
                stats["align_enc_time"] += ares.performance.get("encoder_time", 0)
                stats["align_dec_time"] += ares.performance.get("decoder_time", 0)

        def run_align(idx: int) -> None:
            """Align segment idx once its text is final (on the align worker),
            then pre-encode the next window, which is now known."""
            aligner = self.aligner
            seg = segments[idx]
            if not seg.text.strip():
                seg.items = []
                return
            offset_sec, s, e = align_window(idx)
            lang = seg.lang or cur["lang"] or "Chinese"
            ares = None
            ent = spec_aligns.get(idx)
            if ent is not None and ent.get("tokens") is not None:
                try:
                    ares = aligner.spec_align_collect(ent["tokens"], seg.text, lang, offset_sec,
                                                      key=(seq, s, e))
                except Exception:
                    logger.debug("speculative align collect failed; aligning again",
                                 exc_info=True)
            if ares is None:
                try:
                    ares = aligner.align(audio[s:e], seg.text, language=lang,
                                         offset_sec=offset_sec, precomputed_key=(seq, s, e))
                except Exception:
                    # degrade to no timestamps for this chunk, and say so
                    logger.warning(
                        "forced alignment failed for chunk %d [%0.1fs-%0.1fs]; "
                        "timestamps degraded to empty",
                        idx, offset_sec, seg.audio_end, exc_info=True,
                    )
                    seg.items = []
                    return
            take_items(seg, ares)
            if idx + 1 < num_chunks:
                _, s2, e2 = align_window(idx + 1)
                aligner.pre_encode(audio[s2:e2], key=(seq, s2, e2))

        # align(i - 1) runs on one worker thread beside decode(i): one worker
        # keeps the order, since align(i) starts where align(i - 1) ended
        # (the private fields: checking them does not join the bring-up)
        has_aligner = self._aligner is not None or self._aligner_thread is not None
        align_pool = ThreadPoolExecutor(max_workers=1) if has_aligner else None
        align_futs: list = []

        def on_worker(fn, *args):
            def task():
                with self._on_device(), profiling.span("engine.align", request=call.request):
                    fn(*args)
            align_futs.append(align_pool.submit(task))

        def submit_align(idx: int) -> None:
            if align_pool is not None and 0 <= idx < num_chunks:
                on_worker(run_align, idx)

        def submit_spec_align(idx: int, packed, drop_last: int = 0
                              ) -> Optional[threading.Event]:
            """Queue chunk idx's speculative align on the worker, behind the
            block that `packed` reads (window 0 is known at the start, the
            last window once align(last - 1) is in). Returns an event set
            once it is queued on the device (JAX engine.py:898-936)."""
            if align_pool is None or packed is None or idx in spec_aligns:
                return None
            spec_aligns[idx] = {"tokens": None}
            evt = threading.Event()

            def task() -> None:
                try:
                    aligner = self.aligner
                    _, s_w, e_w = align_window(idx)
                    try:
                        aligner.spec_align_start(packed.emitted, key=(seq, s_w, e_w),
                                                 language=cur["lang"] or "Chinese",
                                                 drop_last=drop_last)
                    except Exception:
                        logger.debug("speculative align dispatch failed", exc_info=True)
                finally:
                    evt.set()

            on_worker(task)
            return evt

        if align_pool is not None and num_chunks:
            def pre0() -> None:
                # window 0 depends on no items: its encode rides under the
                # decode of chunk 0 (chunk 0's padded row when it is exactly it)
                _, s0, e0 = align_window(0)
                src = chunks_dev[0] if (s0, e0) == (0, samples_per_chunk) else audio[s0:e0]
                self.aligner.pre_encode(src, key=(seq, s0, e0))

            on_worker(pre0)

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

        # pipelined chunk dispatch (JAX engine.py:979-991): with one block
        # per chunk, chunk i+1's prompt tail is assembled on the device from
        # chunk i's emitted tokens and queued before chunk i is read
        fast_ok = (self.config.pipelined_dispatch
                   and self.config.max_new_tokens == self.generator.block)
        inflight = None  # chunk i, queued before its turn and not yet read
        spec0_evt = None  # chunk 0's speculative align is queued on the device

        if num_chunks:
            send_enc(0)
        for i in range(num_chunks):
            send_enc(i + 1)  # queue the next encode before this chunk's decode
            audio_feature = wait_enc(i)

            if i >= 1:
                submit_align(i - 1)
            if i == num_chunks - 1 and inflight is not None:
                # the last chunk's block was queued during i - 1: its
                # speculative align goes right behind align(i - 1)
                submit_spec_align(i, inflight["packed"])

            actual_samples = min(samples_per_chunk, total_len - i * samples_per_chunk)
            n_valid_cur = self.encoder.valid_tokens(actual_samples)
            is_last = i == num_chunks - 1
            prefix_tokens, suffix_head = self._prompt_parts("", context, cur["lang"], detecting)
            n_pre = len(prefix_tokens)
            start = n_pre + a_full

            pend, inflight, res = inflight, None, None
            if pend is None:
                use_reuse = (
                    self.config.kv_prefix_reuse and memory_chunks == 1
                    and len(memory) == 1 and kv_cache is not None
                )
                with profiling.span("engine.prompt"):
                    if use_reuse:
                        carried = [t for m in memory for t in m[2]]
                        kept = trim_prefix_tokens(carried,
                                                  start + n_valid_cur + len(suffix_head))
                        suffix_tokens = suffix_head + kept
                        if i >= 2:
                            # only the header KV [0, n_pre) is carried; the memory
                            # audio re-prefills at its new positions with this chunk
                            ids, audio_mask = self._suffix_prompt_ids(a_full + n_valid_cur,
                                                                      suffix_tokens)
                            embd_in = torch.cat([memory[-1][0], audio_feature])
                            reuse = (kv_cache, n_pre)
                        else:
                            # chunk 1: [header | chunk-0 audio] KV is exact as-is
                            ids, audio_mask = self._suffix_prompt_ids(n_valid_cur,
                                                                      suffix_tokens)
                            embd_in, reuse = audio_feature, (kv_cache, start)
                    else:
                        ids, audio_mask, embd_in = full_prompt(i, audio_feature, cur["lang"],
                                                               detecting)
                        reuse = None
                if fast_ok:
                    pend = self._dispatch_chunk(ids, audio_mask, embd_in, temperature,
                                                reuse=reuse)
                    if is_last and pend is not None:
                        submit_spec_align(i, pend["packed"])
                    elif i == 0 and pend is not None and not detecting:
                        # chunk 0's window is fixed: its speculative align is
                        # queued behind block 0, before chunk 1's prefill
                        spec0_evt = submit_spec_align(i, pend["packed"], drop_last=rollback_num)
                if pend is None:  # a multi-block config, or the context is full
                    res, kv_cache = self._safe_decode(ids, audio_mask, embd_in, rollback_num,
                                                      is_last, temperature, reuse=reuse)

            # chunk i+1 queued before chunk i is read
            spec_next, spec_keep = None, 0
            if (pend is not None and not is_last and self.config.kv_prefix_reuse
                    and memory_chunks == 1 and (not detecting or cur["lang"])):
                next_samples = min(samples_per_chunk, total_len - (i + 1) * samples_per_chunk)
                n_valid_next = self.encoder.valid_tokens(next_samples)
                _, template = self._prompt_parts("", context, cur["lang"], detecting)
                budget = self.config.n_ctx - (start + n_valid_next + len(template)
                                              + self.generator.block)
                max_keep = min(self.generator.block, max(budget, 0))
                if max_keep > 0:
                    if spec0_evt is not None:
                        # keep the device order: chunk 0's speculative align
                        # before chunk 1's block (a wedged worker costs only order)
                        spec0_evt.wait(0.2)
                        spec0_evt = None
                    emitted = pend["packed"].emitted
                    if i + 1 >= 2:
                        # header-only KV carry; chunk i's audio re-prefills as
                        # chunk i+1's memory together with its own audio
                        spec_next = self._dispatch_chunk_spec(
                            template, emitted, torch.cat([audio_feature, wait_enc(i + 1)]),
                            n_audio=a_full + n_valid_next, start=n_pre,
                            cache=pend["state"].cache, temperature=temperature,
                            rollback=rollback_num, max_keep=max_keep)
                    else:
                        spec_next = self._dispatch_chunk_spec(
                            template, emitted, wait_enc(i + 1), n_audio=n_valid_next,
                            start=start, cache=pend["state"].cache, temperature=temperature,
                            rollback=rollback_num, max_keep=max_keep)
                    spec_keep = max_keep

            if res is None:
                res = self._collect_chunk(pend, rollback_num, is_last)
                if res.is_aborted:
                    # the breaker: drop the queued chunk i+1 and the
                    # speculative align of this token stream, and redo chunk
                    # i from its full prompt one step hotter (JAX engine.py:1170-1189)
                    spec_next = None
                    spec_aligns.pop(i, None)
                    res.text += "====decode aborted: repetition circuit breaker===="
                    if self.verbose:
                        print(f"\n\n[!] retrying with temperature {temperature + 0.3:.1f}\n")
                    with profiling.span("engine.prompt"):
                        ids_f, mask_f, embd_f = full_prompt(i, audio_feature, cur["lang"],
                                                            detecting)
                    res, kv_cache = self._safe_decode(ids_f, mask_f, embd_f, rollback_num,
                                                      is_last, temperature + 0.3)
                else:
                    n_keep_host = len(res.stable_tokens) if not is_last else 0
                    if spec_next is not None and n_keep_host <= spec_keep:
                        spec_next["n_prefill"] += n_keep_host
                        inflight, kv_cache = spec_next, None
                    elif spec_next is not None:
                        # the queued prompt kept a clipped tail: redo chunk
                        # i+1 on its still-valid header prefix (JAX :1191-1202)
                        kv_cache = spec_next["state"].cache
                    else:
                        kv_cache = pend["state"].cache

            if not res.is_aborted and i in spec_aligns:
                spec_aligns[i]["tokens"] = res.stable_tokens  # checked by the worker
            chunk_text = res.text
            mem_tokens = list(res.stable_tokens)
            if detecting and cur["lang"] is None:
                from ..text.parsing import parse_asr_output

                d_lang, body = parse_asr_output(chunk_text)
                segments[i].lang = d_lang
                chunk_text = body
                if d_lang:
                    cur["lang"] = d_lang
                if self.ID_ASR_TEXT in mem_tokens:
                    mem_tokens = mem_tokens[mem_tokens.index(self.ID_ASR_TEXT) + 1:]
            segments[i].text = chunk_text
            memory.append((audio_feature, chunk_text, mem_tokens))
            full_text += chunk_text
            stats["prefill_tokens"] += res.n_prefill
            stats["prefill_time"] += res.t_prefill
            stats["decode_tokens"] += res.n_generate
            stats["decode_time"] += res.t_generate

        if num_chunks:
            submit_align(num_chunks - 1)
        if align_pool is not None:
            try:
                for f in align_futs:
                    f.result()  # the worker's exceptions surface here
            finally:
                align_pool.shutdown()

        aligned_items.sort(key=lambda x: x.start_time)
        stats["encode_time"] = sum(enc.device_seconds(enc.seconds) for enc in encodes)
        stats["wait_time"] = sum(enc.seconds for enc in encodes)
        if self.verbose:
            self._print_stats(stats, total_duration, call.elapsed())
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
