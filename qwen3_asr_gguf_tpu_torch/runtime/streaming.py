"""Streaming ASR state machine.

Reproduces the official streaming recipe (reference
qwen_asr/inference/qwen3_asr.py:584-830 and tech report: 2 s chunks,
5-token rollback, first 4 chunks unprefixed):

- microphone PCM accumulates in a buffer; every full `chunk_size` seconds
  the WHOLE accumulated audio is re-fed through the encoder;
- the decode prompt is prefixed with the previous transcript rolled back by
  `unfixed_token_num` tokens (U+FFFD-safe), except during the first
  `unfixed_chunk_num` chunks which decode from scratch;
- `finish()` flushes the remaining tail without padding.

Spans (`utils.profiling`): `stream.feed` per feed,
inside it `stream.prefix` (the rolled-back prefix, its re-encode and trim),
`engine.encode` (a device span), `engine.prompt`, the decode's spans and
`stream.parse`; `stream.prewarm` around `prewarm`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..utils import profiling

SAMPLE_RATE = 16_000


@dataclasses.dataclass
class StreamingState:
    buffer: np.ndarray
    accum: np.ndarray
    text: str = ""
    fixed_prefix: str = ""
    tokens: List[int] = dataclasses.field(default_factory=list)
    language: str = ""
    chunks_seen: int = 0
    finished: bool = False


class StreamingTranscriber:
    def __init__(
        self,
        engine,
        *,
        chunk_size_sec: float = 2.0,
        unfixed_chunk_num: int = 4,
        unfixed_token_num: int = 5,
        context: str = "",
        language: Optional[str] = None,
        temperature: float = 0.0,
        max_audio_sec: float = 1200.0,
    ):
        self.engine = engine
        self.chunk_samples = int(chunk_size_sec * SAMPLE_RATE)
        self.unfixed_chunk_num = unfixed_chunk_num
        self.unfixed_token_num = unfixed_token_num
        self.context = context
        self.language = language
        self.temperature = temperature
        self.max_samples = int(max_audio_sec * SAMPLE_RATE)

    def init_state(self) -> StreamingState:
        """reference init_streaming_state (qwen3_asr.py:584-655)."""
        return StreamingState(
            buffer=np.zeros(0, np.float32), accum=np.zeros(0, np.float32)
        )

    # -- internals -----------------------------------------------------------

    def _prefix_text(self, state: StreamingState) -> str:
        """Rolled-back decode prefix (reference :731-747)."""
        if state.chunks_seen < self.unfixed_chunk_num:
            return ""
        toks = state.tokens[: -self.unfixed_token_num] if self.unfixed_token_num else state.tokens
        if not toks:
            return ""
        # keep special tokens: in auto mode the raw decode carries the
        # `language X<asr_text>` protocol tokens, and the official stack
        # re-feeds the RAW decode as the prefix (qwen3_asr.py:755-761)
        text = self.engine.model.decode(toks, skip_special=False)
        # U+FFFD guard: drop a trailing partial multibyte sequence
        return text.rstrip("�")

    def _decode_accum(
        self,
        state: StreamingState,
        temperature: float | None = None,
        max_new_tokens: int | None = None,
    ) -> None:
        """Decode the accumulated audio. `temperature`/`max_new_tokens`
        override the session settings for this call only — warmup uses them
        so a background prewarm never mutates state shared with a live
        feed() (both default to the session values)."""
        if state.accum.size < self.chunk_samples // 4:
            return
        with profiling.span("stream.prefix"):
            prefix_full = self._prefix_text(state)
        eng = self.engine
        # bucketed: the aligned encode fast path compiles one program per
        # EXACT length — a growing accumulation would load a new encoder
        # program every chunk (seconds each on a remote-runtime platform,
        # even compile-cache hits). Bucket-padded, a session runs O(log T)
        # encoder programs and prewarm's mel_bucket key matches reality.
        with profiling.span("engine.encode", device=getattr(eng, "device", None)):
            embd_padded = eng.encoder.encode_async(state.accum, bucketed=True)
        n_audio = eng.encoder.valid_tokens(int(state.accum.shape[-1]))
        # n_ctx budget: the decode PROMPT drops the oldest carried prefix
        # text if header + audio + prefix + generation headroom would
        # overflow (the official stack rides vLLM's large context,
        # qwen3_asr.py:731-747; a fixed-n_ctx engine must trim — same
        # policy as the engine's chunk loop). The transcript keeps
        # everything: the trimmed prefix is a suffix of the full one, so
        # the continuation still concatenates exactly.
        detect = self.language is None
        with profiling.span("stream.prefix"):
            headroom = min(eng.config.max_new_tokens, 256)
            header, suffix_head = eng._prompt_parts("", self.context, self.language, detect)
            budget = max(
                eng.config.n_ctx - headroom - len(header) - len(suffix_head) - n_audio, 0
            )
            ptoks_full = eng.model.encode(prefix_full) if prefix_full else []
            prefix = prefix_full
            if len(ptoks_full) > budget:
                kept = ptoks_full[len(ptoks_full) - budget:]
                prefix = eng.model.decode(kept, skip_special=False).lstrip("�") if kept else ""
        ids, mask = self.engine._build_prompt_ids(
            n_audio, prefix, self.context, self.language, detect
        )
        # pass the full bucket-shaped embedding: the audio_mask selects the
        # n_audio valid rows, so compile keys are (mel bucket, prompt bucket)
        # pairs instead of one per accumulated length
        res, _ = self.engine._safe_decode(
            ids, mask, embd_padded,
            rollback_num=0, is_last_chunk=True,
            temperature=self.temperature if temperature is None else temperature,
            max_new_tokens=max_new_tokens,
        )
        state.tokens = ptoks_full + res.stable_tokens
        state.fixed_prefix = prefix_full
        # per-step parse (official qwen3_asr.py:759-761): raw accumulated
        # decode -> (language, clean text); forced language passes through
        from ..text.parsing import parse_asr_output

        with profiling.span("stream.parse"):
            lang, txt = parse_asr_output(prefix_full + res.text, user_language=self.language)
        state.language = lang
        state.text = txt

    # -- public API ----------------------------------------------------------

    def prewarm(self, max_sec: float = 120.0, background: bool = False,
                prefix_tok_per_sec: float = 6.0):
        """Load every program a live session will hit, up to `max_sec` of
        accumulated audio, so a mic session never stalls on a first
        compile/program-load (VERDICT r1: streaming compile-shape churn).

        Coverage is exact, not heuristic: the compiled-program keys are
        (encoder mel bucket), (prefill prompt bucket) and (decode attention
        window, greedy) — the carried transcript prefix grows the live
        prompt past the empty-prefix bucket, so each accumulation level
        warms EVERY prompt bucket reachable with up to
        `prefix_tok_per_sec * seconds` carried tokens (tech report:
        2.4-3.8 emitted tok/s; 6 is a safe ceiling). Warm prompts pad with
        inert tokens — the programs key on shape, not content. Contiguous
        prompt buckets also cover every 256-slot decode window. Call before
        the first `feed`; with `background=True` returns the warming thread
        immediately."""
        from .generate import prompt_bucket

        def work():
            with profiling.span("stream.prewarm"):
                warm()

        def warm():
            # per-call overrides only — a background prewarm must not mutate
            # self.temperature / engine config shared with a live feed()
            eng = self.engine
            seen = set()
            n = self.chunk_samples
            detect = self.language is None
            while n <= int(max_sec * SAMPLE_RATE):
                frames = n // 160
                n_audio = eng.encoder.valid_tokens(n)
                ids, mask = eng._build_prompt_ids(
                    n_audio, "", self.context, self.language, detect
                )
                mel_b = eng.encoder.mel_bucket(frames)
                base = len(ids)
                headroom = min(eng.config.max_new_tokens, 256)
                max_len = min(
                    base + int(prefix_tok_per_sec * n / SAMPLE_RATE),
                    max(eng.config.n_ctx - headroom, base),
                )
                # warm lengths: the exact base length (covers the decode
                # window one 256-step below the first bucket top) plus the
                # TOP of every reachable prompt bucket — together these hit
                # every (prefill bucket, decode window) pair a live t in
                # [base, max_len] can produce (buckets are 128/256-spaced,
                # windows 256-spaced: at most one boundary between tops)
                lengths, b = [base], prompt_bucket(base)
                while b <= prompt_bucket(max_len) and b <= eng.config.n_ctx:
                    lengths.append(b)
                    b = prompt_bucket(b + 1)
                block = eng.generator.block
                embd = None
                for length in lengths:
                    # both sampling variants: greedy AND temperature>0
                    # (the circuit-breaker retry path escalates
                    # temperature — an unwarmed non-greedy program would
                    # stall a live session mid-retry)
                    for temp in dict.fromkeys((self.temperature, 0.4)):
                        win = -(-(length + block) // 256) * 256
                        key = (mel_b, prompt_bucket(length), win, temp > 0)
                        if key in seen:
                            continue
                        seen.add(key)
                        if embd is None:
                            embd = eng.encoder.encode_async(
                                np.zeros(n, np.float32), bucketed=True
                            )
                        pad = length - base
                        ids_w = np.concatenate(
                            [ids, np.full(pad, eng.ID_IM_END, np.int32)]
                        )
                        mask_w = np.concatenate([mask, np.zeros(pad, bool)])
                        eng._safe_decode(
                            ids_w, mask_w, embd, rollback_num=0,
                            is_last_chunk=True, temperature=temp,
                            max_new_tokens=1,
                        )
                n += self.chunk_samples

        if background:
            import threading

            th = threading.Thread(target=work, daemon=True)
            th.start()
            return th
        work()
        return None

    def feed(self, state: StreamingState, pcm: np.ndarray) -> StreamingState:
        """Append PCM; decode once per completed chunk (reference
        streaming_transcribe :657-765). Returns the updated state (in place)."""
        if state.finished:
            raise RuntimeError("stream already finished")
        with profiling.span("stream.feed"):
            state.buffer = np.concatenate([state.buffer,
                                           np.asarray(pcm, np.float32).reshape(-1)])
            while state.buffer.size >= self.chunk_samples:
                chunk, state.buffer = (
                    state.buffer[: self.chunk_samples],
                    state.buffer[self.chunk_samples :],
                )
                state.accum = np.concatenate([state.accum, chunk])
                if state.accum.size > self.max_samples:
                    state.accum = state.accum[-self.max_samples :]
                state.chunks_seen += 1
                self._decode_accum(state)
        return state

    def finish(self, state: StreamingState) -> str:
        """Flush the un-chunked tail (reference finish_streaming_transcribe
        :767-830) and return the final transcript."""
        if not state.finished:
            if state.buffer.size:
                state.accum = np.concatenate([state.accum, state.buffer])
                state.buffer = np.zeros(0, np.float32)
                state.chunks_seen += 1
                self._decode_accum(state)
            state.finished = True
        return state.text
