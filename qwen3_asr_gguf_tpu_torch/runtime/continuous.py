"""Continuous batching: per-request admission into free rows of a persistent
batched decode loop (counterpart of `qwen3_asr_gguf_tpu/runtime/continuous.py`).

A decode worker thread keeps `max_batch` KV-cache rows and runs blocks of
`forward_step_rows` over all of them: one token per row per step, every
quantized weight streamed once per step for all rows (the q4_k multi-row
kernel at a batch of 8 to 64, a multiple of 8), per-row temperature and
greedy sampling, EOS latches kept on the device, and ONE device-to-host
fetch per block. An admission thread takes queued requests in cohorts of
up to 16: it encodes same-shape chunks as one batch, builds each prompt,
prefills it into a staging cache and samples its first token. Between
blocks the worker scatters staged lanes into free rows. Long audio runs as
successive chunks with memory (the previous chunk's audio embeddings and
stable tokens lead the next chunk's prompt), each chunk its own row
session, as the engine's chunk loop does.

Both threads queue their device work on the device's default stream, so
a staging prefill is complete on the device before the scatter that reads
it. The flow is synchronous: a block is fetched before the next is queued
(the JAX package's 1-deep block pipeline is not ported; it gives the same
tokens). Not ported (see ROADMAP.md): the tensor-parallel and vmapped
bodies, `prewarm`, the align pool (timestamps wait for the aligner) and the
trace switch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import decoder as dec
from ..ops.sampling import sample_rows
from ..schema import TranscribeResult
from .generate import prompt_bucket, round_up

SAMPLE_RATE = 16_000


@dataclass
class _Request:
    audio: np.ndarray
    context: str
    language: Optional[str]
    temperature: float
    rollback: int = 5  # tokens trimmed from a non-final chunk
    done_evt: threading.Event = field(default_factory=threading.Event)
    result: Optional[TranscribeResult] = None
    error: Optional[Exception] = None
    submitted_at: float = field(default_factory=time.time)
    # long-audio chunk state: memory carries the previous chunk's encoder
    # feature and stable tokens into the next chunk's prompt
    chunk_idx: int = 0
    n_chunks: int = 1
    chunk_texts: List[str] = field(default_factory=list)
    # auto language (language=None): the detection prompt runs until a
    # language parses; it then leads later chunk prompts
    detected_lang: Optional[str] = None
    mem_feature: Optional[torch.Tensor] = None  # [a, D] on the device
    mem_tokens: List[int] = field(default_factory=list)
    cur_feature: Optional[torch.Tensor] = None  # this chunk's feature (next memory)


@dataclass
class _Row:
    req: Optional[_Request] = None
    tokens: List[int] = field(default_factory=list)
    pos: int = 0


@dataclass
class _Cohort:
    """A staged admission: per-lane prefilled KV and first tokens on the
    device, and the host data the scatter needs."""

    staged: dict  # cache lists of [P, t_pad, ...]
    toks: torch.Tensor  # [P] first tokens
    reqs: List[_Request]
    lens: List[int]  # prompt lengths
    t_pad: int
    next_lane: int = 0


class ContinuousBatcher:
    COHORT_MAX = 16  # requests per staged admission
    STAGE_SLOTS = 2  # staged-but-unscattered cohorts in flight
    FILL_GATE_S = 1.0  # cap of the fill gate (see _loop)

    def __init__(self, engine, *, max_batch: int = 8, block: int = 16,
                 max_new_tokens: Optional[int] = None):
        self.engine = engine
        self.cfg = engine.dec_cfg
        self.device = engine.device
        gen = engine.generator
        # prefill runs on the prefill-side weights (dense bf16 for int4);
        # decode streams the engine's decode weights through the rows kernels
        self.params = gen.prefill_params
        self.dec_params = gen.params
        self.n_ctx = engine.config.n_ctx
        self.b = max_batch
        self.block = block
        self.max_new_tokens = max_new_tokens or engine.config.max_new_tokens
        self.eos = frozenset(int(e) for e in engine.thinker.eos_token_ids)
        self.eos_dev = torch.tensor(sorted(self.eos), dtype=torch.int64, device=self.device)
        self.chunk_samples = int(engine.config.chunk_size * SAMPLE_RATE)
        self.cohort_max = min(self.COHORT_MAX, max_batch)
        # the engine's KV dtype: an f32 engine serves with f32 KV, so its
        # greedy tokens equal the sequential engine's
        self.kv_dtype = gen.cache_dtype

        # device state, owned by the decode worker. The row caches hold
        # n_ctx slots rounded up to the 256-slot window buckets, so every
        # attention window is a whole number of the rows kernel's tiles;
        # positions stay below n_ctx and the slots past it are never attended
        self.s_cache = round_up(self.n_ctx, 256)
        self.caches = dec.init_cache(self.cfg, self.s_cache, self.kv_dtype, device=self.device,
                                     rows=self.b)
        self.toks = torch.zeros(self.b, dtype=torch.int64, device=self.device)
        self.dones_dev = torch.ones(self.b, dtype=torch.bool, device=self.device)
        seed = int(np.random.randint(0, 2**31 - 2))
        self._rng_decode = torch.Generator(device=self.device)
        self._rng_decode.manual_seed(seed)
        self._rng_admit = torch.Generator(device=self.device)  # admission thread's own
        self._rng_admit.manual_seed(seed + 1)
        # host mirrors
        self.rows = [_Row() for _ in range(self.b)]
        self.poss = np.zeros(self.b, np.int64)
        self.temps = np.full(self.b, 1e-6, np.float32)
        self.greedy = np.ones(self.b, bool)
        self.dones = np.ones(self.b, bool)  # free rows stay "done"
        self.row_gen = np.zeros(self.b, np.int64)  # bumped at every retire

        self._pending: List[_Request] = []
        self._ready: List[_Cohort] = []
        self._n_staging = 0  # cohorts mid-staging on the admission thread
        self._lock = threading.Lock()
        self._work = threading.Event()  # decode worker wake
        self._admit_work = threading.Event()  # admission thread wake
        self._stage_slots = threading.Semaphore(self.STAGE_SLOTS)
        self._stop = False
        self.n_admitted = 0
        self.n_completed = 0
        self._t_admit = 0.0  # admission thread: host + queueing time
        self._t_admit_enc = 0.0  # ... encode and prompt share
        self._t_admit_prefill = 0.0  # ... staging prefill share
        self._t_scatter = 0.0  # worker: scattering staged cohorts
        self._t_dispatch = 0.0  # worker: queueing decode blocks
        self._t_fetch = 0.0  # worker: waiting on a block's result
        self._n_blocks = 0
        self._n_cohorts = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._admit_thread = threading.Thread(target=self._admit_loop, daemon=True)
        self._admit_thread.start()

    # -- public API ----------------------------------------------------------

    def eligible(self, audio: np.ndarray) -> bool:
        """Long audio runs as successive chunks; the only cap is the
        reference's 1200 s input limit."""
        return len(audio) <= 1200 * SAMPLE_RATE

    @property
    def supports_timestamps(self) -> bool:
        """False until the forced aligner is ported (ROADMAP Queue 1)."""
        return False

    def submit(self, audio: np.ndarray, *, context: str = "", language: Optional[str] = None,
               temperature: float = 0.0, timeout: float = 600.0,
               rollback: int = 5) -> TranscribeResult:
        n_chunks = max(1, int(np.ceil(len(audio) / self.chunk_samples)))
        req = _Request(audio=audio, context=context, language=language,
                       temperature=temperature, n_chunks=n_chunks, rollback=rollback)
        with self._lock:
            self._pending.append(req)
        self._admit_work.set()
        if not req.done_evt.wait(timeout):
            raise TimeoutError("transcription timed out in continuous batch queue")
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    def close(self) -> None:
        self._stop = True
        self._work.set()
        self._admit_work.set()
        self._stage_slots.release()  # unblock an admission thread in acquire
        self._thread.join(timeout=5.0)
        self._admit_thread.join(timeout=5.0)

    @property
    def stats(self) -> dict:
        return {
            "admitted": self.n_admitted,
            "completed": self.n_completed,
            "active_rows": sum(1 for r in self.rows if r.req is not None),
            "queued": len(self._pending),
            "t_admit": round(self._t_admit, 3),
            "t_admit_enc": round(self._t_admit_enc, 3),
            "t_admit_prefill": round(self._t_admit_prefill, 3),
            "t_scatter": round(self._t_scatter, 3),
            "t_dispatch": round(self._t_dispatch, 3),
            "t_fetch": round(self._t_fetch, 3),
            "n_blocks": self._n_blocks,
            "n_cohorts": self._n_cohorts,
        }

    # -- admission (admission thread) -----------------------------------------

    def _chunk_audio(self, req: _Request) -> np.ndarray:
        from ..audio.mel import HOP

        s = req.chunk_idx * self.chunk_samples
        chunk = req.audio[s: s + self.chunk_samples]
        if len(chunk) < HOP:  # sub-hop tail chunk: pad to one mel frame
            chunk = np.pad(np.asarray(chunk), (0, HOP - len(chunk)))
        return chunk

    def _build_admission(self, req: _Request, chunk: np.ndarray, cur: torch.Tensor):
        """(ids, mask, embeddings) of the request's current chunk (`cur` is
        its encoder output). Chunk 0 is the plain prompt; later chunks carry
        the previous chunk's audio feature and stable tokens. Raises
        ValueError on an n_ctx overflow."""
        eng = self.engine
        n_valid = eng.encoder.valid_tokens(len(chunk))
        if req.chunk_idx + 1 < req.n_chunks:
            req.cur_feature = cur[:n_valid]  # the next chunk's memory
        detecting = req.language is None  # live on every chunk until a language parses
        if req.chunk_idx == 0:
            ids, mask = eng._build_prompt_ids(n_valid, "", req.context, req.language,
                                              detect_language=detecting)
            if len(ids) > self.n_ctx:
                raise ValueError(f"prompt of {len(ids)} tokens exceeds n_ctx={self.n_ctx}")
            return ids, mask, cur
        lang = req.language or req.detected_lang
        hdr, template = eng._prompt_parts("", req.context, lang, detecting)
        n_audio = int(req.mem_feature.shape[0]) + n_valid
        # drop the OLDEST carried tokens on overflow (the engine's trim)
        budget = self.n_ctx - min(self.max_new_tokens, 256)
        overflow = len(hdr) + n_audio + len(template) + len(req.mem_tokens) - budget
        kept = req.mem_tokens[max(overflow, 0):] if overflow < len(req.mem_tokens) else []
        suffix = template + kept
        total = len(hdr) + n_audio + len(suffix)
        if total > self.n_ctx:
            raise ValueError(f"chunk prompt of {total} tokens exceeds n_ctx={self.n_ctx} "
                             f"(40 s chunks with memory need n_ctx >= 2048)")
        ids = np.zeros(total, dtype=np.int32)
        ids[: len(hdr)] = hdr
        ids[len(hdr) + n_audio:] = suffix
        mask = np.zeros(total, dtype=bool)
        mask[len(hdr): len(hdr) + n_audio] = True
        return ids, mask, torch.cat([req.mem_feature, cur[:n_valid]])

    def _encode(self, chunks: list) -> list:
        """Encoder outputs of the chunks; same-`batch_key` chunks encode as
        one batch."""
        enc = self.engine.encoder
        curs: list = [None] * len(chunks)
        groups: dict = {}
        for i, c in enumerate(chunks):
            groups.setdefault(enc.batch_key(c), []).append(i)
        for idxs in groups.values():
            if len(idxs) > 1:
                outs = enc.encode_batch_async([chunks[i] for i in idxs])
            else:
                outs = [enc.encode_async(chunks[idxs[0]])]
            for i, o in zip(idxs, outs):
                curs[i] = o
        return curs

    def _stage_cohort(self, reqs: list) -> Optional[_Cohort]:
        """Encode, build and prefill up to COHORT_MAX requests into a
        staging cache, and sample their first tokens. Each lane prefills as
        the sequential engine does (its prompt padded to its own bucket,
        padding keys masked), so a greedy lane's tokens equal the engine's.
        A request whose prompt overflows n_ctx fails alone."""
        t0 = time.time()
        chunks = [self._chunk_audio(r) for r in reqs]
        kept = []
        for req, chunk, cur in zip(reqs, chunks, self._encode(chunks)):
            try:
                kept.append((req, *self._build_admission(req, chunk, cur)))
            except ValueError as e:
                req.error = e
                req.done_evt.set()
        self._t_admit_enc += time.time() - t0
        if not kept:
            return None
        t1 = time.time()
        gen, cfg, params = self.engine.generator, self.cfg, self.params
        lens = [len(ids) for _, ids, _, _ in kept]
        t_pad = min(max(prompt_bucket(t) for t in lens), self.n_ctx)
        staged = dec.init_cache(cfg, t_pad, self.kv_dtype, device=self.device, rows=len(kept))
        last = []
        for lane, (req, ids, mask, embd) in enumerate(kept):
            t = lens[lane]
            ids_p, mask_p = gen._padded_prompt(ids, mask, min(prompt_bucket(t), self.n_ctx))
            x = dec.splice_prompt(params, ids_p, mask_p, embd)
            lane_cache = {name: [c[lane] for c in cs] for name, cs in staged.items()}
            hidden, _ = dec.forward_prefill(params, cfg, x, lane_cache, length=t)
            last.append(dec.lm_logits(params, hidden[t - 1], cfg.lm_head_dim))
        reqs = [k[0] for k in kept]
        p = len(reqs)
        dev = self.device
        toks, _, _ = sample_rows(
            torch.stack(last), self._rng_admit,
            torch.tensor([max(r.temperature, 1e-6) for r in reqs], device=dev),
            torch.tensor([r.temperature <= 0.0 for r in reqs], device=dev),
            torch.zeros(p, dtype=torch.bool, device=dev),
            torch.zeros(p, dtype=torch.int64, device=dev), self.eos_dev,
        )
        self._t_admit_prefill += time.time() - t1
        return _Cohort(staged=staged, toks=toks, reqs=reqs, lens=lens, t_pad=t_pad)

    def _admit_loop(self) -> None:
        """Admission thread: prompt work, encode and staging prefill, beside
        the decode worker; bounded by `_stage_slots`."""
        while not self._stop:
            with self._lock:
                take = min(len(self._pending), self.cohort_max)
                reqs = [self._pending.pop(0) for _ in range(take)]
            if not reqs:
                self._admit_work.wait(timeout=0.5)
                self._admit_work.clear()
                continue
            with self._lock:
                self._n_staging += 1
            self._stage_slots.acquire()
            if self._stop:
                # close() raced the slot wait: fail the popped requests now
                err = RuntimeError("batcher closed while staging admission")
                for req in reqs:
                    if not req.done_evt.is_set():
                        req.error = err
                        req.done_evt.set()
                return
            t0 = time.time()
            cohort = None
            try:
                cohort = self._stage_cohort(reqs)
            except Exception as e:
                for req in reqs:
                    if not req.done_evt.is_set():
                        req.error = e
                        req.done_evt.set()
            self._t_admit += time.time() - t0
            self._n_cohorts += 1
            with self._lock:
                self._n_staging -= 1
                if cohort is not None:
                    self._ready.append(cohort)
            if cohort is None:
                self._stage_slots.release()
            else:
                self._work.set()

    # -- decode worker --------------------------------------------------------

    def _drain_ready(self) -> None:
        """Scatter staged cohort lanes into free rows (the worker is the only
        writer of the live caches and row state)."""
        while True:
            with self._lock:
                free = [i for i, r in enumerate(self.rows) if r.req is None]
                if not self._ready or not free:
                    return
                cohort = self._ready[0]
                n = min(len(free), len(cohort.reqs) - cohort.next_lane)
                lanes = list(range(cohort.next_lane, cohort.next_lane + n))
                rows = free[:n]  # every lane and row is in range: nothing to drop
                cohort.next_lane += n
                finished = cohort.next_lane >= len(cohort.reqs)
                if finished:
                    self._ready.pop(0)
            t0 = time.time()
            rows_t = torch.tensor(rows, device=self.device)
            lanes_t = torch.tensor(lanes, device=self.device)
            for name, live in self.caches.items():
                for c, st in zip(live, cohort.staged[name]):
                    c[rows_t, : cohort.t_pad] = st[lanes_t]
            self.toks[rows_t] = cohort.toks[lanes_t]
            self.dones_dev[rows_t] = False
            for lane, row_idx in zip(lanes, rows):
                req = cohort.reqs[lane]
                row = self.rows[row_idx]
                row.req = req
                row.tokens = []
                row.pos = cohort.lens[lane]
                self.poss[row_idx] = cohort.lens[lane]
                self.temps[row_idx] = max(req.temperature, 1e-6)
                self.greedy[row_idx] = req.temperature <= 0.0
                self.dones[row_idx] = False
                self.n_admitted += 1
            self._t_scatter += time.time() - t0
            if finished:
                self._stage_slots.release()

    def _decode_block(self, poss: np.ndarray, temps: np.ndarray, greedy: np.ndarray,
                      host_dones: np.ndarray, win: int) -> torch.Tensor:
        """Queue `block` rows steps over all rows; returns the device
        [B, block + 1] result: the tokens fed (-1 once a row is done) and
        the done latches. The host arrays are snapshots: a blocking copy of
        a buffer the loop mutates afterwards would race a non_blocking one."""
        dev = self.device
        poss_d = torch.from_numpy(poss).to(dev)
        temps_d = torch.from_numpy(temps).to(dev)
        greedy_d = torch.from_numpy(greedy).to(dev)
        dones = self.dones_dev | torch.from_numpy(host_dones).to(dev)
        toks = self.toks
        params, cfg = self.dec_params, self.cfg
        emitted = []
        for _ in range(self.block):
            hidden, _ = dec.forward_step_rows(
                params["layers"], params["final_norm"], cfg, dec.embed_tokens(params, toks),
                self.caches, torch.clamp(poss_d, max=self.n_ctx - 1), attn_window=win)
            logits = dec.lm_logits(params, hidden, cfg.lm_head_dim)
            toks, dones, em = sample_rows(logits, self._rng_decode, temps_d, greedy_d, dones,
                                          toks, self.eos_dev)
            emitted.append(em)
            poss_d = poss_d + 1
        self.toks, self.dones_dev = toks, dones
        return torch.cat([torch.stack(emitted, dim=1), dones[:, None].to(torch.int64)], dim=1)

    def _retire(self, row_idx: int) -> None:
        row = self.rows[row_idx]
        req = row.req
        assert req is not None
        eng = self.engine
        toks = [t for t in row.tokens[: self.max_new_tokens] if t not in self.eos]
        row.req = None
        self.dones[row_idx] = True
        self.row_gen[row_idx] += 1  # invalidates lanes of a block in flight
        still_detecting = req.language is None and req.detected_lang is None

        def parse_detect(text: str, tokens: list) -> tuple[str, list]:
            """Strip ``language X<asr_text>`` from the text and the carried
            tokens; record the language for later chunks."""
            from ..text.parsing import parse_asr_output

            d_lang, body = parse_asr_output(text)
            if d_lang:
                req.detected_lang = d_lang
            if eng.ID_ASR_TEXT in tokens:
                tokens = tokens[tokens.index(eng.ID_ASR_TEXT) + 1:]
            return body, tokens

        if req.chunk_idx + 1 < req.n_chunks:
            # non-final chunk: trim the rollback tail from the text and the
            # carried tokens, and queue the next chunk with this memory
            stable = toks[: max(0, len(toks) - req.rollback)]
            text = eng.model.decode(stable)
            if still_detecting:
                text, stable = parse_detect(text, stable)
            req.chunk_texts.append(text)
            req.mem_tokens = stable
            req.mem_feature = req.cur_feature
            req.cur_feature = None
            req.chunk_idx += 1
            with self._lock:
                self._pending.append(req)
            self._admit_work.set()
            return

        text_final = eng.model.decode(toks)
        if still_detecting:
            text_final, _ = parse_detect(text_final, toks)
        req.chunk_texts.append(text_final)
        self.n_completed += 1
        req.result = TranscribeResult(
            text="".join(req.chunk_texts),
            performance={"batched": "continuous", "n_generate": len(row.tokens),
                         "n_chunks": req.n_chunks,
                         "latency_s": time.time() - req.submitted_at},
            language=req.language or req.detected_lang or "",
        )
        req.done_evt.set()

    def _process_block(self, packed: np.ndarray, snapshot: list) -> None:
        """Take a fetched block's tokens into its rows and retire finished
        rows. `snapshot` is [(row, generation)] at dispatch: a row retired
        since then has a new generation and its lane is skipped."""
        for i, gen in snapshot:
            row = self.rows[i]
            if self.row_gen[i] != gen or row.req is None:
                continue
            row.tokens.extend(int(t) for t in packed[i, :-1] if t >= 0)
            out_of_budget = (len(row.tokens) >= self.max_new_tokens
                             or row.pos + len(row.tokens) + self.block >= self.n_ctx)
            if bool(packed[i, -1]) or out_of_budget:
                self._retire(i)

    def _fail_active(self, err: Exception) -> None:
        """A decode block failed: fail its requests instead of leaving them
        waiting, and free their rows."""
        for i, row in enumerate(self.rows):
            if row.req is not None:
                row.req.error = err
                row.req.done_evt.set()
                row.req = None
                self.dones[i] = True
                self.row_gen[i] += 1

    def _loop(self) -> None:
        while not self._stop:
            self._drain_ready()
            active = [i for i, r in enumerate(self.rows) if r.req is not None]
            if not active:
                with self._lock:
                    if not self._pending and not self._ready:
                        self._work.clear()
                self._work.wait(timeout=0.5)
                continue

            # fill gate: a block costs about as much with a few active rows
            # as with all of them, so while admissions are in flight and rows
            # are free, let staging land (capped at FILL_GATE_S); a lone
            # request with nothing queued behind it never waits here
            if len(active) < self.b:
                t_gate = time.time()
                while len(active) < self.b and time.time() - t_gate < self.FILL_GATE_S:
                    with self._lock:
                        inflow = bool(self._pending or self._ready) or self._n_staging > 0
                    if not inflow:
                        break
                    time.sleep(0.004)  # a plain sleep: the admission thread needs the host
                    self._drain_ready()
                    active = [i for i, r in enumerate(self.rows) if r.req is not None]

            # attention window: the deepest active row, in 256-slot buckets
            win = min(self.s_cache, round_up(int(max(self.poss[i] for i in active)) + self.block,
                                             256))
            # idle rows still run (the batch is always max_batch wide); they
            # sit at slot 0, a valid slot that the next admission overwrites
            poss = np.zeros(self.b, np.int64)
            poss[active] = self.poss[active]
            t0 = time.time()
            try:
                packed_dev = self._decode_block(poss, self.temps.copy(), self.greedy.copy(),
                                                self.dones.copy(), win)
                t1 = time.time()
                packed = packed_dev.cpu().numpy()  # ONE fetch per block
            except Exception as e:  # a failed launch: nothing else can run
                self._fail_active(e)
                continue
            self._t_dispatch += t1 - t0
            self._t_fetch += time.time() - t1
            self._n_blocks += 1
            for i in active:
                self.poss[i] += self.block
            self._process_block(packed, [(i, int(self.row_gen[i])) for i in active])
