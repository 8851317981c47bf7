"""Live captions: one `StreamingTranscriber` session after another, each
`session_s` seconds of audio (signal from the seed) fed in `chunk_s`
pieces back to back, a closed loop. Every `feed` is timed on the host clock
from the call to its return with the updated text. Feeds go on while the
window is open; the session in flight at its close stops after the feed
that ends it, so that every run holds the same whole sessions and about the
same part of one more. A feed is the traced run's unit, counted over the
window's sessions.

Params: session_s, chunk_s, unfixed_chunk_num, unfixed_token_num, language,
temperature, max_new_tokens, decode_block, sample_feeds (feeds the reference
checks, the longest always among them).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import roofline, signals
from benchmark.reference import prompts
from benchmark.reference.check import tokenizer
from benchmark.traffic.engine_file import token_ids

WARM_SEED = 2**31 + 13


class Driver:
    def __init__(self, cell, ckpt, seed: int, device):
        self.cell, self.ckpt, self.seed, self.device = cell, ckpt, seed, torch.device(device)
        self.p, self.cfg = cell.params, cell.config
        self.sessions: list = []  # per session: {"k", "feeds": [(latency, tokens)]}
        self.decodes: list = []

    def reset(self, seed: int) -> None:
        """Forget the window's records and draw later signals from `seed`."""
        self.seed, self.sessions = seed, []
        del self.decodes[:]

    def setup(self) -> None:
        from qwen3_asr_gguf_tpu_torch.runtime.engine import QwenASREngine
        from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber
        from qwen3_asr_gguf_tpu_torch.schema import ASREngineConfig

        e, p = self.cfg["engine"], self.p
        cfg = ASREngineConfig(
            model_dir=str(self.ckpt), llm_fn="qwen3_asr_llm.q4_k.gguf",
            precision=e["precision"], kv_cache_dtype=e["kv_cache_dtype"], n_ctx=e["n_ctx"],
            chunk_size=e["chunk_size"], memory_num=e["memory_num"],
            kv_prefix_reuse=e["kv_prefix_reuse"], pipelined_dispatch=e["pipelined_dispatch"],
            max_new_tokens=p["max_new_tokens"], decode_block=p["decode_block"],
            enable_aligner=False, verbose=False)
        self.engine = QwenASREngine(cfg, device=self.device)
        self.st = StreamingTranscriber(
            self.engine, chunk_size_sec=p["chunk_s"], unfixed_chunk_num=p["unfixed_chunk_num"],
            unfixed_token_num=p["unfixed_token_num"], language=p["language"],
            temperature=p["temperature"])
        safe = self.engine._safe_decode

        def safe_rec(*a, **k):
            res, cache = safe(*a, **k)
            self.decodes.append(res)
            return res, cache

        self.engine._safe_decode = safe_rec

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _session(self, pcm: np.ndarray, tracer=None, unit: int = 0,
                 deadline: float = float("inf")) -> list:
        """[(latency, tokens after the feed)] of one session, fed until its
        end or the host clock's `deadline`; its feeds are the units `unit`,
        `unit + 1`, ... of the window."""
        n = int(self.p["chunk_s"] * signals.SR)
        state = self.st.init_state()
        feeds = []
        for i in range(0, len(pcm), n):
            if time.perf_counter() >= deadline:
                break
            if tracer is not None:
                tracer.before(unit + len(feeds))
            t0 = time.perf_counter()
            state = self.st.feed(state, pcm[i:i + n])
            self._sync()
            feeds.append((time.perf_counter() - t0, list(state.tokens)))
            if tracer is not None:
                tracer.after(unit + len(feeds) - 1)
        return feeds

    def warm(self) -> None:
        """Every encoder bucket and prompt length a session meets (the
        port's prewarm), then the first `warm_s` seconds of a session on
        other audio through the whole feed path."""
        self.st.prewarm(max_sec=self.p["session_s"])
        self._session(signals.speech(WARM_SEED, 0, self.p["warm_s"]))
        del self.decodes[:]

    def run(self, seconds: float, tracer=None) -> dict:
        t0 = time.perf_counter()
        k = unit = 0
        while time.perf_counter() - t0 < seconds:
            pcm = signals.speech(self.seed, k, self.p["session_s"])
            self.sessions.append({"k": k, "feeds": self._session(pcm, tracer, unit,
                                                                 t0 + seconds)})
            unit += len(self.sessions[-1]["feeds"])
            k += 1
        window = time.perf_counter() - t0
        lat = [f[0] for s in self.sessions for f in s["feeds"]]
        gen_t = sum(r.t_generate for r in self.decodes)
        gen_n = sum(r.n_generate for r in self.decodes)
        return {
            "attempted": len(lat), "failed": 0, "window_s": window,
            "end_to_end": {"stream_chunk_latency_p90_s":
                           float(np.percentile(lat, 90)) if lat else None},
            "feed_latencies": lat, "decode_time_s": gen_t, "decode_tokens": gen_n,
        }

    def _jobs(self, s: dict) -> list:
        e, p = self.cfg["engine"], self.p
        tok = self._tok()
        pcm = signals.speech(self.seed, s["k"], p["session_s"])
        return prompts.stream_jobs(tok, token_ids(tok), pcm, p["chunk_s"],
                                   [f[1] for f in s["feeds"]], p["language"], e["n_ctx"],
                                   p["max_new_tokens"], p["unfixed_chunk_num"],
                                   p["unfixed_token_num"])

    def _tok(self):
        if not hasattr(self, "_tokenizer"):
            self._tokenizer = tokenizer(self.ckpt)
        return self._tokenizer

    def works(self, units=None) -> list:
        """Roofline pieces of the window's feeds, or of the feeds `units`."""
        a, t = self.cfg["model"]["audio"], self.cfg["model"]["text"]
        want = None if units is None else set(units)
        out, unit = [], 0
        for s in self.sessions:
            jobs = self._jobs(s) if want is None or want & set(
                range(unit, unit + len(s["feeds"]))) else []
            for i, job in enumerate(jobs):
                if want is not None and unit + i not in want:
                    continue
                plen = sum(len(pt[1]) if pt[0] == "ids" else pt[2] for pt in job["parts"])
                rows = job["parts"][1][2]
                secs = len(job["parts"][1][1]) // signals.SR
                gen = len(job["served"] or [])
                out.append(roofline.encode(a, rows, secs))
                out.append(roofline.prefill(t, plen))
                if gen:
                    w = roofline.decode_step(t, plen + (gen - 1) / 2)
                    out.append(roofline.Work(w.flops * gen, w.bytes * gen, w.peak))
            unit += len(s["feeds"])
        return out

    def jobs(self, rng) -> list:
        """`sample_feeds` feeds drawn from the seed, the last feed of the
        longest session among them."""
        every = [(si, fi) for si, s in enumerate(self.sessions) for fi in range(len(s["feeds"]))]
        if not every:
            return []
        longest = max(every, key=lambda sf: (sf[1], -sf[0]))
        rest = [sf for sf in every if sf != longest]
        n = min(self.p["sample_feeds"] - 1, len(rest))
        picks = {longest} | {rest[i] for i in rng.choice(len(rest), size=n, replace=False)}
        out = []
        for si in sorted({si for si, _ in picks}):
            jobs = self._jobs(self.sessions[si])
            out += [jobs[fi] for s2, fi in sorted(picks) if s2 == si]
        return out

    def close(self) -> None:
        del self.st, self.engine
