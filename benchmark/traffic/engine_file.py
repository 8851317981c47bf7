"""Offline transcription: back-to-back `QwenASREngine.asr` calls on clips of
`clip_s` seconds (signal from the seed, the same length for every seed),
each timed on the host clock from the call to its return after
`torch.cuda.synchronize()`. A call starts while the window is open and
runs to its end; the window closes after the last. A call is the traced
run's unit.

Params: clip_s, language, temperature, max_new_tokens, decode_block,
sample_calls (calls the reference checks).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import roofline, signals
from benchmark.reference import prompts
from benchmark.reference.check import tokenizer

WARM_SEED = 2**31 + 11


def token_ids(tok) -> dict:
    return {"im_start": tok.token_to_id("<|im_start|>"), "im_end": tok.token_to_id("<|im_end|>"),
            "audio_start": tok.token_to_id("<|audio_start|>"),
            "audio_end": tok.token_to_id("<|audio_end|>"),
            "asr_text": tok.token_to_id("<asr_text>")}


def record_decodes(engine, sink: list) -> None:
    """Record each chunk's DecodeResult as the engine's chunk loop takes it:
    `_collect_chunk` (a pipelined chunk) and `_safe_decode` (a synchronous
    chunk, or the redo of an aborted pipelined one, which replaces it)."""
    collect, safe = engine._collect_chunk, engine._safe_decode

    def collect_rec(*a, **k):
        res = collect(*a, **k)
        sink.append(("collect", res))
        return res

    def safe_rec(*a, **k):
        res, cache = safe(*a, **k)
        sink.append(("safe", res))
        return res, cache

    engine._collect_chunk, engine._safe_decode = collect_rec, safe_rec


def chunk_results(recs: list) -> list:
    out = []
    for kind, res in recs:
        if kind == "safe" and out and out[-1][0] == "collect" and out[-1][1].is_aborted:
            out[-1] = (kind, res)
        else:
            out.append((kind, res))
    return [res for _, res in out]


class Driver:
    def __init__(self, cell, ckpt, seed: int, device):
        self.cell, self.ckpt, self.seed, self.device = cell, ckpt, seed, torch.device(device)
        self.p, self.cfg = cell.params, cell.config
        self.recs: list = []
        self.calls: list = []

    def reset(self, seed: int) -> None:
        """Forget the window's records and draw later signals from `seed`."""
        self.seed, self.calls = seed, []

    def setup(self) -> None:
        from qwen3_asr_gguf_tpu_torch.runtime.engine import QwenASREngine
        from qwen3_asr_gguf_tpu_torch.schema import ASREngineConfig

        e, p = self.cfg["engine"], self.p
        cfg = ASREngineConfig(
            model_dir=str(self.ckpt), llm_fn="qwen3_asr_llm.q4_k.gguf",
            precision=e["precision"], kv_cache_dtype=e["kv_cache_dtype"], n_ctx=e["n_ctx"],
            chunk_size=e["chunk_size"], memory_num=e["memory_num"],
            kv_prefix_reuse=e["kv_prefix_reuse"], pipelined_dispatch=e["pipelined_dispatch"],
            max_new_tokens=p["max_new_tokens"], decode_block=p["decode_block"],
            verbose=False, **self.engine_options())
        self.engine = QwenASREngine(cfg, device=self.device)
        record_decodes(self.engine, self.recs)

    def engine_options(self) -> dict:
        """The engine's settings that a driver built on this one changes."""
        return {"enable_aligner": False}

    def _call(self, clip: np.ndarray) -> dict:
        e = self.cfg["engine"]
        del self.recs[:]
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        t0 = time.perf_counter()
        res = self.engine.asr(clip, context="", language=self.p["language"],
                              chunk_size_sec=e["chunk_size"], memory_chunks=e["memory_num"],
                              temperature=self.p["temperature"])
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        wall = time.perf_counter() - t0
        chunks = chunk_results(self.recs)
        return {"wall": wall, "audio": len(clip) / signals.SR, "perf": dict(res.performance),
                "chunks": [list(r.stable_tokens) for r in chunks],
                "n_prefill": [r.n_prefill for r in chunks],
                "n_generate": [r.n_generate for r in chunks]}

    def warm(self) -> None:
        self._call(signals.speech(WARM_SEED, 0, self.p["clip_s"]))

    def clip(self, k: int) -> np.ndarray:
        return signals.speech(self.seed, k, self.p["clip_s"])

    def run(self, seconds: float, tracer=None) -> dict:
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            clip = self.clip(k)
            if tracer is not None:
                tracer.before(k)
            self.calls.append(self._call(clip))
            if tracer is not None:
                tracer.after(k)
            k += 1
        window = time.perf_counter() - t0
        return self.summary(window)

    def summary(self, window: float) -> dict:
        calls = self.calls
        wall = sum(c["wall"] for c in calls)
        audio = sum(c["audio"] for c in calls)
        perf = {k: sum(c["perf"].get(k, 0.0) for c in calls)
                for k in ("decode_time", "decode_tokens", "prefill_tokens")}
        n_chunks = sum(len(c["chunks"]) for c in calls)
        return {
            "attempted": len(calls), "failed": 0, "window_s": window,
            "end_to_end": {"rtf": wall / audio if audio else None},
            "calls_wall_s": wall, "decode_time_s": perf["decode_time"],
            "decode_tokens": perf["decode_tokens"], "chunks": n_chunks,
        }

    def _prompt_lengths(self, clip_len: int, chunks: list) -> list[int]:
        tok = self._tok()
        jobs = self._jobs_for(np.zeros(clip_len, np.float32), chunks, tok)
        return [sum(len(p[1]) if p[0] == "ids" else p[2] for p in j["parts"]) for j in jobs]

    def works(self, units=None) -> list:
        """Roofline pieces of the window's calls, or of the calls `units`."""
        a, t = self.cfg["model"]["audio"], self.cfg["model"]["text"]
        chunk = int(self.cfg["engine"]["chunk_size"] * signals.SR)
        out = []
        for k in units if units is not None else range(len(self.calls)):
            c = self.calls[k]
            n = int(c["audio"] * signals.SR)
            lengths = self._prompt_lengths(n, c["chunks"])
            for plen, new, gen in zip(lengths, c["n_prefill"], c["n_generate"]):
                out.append(roofline.encode(a, prompts.rows_of(chunk), chunk // signals.SR))
                out.append(roofline.prefill(t, new, max(plen - new, 0)))
                w = roofline.decode_step(t, plen + (gen - 1) / 2)
                out.append(roofline.Work(w.flops * gen, w.bytes * gen, w.peak))
        return out

    def _tok(self):
        if not hasattr(self, "_tokenizer"):
            self._tokenizer = tokenizer(self.ckpt)
        return self._tokenizer

    def _jobs_for(self, clip, chunks, tok) -> list:
        e = self.cfg["engine"]
        return prompts.file_jobs(tok, token_ids(tok), clip, e["chunk_size"], chunks,
                                 self.p["language"], e["n_ctx"], self.p["max_new_tokens"])

    def picks(self, rng) -> list[int]:
        """The calls the reference checks: `sample_calls` drawn from the seed."""
        picks = rng.choice(len(self.calls), size=min(self.p["sample_calls"], len(self.calls)),
                           replace=False)
        return sorted(int(i) for i in picks)

    def jobs(self, rng) -> list:
        """The chunks of the calls `picks` draws."""
        tok = self._tok()
        out = []
        for k in self.picks(rng):
            out += self._jobs_for(self.clip(k), self.calls[k]["chunks"], tok)
        return out

    def close(self) -> None:
        self.engine.shutdown()
        del self.engine
