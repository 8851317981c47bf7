"""`engine_file`'s offline transcription on a DeepSeek-V3 decoder
(`architectures/mla_moe.py`): the same back-to-back `QwenASREngine.asr`
calls, clips, chunks and prompts; the roofline pieces are
`roofline_mla_moe.py`'s, and the summary adds, per call, the least time of
its expert work (kernel 8's: `expert_least_s`, read by `expert_roofline`)
and the number of routed experts (`moe_experts`, read by `expert_load`).

Each call keeps how many prefills and decode steps it ran (the port's
`decode.prefill` span count and `decode.steps` counter), and each sampled
job a "route_plan" by which the architecture's routing tap finds the
port's expert choices for the job's rows. The reference checks a call
whose chunks each ran one prefill and one whole block (a chunk redone after
a tripped breaker, or a block that latched early, is not mapped); the
draw is among such calls.

Params: engine_file's.
"""

from __future__ import annotations

from benchmark import roofline, signals
from benchmark import roofline_mla_moe as rmm
from benchmark.architectures.mla_moe import text_config
from benchmark.reference import prompts
from benchmark.traffic.engine_file import Driver as FileDriver


class Driver(FileDriver):
    def _text(self) -> dict:
        return text_config(self.cfg)

    def _call(self, clip) -> dict:
        from qwen3_asr_gguf_tpu_torch.utils.profiling import TRACER

        before = (TRACER.counts.get("decode.prefill", 0), TRACER.counters.get("decode.steps", 0))
        out = super()._call(clip)
        out["forwards"] = (TRACER.counts.get("decode.prefill", 0) - before[0],
                           TRACER.counters.get("decode.steps", 0) - before[1])
        return out

    def _mapped(self, c: dict) -> bool:
        return c["forwards"] == (len(c["chunks"]), len(c["chunks"]) * self.p["decode_block"])

    def picks(self, rng) -> list[int]:
        """`sample_calls` drawn from the seed among the calls whose routing
        the tap's record maps (all of them, unless a chunk was redone)."""
        pool = [k for k, c in enumerate(self.calls) if self._mapped(c)] or list(
            range(len(self.calls)))
        picks = rng.choice(len(pool), size=min(self.p["sample_calls"], len(pool)), replace=False)
        return sorted(pool[int(i)] for i in picks)

    def jobs(self, rng) -> list:
        t = self._text()
        tok = self._tok()
        out = []
        for k in self.picks(rng):
            c = self.calls[k]
            jobs = self._jobs_for(self.clip(k), c["chunks"], tok)
            lengths = [sum(len(p[1]) if p[0] == "ids" else p[2] for p in j["parts"]) for j in jobs]
            plan = {"prior": [self.calls[j]["forwards"] for j in range(k)],
                    "n_moe": t["num_layers"] - t["first_k_dense_replace"],
                    "block": self.p["decode_block"], "P": lengths,
                    "start": [n - new for n, new in zip(lengths, c["n_prefill"])]}
            for i, job in enumerate(jobs):
                job["route_plan"] = dict(plan, chunk=i)
            out += jobs
        return out

    def summary(self, window: float) -> dict:
        out = super().summary(window)
        step = rmm.expert_step(self._text())
        out["expert_least_s"] = [sum(c["n_generate"]) * step.seconds()[0] for c in self.calls]
        out["moe_experts"] = self._text()["n_routed_experts"]
        return out

    def works(self, units=None) -> list:
        """Roofline pieces of the window's calls, or of the calls `units`."""
        a, t = self.cfg["model"]["audio"], self._text()
        chunk = int(self.cfg["engine"]["chunk_size"] * signals.SR)
        out = []
        for k in units if units is not None else range(len(self.calls)):
            c = self.calls[k]
            lengths = self._prompt_lengths(int(c["audio"] * signals.SR), c["chunks"])
            for plen, new, gen in zip(lengths, c["n_prefill"], c["n_generate"]):
                out.append(roofline.encode(a, prompts.rows_of(chunk), chunk // signals.SR))
                out.append(rmm.prefill(t, new, max(plen - new, 0)))
                w = rmm.decode_step(t, plen + (gen - 1) / 2)
                out.append(roofline.Work(w.flops * gen, w.bytes * gen, w.peak))
        return out
