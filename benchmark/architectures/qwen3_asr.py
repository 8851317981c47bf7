"""Qwen3-ASR: the audio tower and the Qwen3 decoder, the model of every
configuration that names no architecture. Its checkpoint is
`checkpoint.py`'s, its reference and controls `reference/check.py`'s, and
its tap `tap.py`'s, on the single-stream sampler."""

from __future__ import annotations

from benchmark import checkpoint as writer
from benchmark import tap
from benchmark.reference import check

CONTROLS = ("fp8", "int4dec")
FIXED = {"prompt_mismatches": 0}


def checkpoint(cfg: dict, cache_root, device):
    return writer.ensure(cfg, cache_root, device)


class FirstTokens:
    """`tap.ArgmaxTap`: the token the port's logits put first at each token
    it samples, filled into the jobs that served tokens."""

    def __init__(self, device):
        self.tap = tap.ArgmaxTap(device)
        self.install, self.remove, self.reset = self.tap.install, self.tap.remove, self.tap.reset

    def read(self):
        return self.tap.read()

    def fill(self, jobs: list, record) -> str:
        argmax, sampled, overflow = record
        for job in jobs:
            if job.get("served"):
                job["firsts"] = tap.firsts(job["served"], argmax, sampled)
        return f"{len(sampled)} sampled tokens recorded{' (overflowed)' if overflow else ''}"


def taps(device) -> list:
    return [FirstTokens(device)]


class Judge:
    """A job's result: its gaps, a prompt mismatch (served None: a feed
    whose tokens do not begin with the carried text the reference works
    out), or nothing to judge (no served token)."""

    def __init__(self, ckpt, cfg: dict, device, control: str | None = None):
        self.ref = check.Reference(ckpt, cfg, device, control=control)

    def judge(self, job: dict, keep: bool = False) -> dict:
        if job["served"] is None:
            return {"mismatch": 1}
        return {"gaps": self.ref.gaps(job, keep=keep)} if job["served"] else {}

    def control(self, job: dict) -> dict:
        return {"gaps": self.ref.control_gaps(job)} if job["served"] else {}


def reference(ckpt, cfg: dict, device, control: str | None = None) -> Judge:
    return Judge(ckpt, cfg, device, control)


def numbers(results: list) -> dict:
    out = check.numbers([r["gaps"] for r in results if "gaps" in r])
    out["prompt_mismatches"] = sum(r.get("mismatch", 0) for r in results)
    return out
