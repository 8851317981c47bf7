"""One run of one cell, driven by data: the cell's file names its
configuration and its traffic driver, the driver drives the port, and each
per-layer metric is read by a reader of its own.

    benchmark/workloads/<cell>.json   {"config", "traffic", "driver", "params", "limits",
                                       "trace": {"unit", "units"}}
    benchmark/configs/<config>.json   widths, weights seed, engine settings, "assumed"
    benchmark/traffic/<driver>.py     class Driver (its interface: traffic/__init__.py)
    benchmark/metrics/<metric>.py     read(ctx) -> value or None; a metric
                                      "<base>.<cell kind>" falls back to <base>.py

Which metrics a run reports comes from BENCHMARK.json: its end-to-end
metrics without `--trace`, its per-layer ones with it, each where it lists
the cell or lists none.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_asr_gguf_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's files under `bench` (the benchmark's directory)."""

    def __init__(self, bench: Path, name: str):
        self.bench, self.name = bench, name
        self.spec = load_json(bench / "workloads" / f"{name}.json")
        self.config = load_json(bench / "configs" / f"{self.spec['config']}.json")
        self.params = self.spec["params"]

    def driver_class(self):
        mod = load_module(self.bench / "traffic" / f"{self.spec['driver']}.py",
                          f"bench_traffic_{self.spec['driver']}")
        return mod.Driver

    def metrics(self, contract: dict, trace: bool) -> list[dict]:
        key = "per_layer" if trace else "end_to_end"
        return [m for m in contract[key] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        for stem in (metric, metric.split(".")[0]):
            path = self.bench / "metrics" / f"{stem}.py"
            if path.exists():
                return load_module(path, f"bench_metric_{stem.replace('.', '_')}").read
        raise FileNotFoundError(f"no reader for {metric} in {self.bench / 'metrics'}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def judge(ckpt: Path, cfg: dict, jobs: list, device) -> tuple[dict, int]:
    """The reference's numbers over `jobs` (`reference/check.py`), and how
    many jobs mismatched (served None: a feed whose tokens do not begin with
    the carried text the reference works out)."""
    import torch

    from .reference.check import Reference, numbers

    ref = Reference(ckpt, cfg, device)
    gaps, mismatched = [], 0
    for job in jobs:
        if job["served"] is None:
            mismatched += 1
        elif job["served"]:
            gaps.append(ref.gaps(job))
    del ref
    free(torch)
    return numbers(gaps), mismatched


def verdict(got: dict, mismatched: int, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all hold: every
    gap the cell's file limits (`gap_widest`, `gap_mean`), no mismatched
    job, and at least `min_judged` positions judged."""
    checks = {k: {"value": got[k], "limit": limits[k]} for k in ("gap_widest", "gap_mean")
              if k in limits}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    checks["prompt_mismatches"] = {"value": mismatched, "limit": 0}
    checks["judged"] = {"value": got["judged"], "limit": limits["min_judged"]}
    correct = correct and mismatched == 0 and got["judged"] >= limits["min_judged"]
    return checks, correct


def run(bench: Path, contract: dict, name: str, seed: int, seconds: float, trace: bool,
        device, cache: Path, t_start: float, log=print) -> dict:
    """Set up, warm, measure for `seconds`, check against the reference, and
    return the result's fields (without the device block)."""
    import torch

    from . import checkpoint, roofline, tap
    from . import trace as tracing

    cell = Cell(bench, name)
    ckpt, written = checkpoint.ensure(cell.config, cache / "ckpt", device)
    log(f"checkpoint {ckpt} ({'written' if written else 'cached'}) "
        f"at {time.perf_counter() - t_start:.1f} s")
    firsts = tap.ArgmaxTap(device)
    firsts.install()
    try:
        driver = cell.driver_class()(cell, ckpt, seed, device)
        driver.setup()
        driver.warm()
        tracer = None
        if trace and torch.device(device).type == "cuda":  # a CPU run traces no device
            tracing.throwaway(torch)
            tw = cell.spec["trace"]
            tracer = tracing.UnitTrace(torch, tw["unit"], tw["units"])
        firsts.reset()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.1f} s; window {seconds} s")
        summary = driver.run(seconds, tracer)
        argmax, sampled, overflow = firsts.read()
    finally:
        firsts.remove()
    if tracer is not None:
        tracer.close()
        log(f"trace: units {tracer.units}, {tracer.n_events} device events"
            + (f"; failed: {tracer.error!r}" if tracer.error is not None else ""))
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    jobs = driver.jobs(np.random.default_rng([seed, 7]))
    for job in jobs:
        if job["served"]:
            job["firsts"] = tap.firsts(job["served"], argmax, sampled)
    traced = driver.works(tracer.units) if tracer is not None and tracer.units else []
    works = driver.works()
    driver.close()
    del driver, firsts
    free(torch)

    t_ref = time.perf_counter()
    got, mismatched = judge(ckpt, cell.config, jobs, device)
    log(f"reference {time.perf_counter() - t_ref:.1f} s over {len(jobs)} jobs; "
        f"{len(sampled)} sampled tokens recorded{' (overflowed)' if overflow else ''}")
    checks, correct = verdict(got, mismatched, cell.spec["limits"])

    least, split = roofline.least_seconds(works)
    ctx = {"cell": name, "summary": summary, "least_s": least, "least_split": split,
           "traced_least_s": roofline.least_seconds(traced)[0] if traced else None,
           "trace": tracer.result if tracer is not None else None}
    metrics = {}
    for m in cell.metrics(contract, trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif trace:
            value = cell.reader(m["name"])(ctx)
        else:
            value = summary["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return {"correct": bool(correct), "attempted": summary["attempted"],
            "failed": summary["failed"], "metrics": metrics, "checks": checks,
            "memory_peak_bytes": int(peak), "least_split_s": split, "trace": ctx["trace"]}
