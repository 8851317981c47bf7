"""One run of one cell, driven by data: the cell's file names its
configuration and its traffic driver, the driver drives the port, and each
per-layer metric is read by a reader of its own.

    benchmark/workloads/<cell>.json   {"config", "traffic", "driver", "params", "limits",
                                       "trace": {"unit", "units"}}
    benchmark/configs/<config>.json   widths, weights seed, engine settings, "assumed",
                                      and "architecture" (default qwen3_asr)
    benchmark/architectures/<arch>.py checkpoint writer, taps, reference and controls,
                                      the numbers judged (architectures/__init__.py)
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

from .architectures import load as load_architecture

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
        self.arch = load_architecture(bench, self.config)

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


def judge(arch, ckpt: Path, cfg: dict, jobs: list, device) -> dict:
    """The architecture's reference over `jobs`: every number its cells'
    limits may name."""
    import torch

    ref = arch.reference(ckpt, cfg, device)
    results = [ref.judge(job) for job in jobs]
    del ref
    free(torch)
    return arch.numbers(results)


def verdict(got: dict, limits: dict, fixed: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all hold: every
    number the cell's limits name at most its limit, each of the
    architecture's `fixed` numbers at most its own (a mismatch count, 0),
    and for each limit `min_<count>` at least that many judged."""
    checks, correct = {}, True
    for key, limit in limits.items():
        if not key.startswith("min_"):
            checks[key] = {"value": got.get(key), "limit": limit}
            correct = correct and got.get(key) is not None and got[key] <= limit
    for key, limit in fixed.items():
        checks[key] = {"value": got[key], "limit": limit}
        correct = correct and got[key] <= limit
    for key, limit in limits.items():
        if key.startswith("min_"):
            name = key[len("min_"):]
            checks[name] = {"value": got[name], "limit": limit}
            correct = correct and got[name] >= limit
    return checks, correct


def run(bench: Path, contract: dict, name: str, seed: int, seconds: float, trace: bool,
        device, cache: Path, t_start: float, log=print) -> dict:
    """Set up, warm, measure for `seconds`, check against the reference, and
    return the result's fields (without the device block)."""
    import torch

    from . import roofline
    from . import trace as tracing

    cell = Cell(bench, name)
    arch = cell.arch
    ckpt, written = arch.checkpoint(cell.config, cache / "ckpt", device)
    log(f"checkpoint {ckpt} ({'written' if written else 'cached'}) "
        f"at {time.perf_counter() - t_start:.1f} s")
    taps = arch.taps(device)
    installed = []
    try:
        for tap in taps:
            tap.install()
            installed.append(tap)
        driver = cell.driver_class()(cell, ckpt, seed, device)
        driver.setup()
        driver.warm()
        tracer = None
        if trace and torch.device(device).type == "cuda":  # a CPU run traces no device
            tracing.throwaway(torch)
            tw = cell.spec["trace"]
            tracer = tracing.UnitTrace(torch, tw["unit"], tw["units"])
        for tap in taps:
            tap.reset()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.1f} s; window {seconds} s")
        summary = driver.run(seconds, tracer)
        records = [tap.read() for tap in taps]
    finally:
        for tap in reversed(installed):
            tap.remove()
    if tracer is not None:
        tracer.close()
        log(f"trace: units {tracer.units}, {tracer.n_events} device events"
            + (f"; failed: {tracer.error!r}" if tracer.error is not None else ""))
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    jobs = driver.jobs(np.random.default_rng([seed, 7]))
    notes = [tap.fill(jobs, record) for tap, record in zip(taps, records)]
    traced = driver.works(tracer.units) if tracer is not None and tracer.units else []
    works = driver.works()
    driver.close()
    del driver, taps, installed, records
    free(torch)

    t_ref = time.perf_counter()
    got = judge(arch, ckpt, cell.config, jobs, device)
    log(f"reference {time.perf_counter() - t_ref:.1f} s over {len(jobs)} jobs; "
        + "; ".join(notes))
    checks, correct = verdict(got, cell.spec["limits"], arch.FIXED)

    least, split = roofline.least_seconds(works)
    ctx = {"cell": name, "summary": summary, "least_s": least, "least_split": split,
           "traced_least_s": roofline.least_seconds(traced)[0] if traced else None,
           "traced_units": list(tracer.units) if tracer is not None and tracer.units else [],
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
