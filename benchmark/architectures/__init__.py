"""What a configuration brings of its own model. The harness reaches every
part of a run that depends on the model through the module that the
configuration's "architecture" names (`qwen3_asr` where it names none),
found by that name as a file of this directory:

    checkpoint(cfg, cache_root, device) -> (directory, written now)
        the random-weight checkpoint, written once per checkout;
    taps(device) -> [tap]
        what records the port's outputs on the device while it runs, each
        with install(), remove(), reset(), read() -> record, and
        fill(jobs, record) -> note, which writes into the sampled jobs
        what the reference judges; installed before the engine is built;
    reference(ckpt, cfg, device, control=None)
        the plain reference, or with `control` one of CONTROLS, each with
        judge(job, keep=False) -> result and control(job) -> result (the
        control at the positions the port was judged at, against what
        judge(job, keep=True) kept in the job);
    numbers(results) -> {name: value}
        every number that a cell's limits may name, over the jobs' results;
    FIXED: {name: limit}
        numbers held to a fixed limit in every cell (the mismatch counts);
    CONTROLS: the names of the controls.

A new architecture is a file here and a configuration that names it; the
harness, `control.py` and `run.py` need no edit.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

DEFAULT = "qwen3_asr"


def load(bench: Path, cfg: dict):
    name = cfg.get("architecture", DEFAULT)
    path = bench / "architectures" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no architecture {name!r} in {path.parent}")
    spec = importlib.util.spec_from_file_location(f"bench_arch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
