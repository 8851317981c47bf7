"""Readings that a cell's limits are set from, on the card, in one process:

    python benchmark/control.py --workload NAME --seeds 1,2,3 --seconds S [--control-seeds 3]

Sets the cell up once, then for each seed runs a window of `S` seconds at
the cell's load and keeps the jobs the reference checks, filled by the
architecture's taps (`architectures/`), as a run does. After the program
is freed: the reference's numbers for every seed (the program's readings),
and for the first `--control-seeds` seeds each control's (the reference
one step below the stated precisions) at the same prompts and outputs,
each judged by the harness's own verdict against the cell's limits. Prints
one JSON line per seed and a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(ROOT / "benchmark", args.workload)
    arch, limits = cell.arch, cell.spec["limits"]
    ckpt, _ = arch.checkpoint(cell.config, ROOT / "benchmark" / ".cache" / "ckpt", device)
    seeds = [int(s) for s in args.seeds.split(",")]
    taps = arch.taps(device)
    for tap in taps:
        tap.install()
    driver = cell.driver_class()(cell, ckpt, seeds[0], device)
    driver.setup()
    driver.warm()
    per_seed = []
    for seed in seeds:
        driver.reset(seed)
        for tap in taps:
            tap.reset()
        t0 = time.perf_counter()
        driver.run(args.seconds)
        records = [tap.read() for tap in taps]
        jobs = driver.jobs(np.random.default_rng([seed, 7]))
        for tap, record in zip(taps, records):
            tap.fill(jobs, record)
        per_seed.append((seed, jobs))
        print(f"seed {seed}: window {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    for tap in reversed(taps):
        tap.remove()
    driver.close()
    del driver, taps
    harness.free(torch)

    ref = arch.reference(ckpt, cell.config, device)
    rows = []
    for i, (seed, jobs) in enumerate(per_seed):
        got = arch.numbers([ref.judge(job, keep=i < args.control_seeds) for job in jobs])
        rows.append({"seed": seed, "program": got,
                     "program_correct": harness.verdict(got, limits, arch.FIXED)[1]})
    del ref
    harness.free(torch)
    for mode in arch.CONTROLS:
        ctl = arch.reference(ckpt, cell.config, device, control=mode)
        for i, (seed, jobs) in enumerate(per_seed[: args.control_seeds]):
            got = arch.numbers([ctl.control(job) for job in jobs])
            rows[i][mode] = got
            rows[i][f"{mode}_correct"] = harness.verdict(got, limits, arch.FIXED)[1]
        del ctl
        harness.free(torch)
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "card": torch.cuda.get_device_name(0)}
    for key in rows[0]["program"]:
        values = [r["program"][key] for r in rows if r["program"][key] is not None]
        summary[f"program_max.{key}"] = max(values) if values else None
        for mode in arch.CONTROLS:
            got = [r[mode][key] for r in rows if mode in r and r[mode][key] is not None]
            summary[f"{mode}_min.{key}"] = min(got) if got else None
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
