"""Readings that a cell's limits are set from, on the card, in one process:

    python benchmark/control.py --workload NAME --seeds 1,2,3 --seconds S [--control-seeds 3]

Sets the cell up once, then for each seed runs a window of `S` seconds at
the cell's load and keeps the jobs the reference checks, with the tokens
the port's logits put first (`tap.py`), as a run does. After the program is
freed: the reference's numbers for every seed (the program's readings),
and for the first `--control-seeds` seeds each control's (the reference one
step below the stated precisions, `reference/model.py`) at the same prompts
and served tokens, each judged by the harness's own verdict against the
cell's limits. Prints one JSON line per seed and a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROLS = ("fp8", "int4dec")


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

    from benchmark import checkpoint, harness, tap
    from benchmark.reference.check import Reference, numbers

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(ROOT / "benchmark", args.workload)
    ckpt, _ = checkpoint.ensure(cell.config, ROOT / "benchmark" / ".cache" / "ckpt", device)
    seeds = [int(s) for s in args.seeds.split(",")]
    firsts = tap.ArgmaxTap(device)
    firsts.install()
    driver = cell.driver_class()(cell, ckpt, seeds[0], device)
    driver.setup()
    driver.warm()
    per_seed = []
    for seed in seeds:
        driver.reset(seed)
        firsts.reset()
        t0 = time.perf_counter()
        driver.run(args.seconds)
        argmax, sampled, _ = firsts.read()
        jobs = driver.jobs(np.random.default_rng([seed, 7]))
        for job in jobs:
            if job["served"]:
                job["firsts"] = tap.firsts(job["served"], argmax, sampled)
        per_seed.append((seed, jobs))
        print(f"seed {seed}: window {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    firsts.remove()
    driver.close()
    del driver, firsts
    harness.free(torch)

    ref = Reference(ckpt, cell.config, device)
    rows = []
    for i, (seed, jobs) in enumerate(per_seed):
        keep = i < args.control_seeds
        gaps = [ref.gaps(job, keep=keep) for job in jobs if job["served"]]
        got, bad = numbers(gaps), sum(job["served"] is None for job in jobs)
        rows.append({"seed": seed, "program": got, "mismatched": bad,
                     "program_correct": harness.verdict(got, bad, cell.spec["limits"])[1]})
    del ref
    harness.free(torch)
    for mode in CONTROLS:
        ctl = Reference(ckpt, cell.config, device, control=mode)
        for i, (seed, jobs) in enumerate(per_seed[: args.control_seeds]):
            got = numbers([ctl.control_gaps(job) for job in jobs if job["served"]])
            rows[i][mode] = got
            rows[i][f"{mode}_correct"] = harness.verdict(got, 0, cell.spec["limits"])[1]
        del ctl
        harness.free(torch)
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "card": torch.cuda.get_device_name(0)}
    for key in ("gap_widest", "gap_mean"):
        summary[f"program_max.{key}"] = max(r["program"][key] for r in rows)
        for mode in CONTROLS:
            summary[f"{mode}_min.{key}"] = min(r[mode][key] for r in rows if mode in r)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
