"""Run one cell of the port's benchmark and print its result line.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds the port (`qwen3_asr_gguf_tpu_torch`)
and BENCHMARK.json. Needs the CUDA cards the cell asks for and exits with
code 2, printing no result, without them. The cell's checkpoint is written
once per checkout under benchmark/.cache/ckpt/, and the port's kernels are
built once into its own build directory; both are reused by later runs.

Standard error ends with each compared number beside its limit; the last
line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
CACHE = BENCH / ".cache"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run stays inside the checkout, at fixed paths
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    contract = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in contract["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    out = harness.run(BENCH, contract, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, CACHE, T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": dev}
    if args.trace:
        tr = out["trace"]
        if tr is None:
            log("the traced window recorded no device kernels")
            return 4
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = tr["breakdown"]
        log(f"traced window: {tr['events']} device events, {tr['markers']} markers, "
            f"busy {tr['busy_s']:.4f} s of {tr['window_s']:.4f} s")
    log(f"least time by bound: {out['least_split_s']}")
    result["checks"] = out["checks"]
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
