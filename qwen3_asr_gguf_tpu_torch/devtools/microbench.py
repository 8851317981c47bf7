"""Build and run the two micro-benchmarks beside this file: `mma_rate.cu`
(cycles per `mma.sync` tile per SM sub-partition) and `rows_inner_loop.cu`
(kernel 3's inner loop on a chunk resident in shared memory: cycles per
32-group and 8-row tile per SM, against the ~5 its operation count allows)."""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

from ._common import setup

HERE = Path(__file__).resolve().parent


def main() -> None:
    setup()
    from qwen3_asr_gguf_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mma_rate", "rows_inner_loop"):
            exe = Path(tmp) / name
            subprocess.run([_build.find_nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(exe),
                            str(HERE / f"{name}.cu")], check=True)
            print(f"== {name}", flush=True)
            subprocess.run([str(exe)], check=True)


if __name__ == "__main__":
    main()
