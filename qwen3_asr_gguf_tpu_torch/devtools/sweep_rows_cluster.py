"""Kernel 5's cluster size (`CLUSTER` in csrc/attn_rows_q8.cu, `ROWS_CLUSTER`
in ops/attn.py) swept on the card in one call: for each size given (default
2, 4 and 8) a copy of this checkout's port and `chip_smoke.py` with both
constants set to it is written under `.bench_cache/sweep_rows/`, then built
and timed by `kernel_phases.py COPY rows` (kernel 5's phase and its
`rows_positions` probe), one process per copy, in turn. A size written
`SIZE:copies` builds a copy whose warps only stream their sub-tiles (the
scores, softmax and PV taken out, so its output is wrong and only the probe
runs): the floor that the copies alone set.

    python3 -m qwen3_asr_gguf_tpu_torch.devtools.sweep_rows_cluster [SIZE[:copies] ...]
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

from ._common import REPO

ANCHORS = (("qwen3_asr_gguf_tpu_torch/csrc/attn_rows_q8.cu", r"constexpr int CLUSTER = \d+;",
            "constexpr int CLUSTER = {};"),
           ("qwen3_asr_gguf_tpu_torch/ops/attn.py", r"\nROWS_CLUSTER = \d+", "\nROWS_CLUSTER = {}"))


# the math of a sub-tile, from the scores to the PV (kept: the line after it)
MATH = ("    // scores of slots s0 + sg (step 0) and s0 + 4 + sg (step 1)\n",
        "    __syncwarp();  // the stage and p_s are rewritten next\n")


def copy_with_cluster(size: int, copies_only: bool = False):
    root = REPO / ".bench_cache" / "sweep_rows" / f"cluster{size}{'_copies' if copies_only else ''}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "qwen3_asr_gguf_tpu_torch", root / "qwen3_asr_gguf_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
    for rel, pattern, repl in ANCHORS:
        path = root / rel
        text, n = re.subn(pattern, repl.format(size), path.read_text())
        if n != 1:
            raise RuntimeError(f"{rel}: the anchor {pattern!r} matched {n} times")
        path.write_text(text)
    if copies_only:
        path = root / ANCHORS[0][0]
        text = path.read_text()
        a, b = text.find(MATH[0]), text.find(MATH[1])
        if a < 0 or b < a:
            raise RuntimeError("attn_rows_q8.cu: the anchors of the sub-tile's math moved")
        path.write_text(text[:a] + text[b:])
    return root


def main() -> None:
    for arg in sys.argv[1:] or ["2", "4", "8"]:
        size, _, variant = arg.partition(":")
        root = copy_with_cluster(int(size), variant == "copies")
        print(f"# cluster {arg}: {root}", flush=True)
        subprocess.run([sys.executable, str(root / "qwen3_asr_gguf_tpu_torch" / "devtools"
                                             / "kernel_phases.py"), str(root),
                        "rows-positions" if variant == "copies" else "rows"], check=True)


if __name__ == "__main__":
    main()
