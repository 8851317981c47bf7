"""Kernel 7's compile-time choices swept on the card in one call: for each
setting given (default: the compiled one, then RING=2, RING=3,
PREFETCH_WD=1 and PREFETCH_WD=2), a copy of this checkout's port and
`chip_smoke.py` with the constants of csrc/fused_mlp.cu set to it is written
under `.bench_cache/sweep_mlp/`, then built and timed by
`kernel_phases.py COPY mlp` (kernel 7's phase and its device kernels), one
process per copy, in turn.

    python3 -m qwen3_asr_gguf_tpu_torch.devtools.sweep_mlp [NAME=VALUE[,NAME=VALUE] ...]

RING is the phase-1 rows a warp keeps in flight; PREFETCH_WD where the Wd
slab's copies are issued: 0 after the block's phase 1, 1 in the prologue
(beside phase 1's loads), 2 after the grid barrier and the acts' quantization.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

from ._common import REPO

SOURCE = "qwen3_asr_gguf_tpu_torch/csrc/fused_mlp.cu"
SETTINGS = ("", "RING=2", "RING=3", "PREFETCH_WD=1", "PREFETCH_WD=2")


def copy_with(setting: str):
    tag = setting.replace("=", "").replace(",", "_") or "compiled"
    root = REPO / ".bench_cache" / "sweep_mlp" / tag
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "qwen3_asr_gguf_tpu_torch", root / "qwen3_asr_gguf_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
    path = root / SOURCE
    text = path.read_text()
    for pair in filter(None, setting.split(",")):
        name, value = pair.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                          text)
        if n != 1:
            raise RuntimeError(f"{SOURCE}: the constant {name} matched {n} times")
    path.write_text(text)
    return root


def main() -> None:
    for setting in sys.argv[1:] or SETTINGS:
        root = copy_with(setting)
        print(f"# {setting or 'compiled'}: {root}", flush=True)
        subprocess.run([sys.executable, str(root / "qwen3_asr_gguf_tpu_torch" / "devtools"
                                             / "kernel_phases.py"), str(root), "mlp"], check=True)


if __name__ == "__main__":
    main()
