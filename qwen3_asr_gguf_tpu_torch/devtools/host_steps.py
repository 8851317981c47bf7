"""Host-clock time of the eager decode step of one checkout's engines, so
that two trees (this one and an unpacked parent commit) are compared in one
call on one machine (the host clock spreads by 20-45% between machines):

    python3 qwen3_asr_gguf_tpu_torch/devtools/host_steps.py ROOT [RUNS]

Run it as a file, not with `-m`: ROOT's package and `chip_smoke` go first on
`sys.path` and ROOT's kernels are built. The random 1.7B checkpoint (and the
0.6B aligner beside it) is made once, in this checkout's `.bench_cache/torch/`,
so both trees read the same files. For the `int4` and `q4_k` engines (bf16
KV, aligner off, `chip_smoke.py`'s `precision_engine`) on the 50.2 s clip:
one warm-up call, then RUNS timed calls at temperature 0.4, one JSON line
each with the wall time and ms per decode step (decode time over the steps
that `chip_smoke.StepCounter` counts). Alternate the trees (parent, change,
change, parent) and compare only within one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from qwen3_asr_gguf_tpu_torch.ops import _build, attn, q4k, qmm

    print(cs.nvidia_smi_line(), str(root), flush=True)
    _build.build(force=True)
    _build.lib()
    dev = torch.device("cuda", 0)
    cs.REPO = Path(__file__).resolve().parents[2]  # one checkpoint for every tree
    model_dir = cs.ensure_checkpoint()
    audio = cs.synthetic_clip(cs.CLIP_SECONDS)
    wrappers = {"int4": (q4k.q4k_matvec, q4k.q4k_matvec_normed, attn.gqa_decode_attention),
                "q4_k": (qmm.q4_matmul, attn.gqa_decode_attention)}
    for precision, counted in wrappers.items():
        engine = cs.precision_engine(torch, dev, model_dir, precision)
        engine.asr(audio, context="", language="Chinese", temperature=0.4)  # warm-up
        for run in range(runs):
            row = cs.timed_precision_asr(torch, engine, audio, counted)
            print(json.dumps({"phase": "host_steps", "root": str(root), "precision": precision,
                              "run": run, **{k: row[k] for k in (
                                  "wall_s", "ms_per_step", "decode_steps", "launches")}}),
                  flush=True)
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
