"""`chip_smoke.py`'s six timed kernel phases (`kernel`, `kernel_attn_decode`,
`kernel_rows`, `kernel_attn`, `kernel_qmm`, `kernel_mlp`: all seven kernels)
from one checkout, so that two trees (this one and an unpacked parent commit)
are timed in one call on one card:

    python3 qwen3_asr_gguf_tpu_torch/devtools/kernel_phases.py ROOT

Run it as a file, not with `-m`: ROOT goes first on `sys.path`, so ROOT's
package, `chip_smoke` and kernel sources are the ones built (into ROOT's
build directory) and timed. One JSON line per timed shape, as
`chip_smoke.py` prints them; then, where ROOT's kernel 4 reads `pos` from
the device, one line per (window, pos) of kernel 4 at the 1.7B shape
(`attn_positions`): the per-call time in a CUDA graph and the profiler's
device duration of the kernel, against the live slots of the busiest block
(what a call pays at any `pos`, and what grows with the slots).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def decode_attn_positions(torch, cs, dev, cfg) -> None:
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_gguf_tpu_torch.ops import attn

    s_max, hq, hkv, d = 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    q = (torch.randn((1, hq, d), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    caches = [tuple(torch.randn((s_max, hkv, d), generator=g, device=dev).to(torch.bfloat16)
                    for _ in "kv") for _ in range(16)]

    def call(win, pos):
        pt = torch.tensor([pos], dtype=torch.int32, device=dev)
        return lambda c: attn.gqa_decode_attention(q, *c, pt, d ** -0.5, win)

    cases = []
    for win in (256, 1024, 2048):
        per_block = win // attn.DECODE_CLUSTER
        cases += [(win, pos, min(pos + 1, per_block)) for pos in
                  sorted({0, 7, per_block - 1, 2 * per_block - 1, win // 2 - 1, win - 1})]
    # every graph timing first: no profiler session precedes a timing
    graph_us = [cs.time_ms(call(win, pos), caches, torch) * 1e3 for win, pos, _ in cases]
    floor = [torch.zeros(1, device=dev) for _ in range(16)]
    floor_us = cs.time_ms(lambda w: w.add_(1.0), floor, torch) * 1e3
    for (win, pos, busiest), us in zip(cases, graph_us):
        kern = call(win, pos)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c in caches:
                kern(c)
            torch.cuda.synchronize()
        durs = [e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "decode_attn" in e.key]
        print(json.dumps({"phase": "attn_positions", "win": win, "pos": pos,
                          "blocks_per_kv_head": attn.DECODE_CLUSTER,
                          "busiest_block_slots": busiest, "graph_us": us,
                          "device_us": sum(durs) / len(caches) if durs else None}), flush=True)
    print(json.dumps({"phase": "attn_positions", "floor_add_us": floor_us}), flush=True)


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from qwen3_asr_gguf_tpu_torch import preset
    from qwen3_asr_gguf_tpu_torch.ops import _build, attn

    print(cs.nvidia_smi_line(), str(root), flush=True)
    _build.build(force=True)
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = preset(cs.PRESET)
    cs.kernel_phase(torch, dev, cfg.text)
    cs.decode_attn_kernel_phase(torch, dev, cfg.text)
    cs.rows_kernel_phase(torch, dev, cfg.text)
    cs.attn_kernel_phase(torch, dev, cfg.text)
    cs.qmm_kernel_phase(torch, dev, cfg)
    cs.mlp_kernel_phase(torch, dev)
    if hasattr(attn, "decode_pos"):
        decode_attn_positions(torch, cs, dev, cfg.text)


if __name__ == "__main__":
    main()
