"""`chip_smoke.py`'s six timed kernel phases (`kernel`, `kernel_attn_decode`,
`kernel_rows`, `kernel_attn`, `kernel_qmm`, `kernel_mlp`: all seven kernels)
from one checkout, so that two trees (this one and an unpacked parent commit)
are timed in one call on one card:

    python3 qwen3_asr_gguf_tpu_torch/devtools/kernel_phases.py ROOT [rows | rows-positions | widths | mlp]

Run it as a file, not with `-m`: ROOT goes first on `sys.path`, so ROOT's
package, `chip_smoke` and kernel sources are the ones built (into ROOT's
build directory) and timed. One JSON line per timed shape, as
`chip_smoke.py` prints them; then, where ROOT's kernel 4 reads `pos` from
the device, one line per (window, pos) of kernel 4 at the 1.7B shape
(`attn_positions`): the per-call time in a CUDA graph and the profiler's
device duration of the kernel, against the live slots of the busiest block
(what a call pays at any `pos`, and what grows with the slots); and the same
for kernel 5 at the serving shape, all 8 rows at one position
(`rows_positions`; in a tree without `ROWS_CLUSTER` a block walks its row's
every live slot). With `rows` only kernel 5's phase and probe run, with
`rows-positions` the probe alone; `widths` times kernels 1 and 2 at K = 2048
against the number of 16-channel tiles (`matvec_widths`: where the tiles
outnumber the blocks the card holds, blocks take a second tile); `mlp` runs
kernel 7's phase alone and then the profiler's device time of each device
kernel one `fused_mlp_matvec` call launches, at both MLP shapes
(`mlp_device`: two kernels for the two-launch design, one for the
cooperative one).
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


def _device_us(torch, kern, caches, name: str) -> float | None:
    """The profiler's device time of one call of `kern`, per call over the
    caches (no profiler session may precede a graph timing)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in caches:
            kern(c)
        torch.cuda.synchronize()
    durs = [e.device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return sum(durs) / len(caches) if durs else None


def rows_busiest_block(pos: int, win: int, cluster: int | None, sub: int) -> int:
    """Live slots of the busiest block of kernel 5 when every row is at `pos`:
    the row's sub-tiles split over the cluster (or, with no cluster, the
    whole row in one block)."""
    live = min(pos, win - 1) + 1
    if cluster is None:
        return live
    n_sub = -(-live // sub)
    return max(min(live, (r + 1) * n_sub // cluster * sub) - r * n_sub // cluster * sub
               for r in range(cluster))


def rows_attn_positions(torch, cs, dev, cfg):
    """Times kernel 5 in CUDA graphs now; returns the function that then
    profiles each case and prints its line (after every graph timing of the
    run, kernel 4's included)."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn

    b, s_max, hq, hkv, d = 8, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cluster = getattr(attn, "ROWS_CLUSTER", None)
    sub = getattr(attn, "ROWS_SUB", 8)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    caches = []
    for _ in range(4):
        k, ks = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
        v, vs = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
        caches.append((k, ks, v, vs))
    q = (torch.randn((b, hq, d), generator=g, device=dev) * 0.5).to(torch.bfloat16)

    def call(win, pos):
        poss = torch.full((b,), pos, dtype=torch.int64, device=dev)
        return lambda c: attn.gqa_rows_q8_attention(q, *c, poss, d ** -0.5, win)

    cases = [(win, pos) for win in (256, 1024, 2048)
             for pos in sorted({0, 7, 63, 255, win // 2 - 1, win - 1})]
    graph_us = [cs.time_ms(call(win, pos), caches, torch) * 1e3 for win, pos in cases]

    def report() -> None:
        for (win, pos), us in zip(cases, graph_us):
            print(json.dumps({"phase": "rows_positions", "win": win, "pos": pos, "b": b,
                              "blocks_per_row_and_kv_head": cluster or 1,
                              "busiest_block_slots": rows_busiest_block(pos, win, cluster, sub),
                              "graph_us": us,
                              "device_us": _device_us(torch, call(win, pos), caches,
                                                      "rows_q8_attn")}), flush=True)

    return report


def matvec_widths(torch, cs, dev) -> None:
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    k = 2048
    x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
    norm_w = torch.rand(k, generator=g, device=dev) + 0.5
    for n in range(2048, 16384 + 1, 1024):
        nbytes, weights = cs.cold_weights(torch, dev, g, n, k)
        print(json.dumps({
            "phase": "matvec_widths", "n": n, "k": k, "tiles": n // 16, "weight_mb": nbytes / 1e6,
            "matvec_us": cs.time_ms(lambda w: q4k.q4k_matvec(x, w), weights, torch) * 1e3,
            "normed_us": cs.time_ms(lambda w: q4k.q4k_matvec_normed(x, w, norm_w, 1e-6), weights,
                                    torch) * 1e3}), flush=True)
        del weights


def mlp_device(torch, dev) -> None:
    """Each device kernel of one fused_mlp_matvec call: name and device us,
    averaged over calls on weights cold in L2."""
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_gguf_tpu_torch.ops import mlp

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI comes up; thrown away
        torch.zeros(1, device=dev).add_(1.0)
        torch.cuda.synchronize()
    for d, m in ((2048, 6144), (1024, 3072)):
        sets = [tuple(t for shape in ((m, d), (m, d), (d, m)) for t in (
            torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
            torch.rand(shape[0], generator=g, device=dev) * 4e-4 + 1e-4))
            for _ in range(max(2, -(-(128 << 20) // (3 * d * m))))]
        x = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
        for a in sets:
            mlp.fused_mlp_matvec(x, *a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in sets:
                mlp.fused_mlp_matvec(x, *a)
            torch.cuda.synchronize()
        kernels = {e.key: e.device_time_total / len(sets) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        print(json.dumps({"phase": "mlp_device", "hidden": d, "m": m, "device_us": kernels,
                          "kernels_per_call": sum(e.count for e in prof.key_averages()
                                                  if e.device_type == torch.autograd.DeviceType.CUDA)
                          / len(sets)}), flush=True)
        del sets


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
    mode = sys.argv[2:]
    if mode in (["rows"], ["rows-positions"]):
        if mode == ["rows"]:
            cs.attn_kernel_phase(torch, dev, cfg.text)
        rows_attn_positions(torch, cs, dev, cfg.text)()
        return
    if mode == ["widths"]:
        matvec_widths(torch, cs, dev)
        return
    if mode == ["mlp"]:
        cs.mlp_kernel_phase(torch, dev)
        mlp_device(torch, dev)
        return
    cs.kernel_phase(torch, dev, cfg.text)
    cs.decode_attn_kernel_phase(torch, dev, cfg.text)
    cs.rows_kernel_phase(torch, dev, cfg.text)
    cs.attn_kernel_phase(torch, dev, cfg.text)
    cs.qmm_kernel_phase(torch, dev, cfg)
    cs.mlp_kernel_phase(torch, dev)
    report_rows = rows_attn_positions(torch, cs, dev, cfg.text)
    if hasattr(attn, "decode_pos"):
        decode_attn_positions(torch, cs, dev, cfg.text)
    report_rows()


if __name__ == "__main__":
    main()
