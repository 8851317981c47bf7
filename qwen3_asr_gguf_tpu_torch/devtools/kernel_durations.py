"""Durations of the launches behind a wrapper call, by kernel name
(`torch.profiler`, CUDA events only), beside the per-call time of the CUDA
graph that `chip_smoke.py` reports, for a few shapes of kernels 3 and 6 and
their library call; the last line is the floor of any launch in that graph
(an elementwise add on one value)."""

from __future__ import annotations

import json

from ._common import q4_weights, setup


def profile_call(torch, cs, fn, weights, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    for w in weights:
        fn(w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            for w in weights:
                fn(w)
        torch.cuda.synchronize()
    us = {e.key[:60]: round(e.device_time_total / e.count, 2) for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA}
    graph_us = cs.time_ms(fn, weights, torch) * 1e3
    print(label, f"graph={graph_us:.1f}us", json.dumps(us), flush=True)


def main() -> None:
    torch, cs, dev, g, cfg = setup()
    from qwen3_asr_gguf_tpu_torch.ops import q4k, qmm
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    cs.TIMED_RUNS = 20
    shapes = {s: (n, k) for s, n, k in cs.decode_shapes(cfg.text)}
    for shape, ts in (("o_proj", (8, 64)), ("down_proj", (8,)), ("lm_head", (8, 64))):
        n, k = shapes[shape]
        _, weights = cs.cold_weights(torch, dev, g, n, k)
        for t in ts:
            x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
            profile_call(torch, cs, lambda w: q4k.q4k_matmul_rows(x, w), weights,
                         f"rows {shape} T={t} {q4k.rows_tiling(n, k)}")
        del weights
    for shape, n, k, ts in (("o_proj", 2048, 2048, (1, 64)), ("down_proj", 2048, 6144, (1,)),
                            ("enc_q_w", 1024, 1024, (26,)), ("enc_fc2", 1024, 4096, (52,)),
                            ("lm_head", 152064, 2048, (1,))):
        weights = q4_weights(torch, dev, g, n, k)
        for t in ts:
            x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
            profile_call(torch, cs, lambda w: qmm.q4_matmul(x, w), weights,
                         f"qmm {shape} T={t} {qmm.tiling(t, n, k)}")
            n_dense = max(2, -(-(128 << 20) // (2 * n * k)))
            dense = [qt.dequant_q4(w, dtype=torch.bfloat16) for w in weights[:n_dense]]
            profile_call(torch, cs, lambda w: torch.matmul(x, w.T), dense, f"lib {shape} T={t}")
            del dense
        del weights
    ones = [torch.zeros(1, device=dev) for _ in range(64)]
    profile_call(torch, cs, lambda w: w.add_(1.0), ones, "floor add_")


if __name__ == "__main__":
    main()
