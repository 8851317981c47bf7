"""Sweep the block width and the K split of kernels 3 and 6 at the timed
shapes: the tiling rule (`ops.q4k.rows_tiling`, `ops.qmm.tiling`) is replaced
by each candidate in turn and the wrapper timed as `chip_smoke.py` times it.
One line per shape and row count: the rule's choice, then `width x split`
(kernel 6: `/ group pairs per chunk`) -> us, `!err` where a candidate
disagrees with the plain version."""

from __future__ import annotations

import json
import sys

from ._common import q4_weights, qmm_cases, setup

ROWS_T = {"o_proj": (8, 64), "down_proj": (8, 64), "qkv_proj": (8, 64), "gateup_proj": (8, 64),
          "lm_head": (8, 16, 32, 64)}
QMM_T = {"o_proj": (1, 8, 64), "down_proj": (1, 8, 64), "qkv_proj": (1, 8), "gateup_proj": (1, 8, 64),
         "lm_head": (1, 8, 64), "enc_fc1": (26, 52), "enc_fc2": (26, 52), "enc_q_w": (26, 52)}


def timed(torch, cs, call, want, weights) -> str:
    try:
        got = call(weights[0]).float()
        torch.cuda.synchronize()
        err = ((got - want).abs().max() / want.abs().max()).item()
        us = cs.time_ms(call, weights, torch) * 1e3
        return f"{us:.1f}" + ("" if err < 1e-2 else f"!err{err:.3g}")
    except Exception as e:  # a candidate the launch refuses
        return "ERR " + str(e)[:40]


def sweep_rows(torch, cs, dev, g, cfg) -> None:
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    rule = q4k.rows_tiling
    for shape, n, k in cs.decode_shapes(cfg.text):
        _, weights = cs.cold_weights(torch, dev, g, n, k)
        for t in ROWS_T[shape]:
            x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
            want = q4k.q4k_matmul_rows_ref(x, weights[0]).float()
            res = {}
            for ct in (8, 16, 32, 64):
                for ks in (1, 2, 3, 4, 6, 8):
                    if (k // 512) % ks or (shape == "lm_head" and (ks > 1 or ct < 32)):
                        continue
                    q4k.rows_tiling = lambda n, k, ct=ct, ks=ks: (ct, ks)
                    res[f"{ct}x{ks}"] = timed(torch, cs, lambda w: q4k.q4k_matmul_rows(x, w), want,
                                              weights)
            q4k.rows_tiling = rule
            print("rows", shape, f"T={t}", "rule", rule(n, k), json.dumps(res), flush=True)
        del weights


def sweep_qmm(torch, cs, dev, g, cfg) -> None:
    from qwen3_asr_gguf_tpu_torch.ops import qmm

    rule = qmm.tiling
    for shape, n, k in qmm_cases(cfg):
        weights = q4_weights(torch, dev, g, n, k)
        for t in QMM_T[shape]:
            x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
            want = qmm.q4_matmul_ref(x, weights[0]).float()
            res = {}
            for gcm in (8, 4):
                chunks = -(-(k // 64) // gcm)
                for pw in (1, 2, 4, 8):
                    for ks in (1, 2, 4, 8):
                        if (qmm.WARPS // pw > gcm or ks > chunks or (gcm == 8 and t > 16 and pw == 8)
                                or (shape == "lm_head" and (ks > 1 or pw < 4))):
                            continue
                        qmm.tiling = lambda t, n, k, planes=1, c=(pw, gcm, ks): c
                        res[f"{pw}x{ks}/{gcm}"] = timed(torch, cs, lambda w: qmm.q4_matmul(x, w),
                                                        want, weights)
            qmm.tiling = rule
            print("qmm", shape, f"T={t}", "rule", rule(t, n, k), json.dumps(res), flush=True)
        del weights


def main(argv: list[str]) -> None:
    torch, cs, dev, g, cfg = setup()
    cs.TIMED_RUNS = 20
    which = argv or ["rows", "qmm"]
    if "rows" in which:
        sweep_rows(torch, cs, dev, g, cfg)
    if "qmm" in which:
        sweep_qmm(torch, cs, dev, g, cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
