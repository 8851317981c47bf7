#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qwen3_asr_gguf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   TF32 and reduced-precision bf16 reductions off;
2. builds the CUDA kernels from qwen3_asr_gguf_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at the five
   decode shapes of Qwen3-ASR-1.7B (o_proj, down_proj, lm_head; qkv and
   gate_up with the fused rms_norm), with the stated bound, and both timed
   (CUDA events, median of 50 launches, L2 flushed before each), beside one
   torch.matmul on the dequantized bf16 weight and the least time the card
   could take (bytes over its memory rate, operations over its peak rate);
   the single-token decode attention the same way over a 2048-slot bf16
   cache (windows 256, 1024, 2048; an f32 cache too), beside one
   scaled_dot_product_attention call;
4. builds the native codec (when g++ is present) and random-weight
   qwen3-asr-1.7b and qwen3-forced-aligner-0.6b q4_k checkpoints in
   .bench_cache/torch/;
5. QwenASREngine at the bench headline settings (int4, bf16 KV, 40 s chunks,
   decode_block = max_new_tokens = 96, KV prefix reuse, the 0.6B forced
   aligner at int8) on a 50.2 s synthetic clip: one warm-up pass, then
   temperature 0.4 and 0, each with the kernels' launch counts of that run
   and the checks on the returned alignment; then, for comparison inside
   this run only, the same call with the aligner off and with the plain
   decode attention;
6. one full-width decode step through the kernels against the same step on
   dense dequantized weights with the plain attention (cosine bound), finite
   encoder output, and the aligner's sparse logits on the card against an
   f32 CPU runner of the same checkpoint (cosine bound);
7. the multi-row q4_k matmul against its plain version and, row by row,
   against the matvec kernel, at T = 8 (the serving batch) and T = 64, and
   the int8-KV rows attention against its plain version at B = 8 over a
   2048-slot cache, windows 256, 1024 and 2048; both timed as in phase 3;
8. one batched decode step (forward_step_rows, B = 8) through the kernels
   against the same step on dense weights with the plain attention, from
   the same prefilled caches, for bf16 and int8 KV (cosine bound);
9. the port's OpenAI-compatible server, built by its CLI's build function
   from real arguments (continuous batching, 8 rows, bf16 KV), answering 16
   concurrent 10 s requests and one 50.2 s request over HTTP, with
   throughput, latency and the batcher's counters;
10. a continuous batcher on an int8-KV engine (the `tools/bench_serve.py
   --kv int8` configuration): 16 greedy 10 s requests.

Every kernel's launches are counted in the run of its path (counts set to 0
just before it). The last lines are the kernels summary, the nvidia-smi
line and {"ok": true, "device": {...}}. Without a CUDA device, or run where
the package is missing, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PRESET = "qwen3-asr-1.7b"
CLIP_SECONDS = 50.2
TIMED_RUNS = 50
KERNEL_BOUND = 1e-2  # max|kernel - plain| <= KERNEL_BOUND * max|plain| (bf16 outputs)
STEP_COSINE_BOUND = 0.99  # int8-activation kernel path vs dense bf16 weights
ROWS_T = (8, 64)  # multi-row matmul batches: the serving default and the largest
SERVE_CLIP_SECONDS = 10.0
SERVE_REQUESTS = 16
ALIGNER_PRESET = "qwen3-forced-aligner-0.6b"
F32_KERNEL_BOUND = 1e-4  # the decode attention over an f32 cache (sums in another order)
ATTN_HEADLINE_WIN = 1024  # the attention window whose time stands in the kernels line
REPLACES = {
    "q4k_matvec": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:324",
    "q4k_matvec_normed": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:594",
    "q4k_matmul_rows": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:419",
    "gqa_decode_attention": "qwen3_asr_gguf_tpu/ops/pallas_attn.py:94",
    "gqa_rows_q8_attention": "qwen3_asr_gguf_tpu/ops/pallas_attn.py:215",
}
SOURCES = {
    "q4k_matvec": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matvec.cu",
    "q4k_matvec_normed": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matvec.cu",
    "q4k_matmul_rows": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matmul_rows.cu",
    "gqa_decode_attention": "qwen3_asr_gguf_tpu_torch/csrc/attn_decode.cu",
    "gqa_rows_q8_attention": "qwen3_asr_gguf_tpu_torch/csrc/attn_rows_q8.cu",
}
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, weights: list, torch) -> float:
    """Device time of one call: the calls cycle through `weights` (copies
    enough to exceed the 50 MB L2, so each call streams cold weights as a
    decode step does) inside a captured CUDA graph, so host launch time is
    left out; CUDA events around each of TIMED_RUNS replays, median, per call."""
    for w in weights:
        fn(w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for w in weights:
            fn(w)
    graph.replay()
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(weights))
    del graph
    times.sort()
    return times[len(times) // 2]


def decode_shapes(cfg) -> list[tuple[str, int, int]]:
    """(name, N, K) of every q4_k weight of a 1.7B decode step."""
    d, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return [("o_proj", d, hq * hd), ("down_proj", d, m),
            ("lm_head", -(-v // 1024) * 1024, d),  # the engine pads the head to 1024 rows
            ("qkv_proj", (hq + 2 * hkv) * hd, d), ("gateup_proj", 2 * m, d)]


def cold_weights(torch, dev, g, n, k):
    """(bytes of one weight, copies of a random q4_k weight [N, K] on the
    card, enough to exceed the 128 MB that keeps each call cold in L2)."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    def random_weight():
        # any bytes are a valid q4_k weight in this layout: draw it on the card
        return q4k.Q4KWeight(
            packed=torch.randint(0, 256, (n // 2, k), generator=g, device=dev, dtype=torch.uint8),
            sub_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
            min_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
            dd_t=torch.rand((2 * (k // 256), n), generator=g, device=dev) * 1e-3,
        )

    nbytes = n * k // 2 + 2 * (k // 32) * n + 4 * (k // 128) * n
    return nbytes, [random_weight() for _ in range(max(2, -(-(128 << 20) // nbytes)))]


def dense_matmul_ms(torch, x, weights: list) -> float:
    """One torch.matmul of x on each weight dequantized to bf16 (a yardstick:
    the port calls it on no decode path), cold in L2 like the kernels."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    n_copies = max(2, -(-(128 << 20) // (2 * weights[0].shape[0] * weights[0].shape[1])))
    dense = [q4k.dequant_mxu(w, dtype=torch.bfloat16) for w in weights[:n_copies]]
    return time_ms(lambda w: torch.matmul(x, w.T), dense, torch)


def kernel_phase(torch, dev, cfg) -> list[dict]:
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    cases = [  # (kernel, shape name, N, K): qkv and gate_up fuse the rms_norm
        ("q4k_matvec_normed" if shape in ("qkv_proj", "gateup_proj") else "q4k_matvec", shape,
         n, k) for shape, n, k in decode_shapes(cfg)]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for name, shape, n, k in cases:
        nbytes, weights = cold_weights(torch, dev, g, n, k)
        x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
        norm_w = torch.rand(k, generator=g, device=dev) + 0.5
        if name == "q4k_matvec":
            kern, plain = (lambda w: q4k.q4k_matvec(x, w)), (lambda w: q4k.q4k_matvec_ref(x, w))
        else:
            kern = lambda w: q4k.q4k_matvec_normed(x, w, norm_w, 1e-6)  # noqa: E731
            plain = lambda w: q4k.q4k_matvec_normed_ref(x, w, norm_w, 1e-6)  # noqa: E731
        got, want = kern(weights[0]).float(), plain(weights[0]).float()
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"{name}/{shape}: non-finite output")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= KERNEL_BOUND * scale
        ms = time_ms(kern, weights, torch)
        # every input read once, the output written once; 2 N K int8 operations
        least, by = bound_ms(nbytes + 2 * k + 2 * n + (4 * k if "normed" in name else 0),
                             2 * n * k, "int8")
        row = {"phase": "kernel", "name": name, "shape": shape, "n": n, "k": k,
               "max_abs_err": err, "max_abs_plain": scale,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": ok,
               "ms": ms, "plain_ms": time_ms(plain, weights, torch),
               "bound_ms": least, "bound_by": by,
               "library_ms": dense_matmul_ms(torch, x, weights),
               "library": "torch.matmul on the dequantized bf16 weight (4x the weight "
                          "bytes; without the rms_norm)",
               "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6)}
        emit(row)
        require(ok, f"{name}/{shape}: kernel disagrees with its plain version ({err} > bound)")
        rows.append(row)
        del weights
    return rows


def rel_check(torch, what: str, got, want) -> tuple[float, float]:
    """(max abs error, max |want|); raises past KERNEL_BOUND."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    require(err <= KERNEL_BOUND * scale, f"{what}: {err} > {KERNEL_BOUND} * {scale}")
    return err, scale


def rows_kernel_phase(torch, dev, cfg) -> list[dict]:
    """q4k_matmul_rows at T = 8 and 64 against its plain version and, row
    by row, against q4k_matvec."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows = []
    for shape, n, k in decode_shapes(cfg):
        nbytes, weights = cold_weights(torch, dev, g, n, k)
        for t in ROWS_T:
            x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
            kern = lambda w: q4k.q4k_matmul_rows(x, w)  # noqa: E731
            plain = lambda w: q4k.q4k_matmul_rows_ref(x, w)  # noqa: E731
            got = kern(weights[0])
            err, scale = rel_check(torch, f"q4k_matmul_rows/{shape}/T={t}", got,
                                   plain(weights[0]))
            per_row = torch.cat([q4k.q4k_matvec(x[i:i + 1], weights[0]) for i in range(t)])
            row_err, _ = rel_check(torch, f"q4k_matmul_rows/{shape}/T={t} vs q4k_matvec", got,
                                   per_row)
            ms = time_ms(kern, weights, torch)
            least, by = bound_ms(nbytes + 2 * t * (k + n), 2 * t * n * k, "int8")
            row = {"phase": "kernel_rows", "name": "q4k_matmul_rows", "shape": shape, "t": t,
                   "n": n, "k": k, "max_abs_err": err, "max_abs_plain": scale,
                   "max_abs_err_vs_matvec_rows": row_err,
                   "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
                   "ms": ms, "plain_ms": time_ms(plain, weights, torch),
                   "bound_ms": least, "bound_by": by,
                   "library_ms": dense_matmul_ms(torch, x, weights),
                   "library": "torch.matmul on the dequantized bf16 weight (4x the weight bytes)",
                   "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6)}
            emit(row)
            rows.append(row)
        del weights
    return rows


def attn_kernel_phase(torch, dev, cfg) -> list[dict]:
    """gqa_rows_q8_attention against its plain version at the 1.7B serving
    shape: B = 8 rows over a 2048-slot int8 cache."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn

    b, s_max = 8, 2048
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    caches = []  # copies enough to exceed L2, as a decode step finds the cache
    for _ in range(4):
        k, ks = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
        v, vs = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
        caches.append((k, ks, v, vs))
    q = (torch.randn((b, hq, d), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    scale = d ** -0.5
    rows = []
    for win in (256, 1024, 2048):
        # one row inside tile 0, one at a tile edge, one at win - 1, the rest spread
        spread = torch.randint(0, win, (b - 3,), generator=g, device=dev)
        poss = torch.cat([torch.tensor([5, 255, win - 1], device=dev), spread])
        kern = lambda c: attn.gqa_rows_q8_attention(q, *c, poss, scale, win)  # noqa: E731
        plain = lambda c: attn.gqa_rows_q8_attention_ref(q, *c, poss, scale, win)  # noqa: E731
        err, mag = rel_check(torch, f"gqa_rows_q8_attention/win={win}", kern(caches[0]),
                             plain(caches[0]))
        # each row's live slots (slot <= poss[i]) read once: int8 K and V
        # rows and their two f32 scales per (slot, head); q and out in bf16
        slots = int((poss + 1).sum())
        least, by = bound_ms(slots * hkv * (2 * d + 8) + 2 * 2 * b * hq * d,
                             4 * slots * hq * d, "bf16")
        row = {"phase": "kernel_attn", "name": "gqa_rows_q8_attention", "b": b, "hq": hq,
               "hkv": hkv, "d": d, "s": s_max, "win": win, "poss": poss.tolist(),
               "max_abs_err": err, "max_abs_plain": mag,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
               "ms": time_ms(kern, caches, torch), "plain_ms": time_ms(plain, caches, torch),
               "bound_ms": least, "bound_by": by, "library_ms": None}
        emit(row)
        rows.append(row)
    return rows


def decode_attn_kernel_phase(torch, dev, cfg) -> list[dict]:
    """gqa_decode_attention against its plain version at the 1.7B shape: one
    query over a 2048-slot cache, bf16 (bound KERNEL_BOUND) and f32 (bound
    F32_KERNEL_BOUND), at several positions per window; timed at pos =
    win - 1 beside one scaled_dot_product_attention call on the [:win] views."""
    from qwen3_asr_gguf_tpu_torch.ops import attn

    s_max = 2048
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    scale = d ** -0.5
    q32 = torch.randn((1, hq, d), generator=g, device=dev) * 0.5
    # 16 caches of 8 MB each: a call finds its K/V cold in the 50 MB L2
    caches = [tuple(torch.randn((s_max, hkv, d), generator=g, device=dev).to(torch.bfloat16)
                    for _ in "kv") for _ in range(16)]
    caches32 = tuple(c.float() * (1 + 1e-3 * torch.rand(c.shape, generator=g, device=dev))
                     for c in caches[0])
    rows = []
    for win in (256, 1024, 2048):
        positions = sorted({0, 255, min(256, win - 1), win // 2 + 37, win - 1})
        errs = {"bf16": (0.0, 0.0), "f32": (0.0, 0.0)}
        for name, q, kv, bound in (("bf16", q32.to(torch.bfloat16), caches[0], KERNEL_BOUND),
                                   ("f32", q32, caches32, F32_KERNEL_BOUND)):
            for pos in positions:
                got = attn.gqa_decode_attention(q, *kv, pos, scale, win).float()
                want = attn.gqa_decode_attention_ref(q, *kv, pos, scale, win).float()
                torch.cuda.synchronize()
                what = f"gqa_decode_attention/{name}/win={win}/pos={pos}"
                require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
                err, mag = (got - want).abs().max().item(), want.abs().max().item()
                require(err <= bound * mag, f"{what}: {err} > {bound} * {mag}")
                errs[name] = max(errs[name], (err, mag))
        q = q32.to(torch.bfloat16)
        pos = win - 1
        kern = lambda c: attn.gqa_decode_attention(q, *c, pos, scale, win)  # noqa: E731
        plain = lambda c: attn.gqa_decode_attention_ref(q, *c, pos, scale, win)  # noqa: E731
        q4 = q.permute(1, 0, 2)[None]  # [1, Hq, 1, d]

        def sdpa(c):  # every slot of the window is live at pos = win - 1: no mask
            k4, v4 = (t[:win].permute(1, 0, 2)[None] for t in c)
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=scale, enable_gqa=True)

        lib_err = (sdpa(caches[0])[0].permute(1, 0, 2).float()
                   - plain(caches[0]).float()).abs().max().item()
        # the live K and V rows (slot <= pos) read once, q read, out written
        least, by = bound_ms(2 * (pos + 1) * hkv * d * 2 + 2 * 2 * hq * d,
                             4 * (pos + 1) * hq * d, "bf16")
        row = {"phase": "kernel_attn_decode", "name": "gqa_decode_attention", "hq": hq,
               "hkv": hkv, "d": d, "s": s_max, "win": win, "positions": positions,
               "max_abs_err": errs["bf16"][0], "max_abs_plain": errs["bf16"][1],
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
               "f32_max_abs_err": errs["f32"][0], "f32_max_abs_plain": errs["f32"][1],
               "f32_bound": f"max_abs_err <= {F32_KERNEL_BOUND} * max_abs_plain",
               "timed_pos": pos, "ms": time_ms(kern, caches, torch),
               "plain_ms": time_ms(plain, caches, torch), "bound_ms": least, "bound_by": by,
               "library_ms": time_ms(sdpa, caches, torch),
               "library": "scaled_dot_product_attention(enable_gqa=True) on the [:win] views",
               "library_max_abs_diff_vs_plain": lib_err}
        emit(row)
        rows.append(row)
    return rows


def rows_step_check(torch, engine, kv_dtype) -> dict:
    """One batched decode step (B = 8) through the kernels against the same
    step on dense dequantized bf16 weights with the plain attention, from
    the same prefilled caches."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn
    from qwen3_asr_gguf_tpu_torch.ops.q4k import dequant_mxu

    gen, dev = engine.generator, engine.device
    cfg, dense = gen.cfg, gen.prefill_params
    b = 8
    lens = [40 + 24 * i for i in range(b)]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    caches = dec.init_cache(cfg, 512, kv_dtype, device=dev, rows=b)
    last = []
    for i, t in enumerate(lens):
        ids = torch.randint(0, cfg.vocab_size, (t,), generator=g, device=dev)
        lane = {name: [c[i] for c in cs] for name, cs in caches.items()}
        dec.forward_prefill(dense, cfg, dec.embed_tokens(dense, ids), lane)
        last.append(ids[-1])
    twin = {name: [c.clone() for c in cs] for name, cs in caches.items()}
    embd = dec.embed_tokens(dense, torch.stack(last))
    poss = torch.tensor(lens, device=dev)
    before = attn.gqa_rows_q8_attention.launches
    h_k, _ = dec.forward_step_rows(gen.params["layers"], gen.params["final_norm"], cfg, embd,
                                   caches, poss, attn_window=512)
    lk = dec.lm_logits(gen.params, h_k, cfg.vocab_size)
    kernel_attn = attn.gqa_rows_q8_attention.launches - before
    fast = attn.gqa_rows_q8_attention
    attn.gqa_rows_q8_attention = attn.gqa_rows_q8_attention_ref  # the plain attention
    try:
        h_d, _ = dec.forward_step_rows(dense["layers"], dense["final_norm"], cfg, embd, twin,
                                       poss, attn_window=512)
    finally:
        attn.gqa_rows_q8_attention = fast
    ld = dec.lm_logits({"lm_head": dequant_mxu(gen.params["lm_head"])}, h_d, cfg.vocab_size)
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=1)
    finite = bool(torch.isfinite(lk).all())
    row = {"phase": "rows_step_check", "kv": str(kv_dtype).replace("torch.", ""), "rows": b,
           "logits": list(lk.shape), "finite": finite,
           "cosine_kernel_vs_dense_min": cos.min().item(), "cosine_per_row": cos.tolist(),
           "rows_attention_launches": kernel_attn, "bound": STEP_COSINE_BOUND}
    emit(row)
    require(finite and tuple(lk.shape) == (b, cfg.vocab_size), "rows-step logits malformed")
    require(cos.min().item() >= STEP_COSINE_BOUND,
            f"rows step ({kv_dtype}): cosine {cos.min().item()} < {STEP_COSINE_BOUND}")
    require(kv_dtype != torch.int8 or kernel_attn == cfg.num_layers,
            f"rows step: {kernel_attn} rows-attention launches, want one per layer")
    return row


def tone(seconds: float, freq: float):
    import numpy as np

    t = np.arange(int(seconds * 16_000)) / 16_000
    return (np.sin(2 * np.pi * freq * t) * 0.3).astype(np.float32)


def wav_bytes(audio) -> bytes:
    import io
    import wave

    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def post_transcription(url: str, audio, response_format: str) -> tuple[int, str, float]:
    """(status, body, seconds) of one multipart POST."""
    import urllib.request

    bd = "chipsmokeboundary"
    fields = {"response_format": response_format, "language": "zh"}
    body = (f'--{bd}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
            "Content-Type: audio/wav\r\n\r\n").encode() + wav_bytes(audio)
    for name, value in fields.items():
        body += (f'\r\n--{bd}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                 f"{value}").encode()
    body += f"\r\n--{bd}--\r\n".encode()
    req = urllib.request.Request(f"{url}/v1/audio/transcriptions", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={bd}"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read().decode("utf-8"), time.time() - t0


def get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        require(r.status == 200, f"GET {url}: {r.status}")
        return json.loads(r.read())


def serve_phase(torch, dev, model_dir: Path) -> dict:
    """The port's server, built by its CLI from real arguments, on HTTP:
    16 concurrent 10 s requests (8 tones, json and text) and one 50.2 s
    request (two chunks with memory through successive rows)."""
    from http.server import ThreadingHTTPServer

    from qwen3_asr_gguf_tpu_torch.cli import serve
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k

    argv = ["--model-dir", str(model_dir), "--max-batch", "8", "--n-ctx", "2048",
            "--chunk-size", "40", "--device", str(dev)]
    t0 = time.time()
    # the engine settings of the asr phase: random weights would decode 512 tokens
    server, engine, batcher = serve.build(argv, max_new_tokens=96, decode_block=96)
    init_s = time.time() - t0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        require(get_json(f"{url}/health") == {"status": "ok"}, "/health")
        models = get_json(f"{url}/v1/models")
        require(models["data"][0]["id"] == serve.MODEL_NAME, f"/v1/models: {models}")
        jobs = [(tone(SERVE_CLIP_SECONDS, 200 + 50 * (i % 8)), "json" if i % 2 else "text")
                for i in range(SERVE_REQUESTS)]
        jobs.append((synthetic_clip(CLIP_SECONDS), "json"))
        for counter in (q4k.q4k_matvec, q4k.q4k_matvec_normed, q4k.q4k_matmul_rows,
                        attn.gqa_rows_q8_attention):
            counter.launches = 0
        blocks0 = batcher.stats["n_blocks"]
        t0 = time.time()
        with ThreadPoolExecutor(len(jobs)) as pool:
            results = list(pool.map(lambda j: post_transcription(url, *j), jobs))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"q4k_matmul_rows": q4k.q4k_matmul_rows.launches,
                    "q4k_matvec": q4k.q4k_matvec.launches,
                    "q4k_matvec_normed": q4k.q4k_matvec_normed.launches,
                    "gqa_rows_q8_attention": attn.gqa_rows_q8_attention.launches}
        stats = get_json(f"{url}/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    texts = []
    for (audio, fmt), (status, body, _) in zip(jobs, results):
        require(status == 200, f"POST answered {status}: {body[:200]}")
        texts.append(json.loads(body)["text"] if fmt == "json" else body)
    require(all(isinstance(t, str) and t for t in texts), "an empty transcript")
    lat = sorted(r[2] for r in results)
    audio_s = sum(len(a) for a, _ in jobs) / 16_000
    steps = (stats["batching"]["n_blocks"] - blocks0) * batcher.block
    row = {"phase": "serve", "kv": "bf16", "argv": argv, "engine_init_s": init_s,
           "requests": len(jobs), "audio_s": audio_s, "wall_s": wall,
           "s_audio_per_s": audio_s / wall, "latency_p50_s": lat[len(lat) // 2],
           "latency_p95_s": lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)],
           "text_chars_min": min(len(t) for t in texts), "batcher": stats["batching"],
           "decode_steps": steps, "launches": launches,
           "rows_matmul_launches_per_step": launches["q4k_matmul_rows"] / max(steps, 1)}
    emit(row)
    require(launches["q4k_matmul_rows"] > 0, f"the multi-row matmul never launched: {launches}")
    del server, engine, batcher
    torch.cuda.empty_cache()
    return row


def serve_int8_phase(torch, dev, model_dir: Path) -> dict:
    """A continuous batcher on an int8-KV engine: 16 greedy 10 s requests."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher

    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4",
        n_ctx=2048, chunk_size=40.0, verbose=False, kv_cache_dtype="int8",
    ), device=dev)
    batcher = ContinuousBatcher(engine, max_batch=8, block=16, max_new_tokens=32)
    audios = [tone(SERVE_CLIP_SECONDS, 200 + 50 * (i % 8)) for i in range(SERVE_REQUESTS)]
    try:
        q4k.q4k_matmul_rows.launches = 0
        attn.gqa_rows_q8_attention.launches = 0
        t0 = time.time()
        with ThreadPoolExecutor(len(audios)) as pool:
            results = list(pool.map(
                lambda a: batcher.submit(a, language="Chinese", temperature=0.0), audios))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"q4k_matmul_rows": q4k.q4k_matmul_rows.launches,
                    "gqa_rows_q8_attention": attn.gqa_rows_q8_attention.launches}
        stats = batcher.stats
    finally:
        batcher.close()
    row = {"phase": "serve_int8_kv", "requests": len(audios),
           "audio_s": len(audios) * SERVE_CLIP_SECONDS, "wall_s": wall,
           "s_audio_per_s": len(audios) * SERVE_CLIP_SECONDS / wall,
           "text_chars_min": min(len(r.text) for r in results), "batcher": stats,
           "launches": launches}
    emit(row)
    require(all(r.text for r in results), "an empty transcript")
    require(all(c > 0 for c in launches.values()), f"a rows kernel never launched: {launches}")
    del engine, batcher
    torch.cuda.empty_cache()
    return row


def ensure_checkpoint() -> Path:
    from qwen3_asr_gguf_tpu_torch import native
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    t0 = time.time()
    if not native.available() and shutil.which("g++"):
        native.build(verbose=False)
    native_s = time.time() - t0
    out = REPO / ".bench_cache" / "torch" / PRESET
    files = ("qwen3_asr_encoder.safetensors", "qwen3_asr_llm.q4_k.gguf", "config.json",
             "mel_filters.npy")
    t1 = time.time()
    built = not all((out / f).exists() for f in files)
    if built:
        make_synthetic_checkpoint(str(out), PRESET, quant="q4_k", seed=0)
    t2 = time.time()
    # the 0.6B forced aligner in the same directory, as the JAX bench lays it out
    aligner_files = ("qwen3_aligner_encoder.safetensors", "qwen3_aligner_llm.q4_k.gguf")
    aligner_built = not all((out / f).exists() for f in aligner_files)
    if aligner_built:
        make_synthetic_checkpoint(str(out), ALIGNER_PRESET, quant="q4_k", aligner=True, seed=1)
    emit({"phase": "checkpoint", "preset": PRESET, "aligner_preset": ALIGNER_PRESET,
          "native_codec": native.available(), "native_build_s": native_s, "built": built,
          "seconds": t2 - t1, "aligner_built": aligner_built,
          "aligner_seconds": time.time() - t2})
    return out


def synthetic_clip(seconds: float):
    import numpy as np

    t = np.arange(int(seconds * 16_000)) / 16_000
    return (np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t) * 0.3).astype(np.float32)


def decode_step_check(torch, engine) -> None:
    """One decode step through the kernels (the int4 matvecs and the decode
    attention) vs the same step on dense dequantized bf16 weights with the
    plain attention, from the same prefilled cache."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn
    from qwen3_asr_gguf_tpu_torch.ops.q4k import dequant_mxu

    gen = engine.generator
    cfg = gen.cfg
    dense = gen.prefill_params
    g = torch.Generator(device=engine.device)
    g.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (64,), generator=g, device=engine.device)
    cache = gen.new_cache()
    dec.forward_prefill(dense, cfg, dec.embed_tokens(dense, ids), cache)
    twin = {k: [t.clone() for t in v] for k, v in cache.items()}
    embd = dense["embed"][int(ids[-1])]
    before = attn.gqa_decode_attention.launches
    h_k, _ = dec.forward_step_layers(gen.params["layers"], gen.params["final_norm"], cfg,
                                     embd, cache, 64, attn_window=256)
    kernel_attn = attn.gqa_decode_attention.launches - before
    fast = attn.gqa_decode_attention
    attn.gqa_decode_attention = attn.gqa_decode_attention_ref  # the plain attention
    try:
        h_d, _ = dec.forward_step_layers(dense["layers"], dense["final_norm"], cfg, embd, twin,
                                         64, attn_window=256)
    finally:
        attn.gqa_decode_attention = fast
    lk = dec.lm_logits(gen.params, h_k, cfg.vocab_size)
    ld = dec.lm_logits({"lm_head": dequant_mxu(gen.params["lm_head"])}, h_d, cfg.vocab_size)
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    finite = bool(torch.isfinite(lk).all())
    emit({"phase": "decode_step_check", "logits": list(lk.shape), "finite": finite,
          "cosine_kernel_vs_dense": cos, "bound": STEP_COSINE_BOUND,
          "decode_attention_launches": kernel_attn})
    require(finite and lk.shape == (cfg.vocab_size,), "decode-step logits malformed")
    require(kernel_attn == cfg.num_layers,
            f"decode step: {kernel_attn} decode-attention launches, want one per layer")
    require(cos >= STEP_COSINE_BOUND, f"decode step: cosine {cos} < {STEP_COSINE_BOUND}")


ALIGN_CHECK_TEXT = "the quick brown fox jumps over the lazy dog near the bank"  # 12 words


def align_check(torch, engine, model_dir: Path) -> None:
    """The aligner's sparse logits on the card (dense bf16 layers) against
    the same runner on the CPU in f32 from the same GGUF, on one prompt: a
    10 s tone and a fixed 12-word text. Random weights give flat logits, so
    the rows are compared by cosine, not by argmax."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.runtime.generate import SparseLogitsRunner
    from qwen3_asr_gguf_tpu_torch.text import align_text

    aligner = engine.aligner
    audio = tone(10.0, 440.0)
    t0 = time.time()
    audio_embd = aligner.encoder.encode(audio)
    words = align_text.tokenize(ALIGN_CHECK_TEXT, "English")
    ids, mask, positions = aligner._prompt(words, aligner.encoder.valid_tokens(len(audio)))
    dev = aligner.device
    embd = dec.splice_prompt(aligner.runner.params, torch.from_numpy(ids).long().to(dev),
                             torch.from_numpy(mask).to(dev), audio_embd).float().cpu().numpy()
    got = aligner.runner.logits_at(embd, positions)
    card_s = time.time() - t0
    t0 = time.time()
    cfg, params, _ = P.load_decoder_gguf(
        str(model_dir / aligner.config.llm_fn), precision="f32", device="cpu")
    cpu = SparseLogitsRunner(P.fuse_layer_weights(params), cfg, n_ctx=aligner.config.n_ctx,
                             device="cpu")
    want = cpu.logits_at(embd, positions)
    cpu_s = time.time() - t0
    a, b = torch.from_numpy(got), torch.from_numpy(want)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    finite = bool(torch.isfinite(a).all())
    emit({"phase": "align_check", "words": len(words), "prompt_tokens": len(ids),
          "rows": list(a.shape), "finite": finite, "cosine_card_vs_cpu_f32_min": cos.min().item(),
          "argmax_equal_share": (a[:, :4000].argmax(1) == b[:, :4000].argmax(1)).float().mean().item(),
          "bound": STEP_COSINE_BOUND, "card_s": card_s, "cpu_s": cpu_s})
    require(len(words) == 12 and a.shape == (24, cfg.lm_head_dim), f"align rows {a.shape}")
    require(finite, "align logits not finite")
    require(cos.min().item() >= STEP_COSINE_BOUND,
            f"align logits: cosine {cos.min().item()} < {STEP_COSINE_BOUND}")


def check_alignment(res, clip_seconds: float) -> int:
    """The headline call's alignment: one item per word of the transcript
    (plus the punctuation pieces reconciled back in), ordered by start time,
    start <= end; returns the number of items."""
    from qwen3_asr_gguf_tpu_torch.text import align_text

    from qwen3_asr_gguf_tpu_torch.runtime.aligner import STEP_MS, TIMESTAMP_CLASSES

    require(res.alignment is not None and res.alignment.items, "no alignment returned")
    items = res.alignment.items
    n_words = sum(1 for it in items if align_text.tokenize(it.text, "Chinese"))
    want = len(align_text.tokenize(res.text, "Chinese"))
    require(n_words == want, f"{n_words} aligned words for {want} words of the transcript")
    starts = [it.start_time for it in items]
    require(starts == sorted(starts), "alignment start times decrease")
    # a trained aligner keeps every time inside the clip; random weights pick
    # any of the timestamp classes, so the bound a run can hold them to is
    # the classes' own span past the latest window offset (the clip's end)
    latest = clip_seconds + TIMESTAMP_CLASSES * STEP_MS / 1000.0
    for it in items:
        require(it.start_time <= it.end_time, f"item {it.text!r}: start after end")
        require(0.0 <= it.start_time and it.end_time <= latest,
                f"item {it.text!r}: [{it.start_time}, {it.end_time}] outside [0, {latest}]")
    return len(items)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine, preset
    from qwen3_asr_gguf_tpu_torch.ops import _build, attn, q4k
    from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.time()
    _build.build(force=True)
    _build.lib()
    emit({"phase": "build", "seconds": time.time() - t0, "nvcc": _build.find_nvcc(),
          "flags": _build.NVCC_FLAGS, "lib": str(_build.LIB_PATH.relative_to(REPO))})

    cfg = preset(PRESET)
    kernel_rows = kernel_phase(torch, dev, cfg.text)
    kernel_rows += rows_kernel_phase(torch, dev, cfg.text)
    kernel_rows += attn_kernel_phase(torch, dev, cfg.text)
    kernel_rows += decode_attn_kernel_phase(torch, dev, cfg.text)

    model_dir = ensure_checkpoint()
    t0 = time.time()
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4",
        n_ctx=2048, chunk_size=40.0, memory_num=1, verbose=False, max_new_tokens=96,
        decode_block=96, kv_prefix_reuse=True, kv_cache_dtype="bf16", enable_aligner=True,
        align_config=AlignerConfig(model_dir=str(model_dir),
                                   llm_fn="qwen3_aligner_llm.q4_k.gguf", precision="int8",
                                   n_ctx=2048),
    ), device=dev)
    emit({"phase": "engine_init", "seconds": time.time() - t0,
          "gpu_mem_gb": torch.cuda.memory_allocated(dev) / 1e9})

    audio = synthetic_clip(CLIP_SECONDS)
    t0 = time.time()
    engine.asr(audio, context="", language="Chinese", temperature=0.4)
    torch.cuda.synchronize()
    emit({"phase": "warmup", "seconds": time.time() - t0})

    main_path = (q4k.q4k_matvec, q4k.q4k_matvec_normed, attn.gqa_decode_attention)

    def timed_asr(temp: float):
        """(result, wall seconds, launches of the path's kernels) of one call."""
        for wrapper in main_path:
            wrapper.launches = 0
        t0 = time.time()
        res = engine.asr(audio, context="", language="Chinese", temperature=temp)
        torch.cuda.synchronize()
        return res, time.time() - t0, {w.__name__: w.launches for w in main_path}

    launches = {}
    for temp in (0.4, 0.0):
        torch.cuda.reset_peak_memory_stats(dev)
        res, wall, counts = timed_asr(temp)
        perf = res.performance
        n_align_items = check_alignment(res, CLIP_SECONDS)
        row = {"phase": "asr", "temperature": temp, "audio_s": CLIP_SECONDS, "wall_s": wall,
               "rtf": wall / CLIP_SECONDS, "prefill_tokens": perf["prefill_tokens"],
               "decode_tokens": perf["decode_tokens"], "prefill_s": perf["prefill_time"],
               "decode_s": perf["decode_time"], "encode_s": perf["encode_time"],
               "decode_tok_per_s": perf["decode_tokens"] / max(perf["decode_time"], 1e-9),
               "text_chars": len(res.text), "launches": counts,
               "n_align_items": n_align_items, "align_enc_time": perf["align_enc_time"],
               "align_dec_time": perf["align_dec_time"],
               # two normed matvecs (qkv, gate_up) per layer per decode step;
               # unlike decode_tokens (the final attempt of each chunk) this
               # includes the steps of breaker retries
               "decode_steps": counts["q4k_matvec_normed"] // (2 * cfg.text.num_layers),
               "peak_gpu_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        emit(row)
        require(perf["decode_tokens"] > 0, "no decode tokens")
        require(isinstance(res.text, str) and len(res.text) > 0, "empty transcript")
        require(all(c > 0 for c in counts.values()), f"a kernel never launched: {counts}")
        require(counts["gqa_decode_attention"] == cfg.text.num_layers * row["decode_steps"],
                f"decode attention: {counts['gqa_decode_attention']} launches for "
                f"{row['decode_steps']} decode steps of {cfg.text.num_layers} layers")
        require(math.isfinite(wall), "wall time not finite")
        if temp == 0.4:
            launches = counts

    # the same call without the aligner, and with the plain decode attention
    # in place of the kernel: host-clock times compare only inside one run
    aligner, fast = engine.aligner, attn.gqa_decode_attention
    compare = {"aligned_kernel": timed_asr(0.4)[1]}
    engine.aligner = None
    compare["aligner_off"] = timed_asr(0.4)[1]
    engine.aligner = aligner
    attn.gqa_decode_attention = attn.gqa_decode_attention_ref
    try:
        _, compare["aligned_plain_attention"], plain_counts = timed_asr(0.4)
    finally:
        attn.gqa_decode_attention = fast
    compare["aligned_kernel_again"] = timed_asr(0.4)[1]
    emit({"phase": "asr_compare", "temperature": 0.4, "audio_s": CLIP_SECONDS,
          "wall_s": compare, "rtf": {k: v / CLIP_SECONDS for k, v in compare.items()}})
    require(plain_counts["gqa_decode_attention"] == 0, "the plain attention launched the kernel")

    decode_step_check(torch, engine)
    align_check(torch, engine, model_dir)
    emb = engine.encoder.encode(torch.from_numpy(audio[: 40 * 16_000]).to(dev))
    n_tok = engine.encoder.valid_tokens(40 * 16_000)
    require(tuple(emb.shape) == (n_tok, cfg.audio.output_dim), f"encoder shape {tuple(emb.shape)}")
    require(bool(torch.isfinite(emb).all()), "encoder output not finite")
    emit({"phase": "encoder_check", "shape": list(emb.shape), "finite": True})

    for kv in (torch.bfloat16, torch.int8):
        rows_step_check(torch, engine, kv)
    del engine
    torch.cuda.empty_cache()

    served = serve_phase(torch, dev, model_dir)
    served_int8 = serve_int8_phase(torch, dev, model_dir)
    # each kernel's launches from the run of its own path
    launches["q4k_matmul_rows"] = served["launches"]["q4k_matmul_rows"]
    launches["gqa_rows_q8_attention"] = served_int8["launches"]["gqa_rows_q8_attention"]
    paths = {"q4k_matvec": "asr (temperature 0.4)", "q4k_matvec_normed": "asr (temperature 0.4)",
             "gqa_decode_attention": "asr (temperature 0.4)",
             "q4k_matmul_rows": "serve (bf16 KV)", "gqa_rows_q8_attention": "serve_int8_kv"}

    def case(r):
        if "t" in r:
            return f"{r['shape']}/T={r['t']}"
        return r.get("shape") or f"win={r['win']}"

    def total(rows, key):
        return None if any(r[key] is None for r in rows) else sum(r[key] for r in rows)

    timed = ("ms", "plain_ms", "bound_ms", "library_ms")
    kernels = []
    for name in REPLACES:
        mine = [r for r in kernel_rows if r["name"] == name]
        # one call at each of the kernel's main-path shapes, summed: the
        # multi-row matmul at T = 8 (the serving batch), the attention
        # kernels at the 1024-slot window
        summed = [r for r in mine if r.get("t", ROWS_T[0]) == ROWS_T[0]
                  and r.get("win", ATTN_HEADLINE_WIN) == ATTN_HEADLINE_WIN]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name], "path": paths[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{key: total(summed, key) for key in timed},
            "bound_by": summed[0]["bound_by"],
            "shapes": {case(r): {**{key: r[key] for key in timed},
                                 "max_abs_err": r["max_abs_err"]} for r in mine},
        })
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
