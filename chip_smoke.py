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
   the fused-norm matvec also bit-equal to q4k_matvec on the normed row its
   prologue builds, and on an f32 row within 1e-5 of its kernel-order plain
   version; the single-token decode attention the same way over a 2048-slot bf16
   cache (windows 256, 1024, 2048; an f32 cache too; `pos` a device tensor,
   timed at win - 1 and mid-window; one CUDA graph of it replayed at three
   other positions), beside one scaled_dot_product_attention call;
4. builds the native codec (when g++ is present) and random-weight
   qwen3-asr-1.7b and qwen3-forced-aligner-0.6b q4_k checkpoints in
   .bench_cache/torch/;
5. QwenASREngine at the bench headline settings (int4, bf16 KV, 40 s chunks,
   decode_block = max_new_tokens = 96, KV prefix reuse, the 0.6B forced
   aligner at int8) on a 50.2 s synthetic clip: one warm-up pass, then
   temperature 0.4 and 0, each with the kernels' launch counts of that run
   and the checks on the returned alignment (one block per chunk: the
   pipelined chunk dispatch with the align worker); then, for comparison
   inside this run only, the same call with the aligner off, with the plain
   decode attention and with `pipelined_dispatch` off (the synchronous
   flow); the pipelined flow against the synchronous one at 15 greedy
   tokens per chunk (phase asr_pipeline: text, per-chunk tokens and aligned
   items equal, or parted at a near-tie within 2 bf16 ulp; the alignments
   taken speculatively; each flow timed twice); and the chunk dispatch and
   a decode block queued behind it under
   torch.cuda.set_sync_debug_mode("error") (phase block_sync_free: nothing
   in them waits for the card);
6. one full-width decode step through the kernels against the same step on
   dense dequantized weights with the plain attention (cosine bound), finite
   encoder output, and the aligner's sparse logits on the card against an
   f32 CPU runner of the same checkpoint (cosine bound);
7. the multi-row q4_k matmul against its plain version and, row by row,
   against the matvec kernel, at T = 8 (the serving batch) and T = 64, and at
   T = 16 and 32 at o_proj and the LM head, and the int8-KV rows attention
   against its plain version at B = 8 over a 2048-slot cache, windows 256,
   1024 and 2048, at spread and mid-window row positions (`poss` on the
   card; an f32 q within 1e-5 of the kernel-order plain version; one CUDA
   graph replayed at three other row sets); both timed as in phase 3;
8. one batched decode step (forward_step_rows, B = 8) through the kernels
   against the same step on dense weights with the plain attention, from
   the same prefilled caches, for bf16 and int8 KV (cosine bound); then the
   engine's greedy text against a ContinuousBatcher's at max_batch 8 on one
   40 s chunk, 15 new tokens (phase batcher_vs_engine: where they part, a
   near-tie within 2 bf16 ulp), and max_batch 4 on whole 8-row tiles of the
   multi-row kernel (113 launches per batched step; 72 rows refused); then
   a cohort of 16 greedy requests (3, 10 and 40 s tones and the clip's
   second chunk with memory) staged at the server's defaults with bf16 and
   int8 KV (phase cohort_prefill): the batched admission prefill (one lanes
   pass of the decoder, one LM-head call) against the engine's prefill of
   each prompt alone, KV rows and logits within 0.01 of max|engine| and the
   first tokens equal or parted at a near-tie, both timed;
9. the port's OpenAI-compatible server, built by its CLI's build function
   from real arguments (continuous batching, 8 rows, bf16 KV), answering 16
   concurrent 10 s requests and one 50.2 s request over HTTP, with
   throughput, latency and the batcher's counters;
10. a continuous batcher on an int8-KV engine (the `tools/bench_serve.py
   --kv int8` configuration): 16 greedy 10 s requests;
11. the fused int4 dequant + matmul (q4_matmul) against its plain version at
   the 1.7B decode shapes (qkv, o, gate_up, down, the padded LM head) at
   T = 1 (the engine's step), 8 (a server's rows step) and 64, and the
   encoder's fc1, fc2 and q_w at T = 26 and 52, and the fused int8
   MLP (fused_mlp_matvec) at (D, M) = (2048, 6144) and (1024, 3072) with the
   number of flipped requantized values; both timed as in phase 3;
12. QwenASREngine at precision "int8" (bf16 KV, aligner off) on the same
   clip: the fused MLP and the decode attention once per layer per step, a
   step check against dense weights with the unfused MLP, and the same call
   with fused_mlp=False;
13. QwenASREngine at precision "q4_k": q4_matmul 4 x 28 + 1 times per decode
   step and once per prefill, and the same step check;
14. StreamingTranscriber on the q4_k engine (the `tools/bench_stream.py`
   settings: 2 s chunks, 16 new tokens per step, greedy): a 12 s clip, time
   to first text and the per-chunk latencies, and a second transcriber fed
   the same PCM;
15. the server at `--prec q4_k --max-batch 8` answering 8 concurrent 10 s
   requests over HTTP: q4_matmul at 8 rows on every product of the batched
   step, and once per staged cohort for its first tokens;
16. the server from `--timestamp` (int4, 8 rows, the 0.6B aligner at int4):
   8 concurrent 10 s requests as verbose_json and srt and the 50.2 s clip,
   aligned on the continuous batcher's align pool; items on every answer
   with text, in order and in bounds; q4k_matmul_rows on every product of a
   batched step;
17. the server at `--batch-mode micro`, at the default `--prec int4` (served
   at int8) and at `--prec q4_k`: 8 concurrent 10 s requests through the
   MicroBatcher, each batched row's tokens against the engine's greedy
   tokens by the near-tie rule; at q4_k q4_matmul 113 times per rows step
   and once per batch (and as the engine runs a lone request); at int8 one
   batched rows step at 2 and 8 rows through torch._int_mm, bit-equal to
   the exact f64 route, both timed;
18. QwenASREngine at precision "bf16" on a 1.7B f16 GGUF (its own directory
   under .bench_cache/torch/): kernel 4 once per layer per decode step, timed
   as phase 12, and the step check against the plain attention;
19. `cli/transcribe.py` with `--timestamp` on a wav of the 50.2 s clip: its
   .txt, .srt and .json, the items in order and in bounds, kernels 1, 2 and 4
   launched;
20. `cli/quant_accuracy.py` on the 1.7B checkpoint: the bars (encoder int4
   cosine >= 0.96, decoder hidden cosine >= 0.90), q4_matmul once per
   `Q4Weight` product of its 64-row q4_k prefill;
21. `cli/perplexity.py --compare f32` on the 1.7B q4_k GGUF over README.md
   (window 512, 2048 tokens): |delta| <= 9%, each precision timed, and the
   first window's f32 perplexity on the card within 1e-3 of the CPU's;
22. `cli/demo_streaming.py` (int8): two sessions over HTTP at once, 12 s each
   in 2 s base64 chunks; each final text equal to a StreamingTranscriber's
   alone on the same engine; fused_mlp_matvec and gqa_decode_attention once
   per layer per decode step;
23. a seeded bf16 Hugging Face-layout qwen3-asr-0.6b directory converted by
   `python -m qwen3_asr_gguf_tpu_torch.export --hf` and by
   `cli/verify_weights.py verify(quant="q4_k")`: convert, load, both
   fidelity stages PASS, the oracle SKIP (the reference modeling is
   absent); the decode attention in the load stage, q4_matmul in the
   fidelity stage;
24. the example twins: `examples.run_asr` on a wav of the 50.2 s clip
   (kernels 1, 2, 4) and `examples.run_aligner` on a 10 s tone and 12 words;
25. the kernels that one q4k_matvec call puts on the device (torch.profiler:
   one) and one q4k_matvec_normed call (one: the rms_norm is in its
   prologue), at each decode shape, and one fused_mlp_matvec call (one
   cooperative launch) at both MLP shapes; the device kernels of one
   cohort_prefill batched call and of the lane-by-lane loop it replaces
   (phase cohort_kernels); then one 96-step decode block of
   the headline engine (timed before these sessions) in one profiler window
   (phase block_profile: ms per step, device kernels per step, busy time,
   the card's idle share): last, so that no profiler session precedes a
   timed phase, and none follows the block's large window; and the two
   device kernels of one expert_matvec call (phase moe_device_kernels);
26. (before the tp phases) kernel 8, the routed-expert int4 matvec, against
   its plain version at Moonlight-16B-A3B's widths (8 slots of
   [1408, 2048]: 6 routed experts and the shared SwiGLU's two halves), bf16
   and f32 x, timed as phase 3 beside its bound and a torch.bmm yardstick,
   and launched from the host; then QwenASREngine on the
   qwen3-asr-1.7b-moonlight-16b-a3b preset (its checkpoint written on the
   card by the benchmark's writer, `benchmark/architectures/mla_moe.py`) at
   the benchmark cell's engine settings on the clip: kernel 8 once per MoE
   layer per decode step and kernel 6 once per layer per step, counted from
   0 just before the call, every step a graph replay (phase moe_asr); and
   its chunk dispatch and a block behind it under
   set_sync_debug_mode("error") (phase moe_sync_free);
27. (after encoder_check) the audio encoder replayed as a CUDA graph per
   input key (phase encode_graph): the 1.7B's int4 tower and the 0.6B
   aligner's int8 tower of the checkpoint and a random 0.6B int4 tower, at
   the keys the cells meet (the aligned 40 s chunk, the aligner's 4,500-frame
   bucket at two lengths, the stream's buckets) and a 2 s aligned key whose
   products all run kernel 6; per key the eager and the replayed encode
   timed, graph against eager bit for bit, and kernel 6's launches of a
   replay equal to an eager encode's (a capture's launches count once per
   replay); then, in a process of its own, the device kernels of one eager
   encode and of one replay at each tower's first key.

Every kernel's launches are counted in the run of its path (counts set to 0
just before it). The last lines are the kernels summary, the nvidia-smi
line and {"ok": true, "device": {...}}. Without a CUDA device, or run where
the package is missing, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
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
ROWS_T_BETWEEN = (16, 32)  # timed at o_proj and the LM head only
QMM_DECODE_T = (1, 8, 64)  # q4_matmul rows on the decode shapes: engine step, rows step, most
SERVE_CLIP_SECONDS = 10.0
SERVE_REQUESTS = 16
ALIGNER_PRESET = "qwen3-forced-aligner-0.6b"
F32_KERNEL_BOUND = 1e-4  # the decode attention over an f32 cache (sums in another order)
F32_ORDER_BOUND = 1e-5  # f32 outputs against the plain versions that repeat a kernel's order
ATTN_HEADLINE_WIN = 1024  # the attention window whose time stands in the kernels line
MOE_CONFIG = "benchmark/configs/qwen3-asr-1.7b-moonlight-16b-a3b-int4.json"
MOE_EXPERTS, MOE_WIDTH, MOE_SLOTS = 66, 1408, 8  # 64 routed + 2 shared halves; top 6 + 2
MOE_COPIES = 8  # copies of the experts cycled in the timed graph (8 x 39 MB a call >> L2)
ENCODE_GRAPH_KEYS = {  # tower: (samples, bucketed) of each case, one key or two lengths of one
    "1.7b": ((40 * 16_000, False), (2 * 16_000, False), (41 * 16_000 + 555, False),
             (44 * 16_000 + 7, False)),
    "aligner": ((41 * 16_000 + 555, False), (44 * 16_000 + 7, False), (12 * 16_000 + 5, False)),
    "0.6b": ((2 * 16_000, True), (20 * 16_000 + 160, True), (48 * 16_000, True),
             (60 * 16_000, True)),
}
ENCODE_TIMED_RUNS = (5, 20)  # eager, replayed: encodes per median
REPLACES = {
    "q4k_matvec": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:324",
    "q4k_matvec_normed": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:594",
    "q4k_matmul_rows": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:419",
    "gqa_decode_attention": "qwen3_asr_gguf_tpu/ops/pallas_attn.py:94",
    "gqa_rows_q8_attention": "qwen3_asr_gguf_tpu/ops/pallas_attn.py:215",
    "q4_matmul": "qwen3_asr_gguf_tpu/ops/pallas_qmm.py:85",
    "fused_mlp_matvec": "qwen3_asr_gguf_tpu/ops/pallas_mlp.py:85",
}
SOURCES = {
    "q4k_matvec": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matvec.cu",
    "q4k_matvec_normed": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matvec.cu",
    "q4k_matmul_rows": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matmul_rows.cu",
    "gqa_decode_attention": "qwen3_asr_gguf_tpu_torch/csrc/attn_decode.cu",
    "gqa_rows_q8_attention": "qwen3_asr_gguf_tpu_torch/csrc/attn_rows_q8.cu",
    "q4_matmul": "qwen3_asr_gguf_tpu_torch/csrc/q4_matmul.cu",
    "fused_mlp_matvec": "qwen3_asr_gguf_tpu_torch/csrc/fused_mlp.cu",
}
QMM_ENCODER_T = (26, 52)  # encoder rows of 2 s and 4 s of audio
MLP_FLIP_LIMIT = 4  # requantized act values that may differ from the plain version's
STREAM_SECONDS, STREAM_CHUNK_SECONDS, STREAM_NEW_TOKENS = 12.0, 2.0, 16
BATCH_NEW_TOKENS = 15  # batcher_vs_engine: below the breaker's 16-token window
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # f32: outside the tensor cores


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


_EMIT_LOCK = threading.Lock()


def emit(obj: dict) -> None:
    """One JSON line on stdout, whole even when phases run on two threads."""
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


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
    nbytes = n * k // 2 + 2 * (k // 32) * n + 4 * (k // 128) * n
    return nbytes, [random_q4k_weight(torch, dev, g, n, k)
                    for _ in range(max(2, -(-(128 << 20) // nbytes)))]


def random_q4k_weight(torch, dev, g, n, k):
    """A random q4_k weight [N, K] drawn on the card: any bytes are a valid
    q4_k weight in this layout."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    return q4k.Q4KWeight(
        packed=torch.randint(0, 256, (n // 2, k), generator=g, device=dev, dtype=torch.uint8),
        sub_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
        min_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
        dd_t=torch.rand((2 * (k // 256), n), generator=g, device=dev) * 1e-3,
    )


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
        extra = {}
        if name == "q4k_matvec_normed":
            # the normed row the prologue builds, through kernel 1: bit for bit;
            # an f32 row against the kernel-order plain version (F32_ORDER_BOUND)
            row = q4k.normed_row_kernel_order(x.cpu(), norm_w.cpu(), 1e-6).to(dev)
            require(torch.equal(got.to(x.dtype), q4k.q4k_matvec(row, weights[0])),
                    f"{name}/{shape}: not bit-equal to q4k_matvec on its normed row")
            x32 = x.float()
            got32 = q4k.q4k_matvec_normed(x32, weights[0], norm_w, 1e-6).cpu()
            want32 = q4k.q4k_matvec_normed_kernel_order(x32.cpu(), weights[0].to("cpu"),
                                                        norm_w.cpu(), 1e-6)
            err32 = (got32 - want32).abs().max().item()
            require(err32 <= F32_ORDER_BOUND * want32.abs().max().item(),
                    f"{name}/{shape}: f32 {err32} from its kernel-order version")
            extra = {"bit_equal_to_matvec_on_normed_row": True,
                     "f32_max_abs_err_vs_kernel_order": err32,
                     "f32_bound": f"max_abs_err <= {F32_ORDER_BOUND} * max_abs_kernel_order"}
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
               "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6), **extra}
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
    """q4k_matmul_rows at T = 8 and 64 (o_proj and the LM head at 16 and 32
    too) against its plain version and, row by row, against q4k_matvec."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows = []
    for shape, n, k in decode_shapes(cfg):
        nbytes, weights = cold_weights(torch, dev, g, n, k)
        between = ROWS_T_BETWEEN if shape in ("o_proj", "lm_head") else ()
        for t in sorted(ROWS_T + between):
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
    shape: B = 8 rows over a 2048-slot int8 cache, `poss` an int64 tensor on
    the card; at each window a spread row set (one row inside tile 0, one at
    a tile edge, one at win - 1) and a mid-window one, an f32 q against the
    kernel-order plain version, and one CUDA graph of the kernel captured
    once and replayed after `poss` is overwritten with three other sets;
    timed at both row sets."""
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
    q32 = torch.randn((b, hq, d), generator=g, device=dev) * 0.5
    q = q32.to(torch.bfloat16)
    scale = d ** -0.5

    def least(poss):  # each row's live slots (slot <= poss[i]) read once: int8 K
        # and V rows and their two f32 scales per (slot, head); q and out in bf16
        slots = int((poss + 1).sum())
        return bound_ms(slots * hkv * (2 * d + 8) + 2 * 2 * b * hq * d,
                        4 * slots * hq * d, "bf16")

    rows = []
    for win in (256, 1024, 2048):
        # one row inside tile 0, one at a tile edge, one at win - 1, the rest spread
        spread = torch.randint(0, win, (b - 3,), generator=g, device=dev)
        poss = torch.cat([torch.tensor([5, 255, win - 1], device=dev), spread])
        mid = torch.tensor([win // 2 + 37 - 8 * i for i in range(b)], device=dev)
        checks = {}
        for label, pt in (("spread", poss), ("mid", mid)):
            err, mag = rel_check(torch, f"gqa_rows_q8_attention/win={win}/{label}",
                                 attn.gqa_rows_q8_attention(q, *caches[0], pt, scale, win),
                                 attn.gqa_rows_q8_attention_ref(q, *caches[0], pt, scale, win))
            got32 = attn.gqa_rows_q8_attention(q32, *caches[0], pt, scale, win).cpu()
            want32 = attn.gqa_rows_q8_attention_kernel_order(
                q32.cpu(), *(t.cpu() for t in caches[0]), pt.cpu(), scale, win)
            err32 = (got32 - want32).abs().max().item()
            require(err32 <= F32_ORDER_BOUND * want32.abs().max().item(),
                    f"gqa_rows_q8_attention/win={win}/{label}: f32 {err32} from its "
                    "kernel-order version")
            checks[label] = (err, mag, err32)
        # one graph, captured at `poss`, replayed at three other row sets
        pos_t = poss.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = attn.gqa_rows_q8_attention(q, *caches[0], pos_t, scale, win)
        replayed = []
        for new in (poss, mid, torch.full_like(poss, win - 1), torch.zeros_like(poss)):
            pos_t.copy_(new)
            graph.replay()
            rel_check(torch, f"gqa_rows_q8_attention/win={win}: graph replay at {new.tolist()}",
                      out, attn.gqa_rows_q8_attention_ref(q, *caches[0], new, scale, win))
            replayed.append(new.tolist())
        del graph
        kern = lambda c: attn.gqa_rows_q8_attention(q, *c, poss, scale, win)  # noqa: E731
        plain = lambda c: attn.gqa_rows_q8_attention_ref(q, *c, poss, scale, win)  # noqa: E731
        kern_mid = lambda c: attn.gqa_rows_q8_attention(q, *c, mid, scale, win)  # noqa: E731
        bound, by = least(poss)
        row = {"phase": "kernel_attn", "name": "gqa_rows_q8_attention", "b": b, "hq": hq,
               "hkv": hkv, "d": d, "s": s_max, "win": win, "poss": poss.tolist(),
               "blocks_per_row_and_kv_head": attn.ROWS_CLUSTER,
               "max_abs_err": max(c[0] for c in checks.values()),
               "max_abs_plain": max(c[1] for c in checks.values()),
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
               "f32_max_abs_err_vs_kernel_order": max(c[2] for c in checks.values()),
               "f32_bound": f"max_abs_err <= {F32_ORDER_BOUND} * max_abs_kernel_order",
               "graph_replay_poss": replayed,
               "ms": time_ms(kern, caches, torch), "plain_ms": time_ms(plain, caches, torch),
               "bound_ms": bound, "bound_by": by,
               "mid_poss": mid.tolist(), "mid_ms": time_ms(kern_mid, caches, torch),
               "mid_bound_ms": least(mid)[0],
               "library_ms": None,
               "library": "none: no single PyTorch call computes attention with the int8 "
                          "cache's per-slot scales folded in"}
        emit(row)
        rows.append(row)
    return rows


PROFILE_TRIES = 5  # profiler sessions per call before a blind instrument fails the phase


def device_launches(torch, call) -> tuple[list[str], int]:
    """(names of the kernels one call of `call` puts on the device, profiler
    sessions it took): see `device_window`."""
    kernels, tries = device_window(torch, call)
    return [name for name, _, _ in kernels], tries


def device_kernels_phase(torch, dev, cfg) -> dict:
    """The kernels that one call of the q4_k matvec wrappers puts on the
    device (torch.profiler through `device_launches`), at every decode shape:
    one for q4k_matvec and one for q4k_matvec_normed (the rms_norm and the
    quantization are in the prologue); and one for fused_mlp_matvec at the
    1.7B and 0.6B MLP shapes (gate/up, the act requantization and the down
    product in one cooperative launch). Run after every timed phase, so that
    no profiler session precedes a timing."""
    from qwen3_asr_gguf_tpu_torch.ops import mlp, q4k

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    _, warmup = device_launches(torch, None)  # until a session sees the markers alone
    calls = {}
    for shape, n, k in decode_shapes(cfg):
        w = random_q4k_weight(torch, dev, g, n, k)
        x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
        norm_w = torch.ones(k, device=dev)
        if shape in ("qkv_proj", "gateup_proj"):
            calls[f"q4k_matvec_normed/{shape}"] = (
                lambda x=x, w=w, norm_w=norm_w: q4k.q4k_matvec_normed(x, w, norm_w, 1e-6))
        else:
            calls[f"q4k_matvec/{shape}"] = lambda x=x, w=w: q4k.q4k_matvec(x, w)
    for d, m in ((2048, 6144), (1024, 3072)):
        args = [t for shape in ((m, d), (m, d), (d, m)) for t in (
            torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
            torch.rand(shape[0], generator=g, device=dev) * 4e-4 + 1e-4)]
        x = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
        calls[f"fused_mlp_matvec/D={d}/M={m}"] = lambda x=x, args=args: mlp.fused_mlp_matvec(x, *args)
    per_call, sessions = {}, {"warmup": warmup}
    for case, call in calls.items():
        call()
        torch.cuda.synchronize()
        per_call[case], sessions[case] = device_launches(torch, call)
    row = {"phase": "device_kernels", "per_call": {c: len(v) for c, v in per_call.items()},
           "sessions": sessions}
    emit(row)
    for case, launched in per_call.items():
        require(len(launched) == 1, f"{case}: {launched} on the device for one call")
    return row


def decode_attn_kernel_phase(torch, dev, cfg) -> list[dict]:
    """gqa_decode_attention against its plain version at the 1.7B shape: one
    query over a 2048-slot cache, bf16 (bound KERNEL_BOUND) and f32 (bound
    F32_KERNEL_BOUND), at several positions per window, `pos` a 1-element
    int32 tensor on the card; one CUDA graph of the kernel captured at one
    position and replayed after the device `pos` is written to three others;
    timed at pos = win - 1 and at a mid-window pos beside one
    scaled_dot_product_attention call on the [:win] views."""
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

    def device_pos(pos):
        return torch.tensor([pos], dtype=torch.int32, device=dev)

    def least(pos):  # the live K and V rows (slot <= pos) read once, q read, out written
        return bound_ms(2 * (pos + 1) * hkv * d * 2 + 2 * 2 * hq * d, 4 * (pos + 1) * hq * d,
                        "bf16")

    rows = []
    for win in (256, 1024, 2048):
        mid = win // 2 + 37
        positions = sorted({0, 7, 8, 15, 16, 255, min(256, win - 1), mid, win - 1})
        errs = {"bf16": (0.0, 0.0), "f32": (0.0, 0.0)}
        for name, q, kv, bound in (("bf16", q32.to(torch.bfloat16), caches[0], KERNEL_BOUND),
                                   ("f32", q32, caches32, F32_KERNEL_BOUND)):
            for pos in positions:
                got = attn.gqa_decode_attention(q, *kv, device_pos(pos), scale, win).float()
                want = attn.gqa_decode_attention_ref(q, *kv, pos, scale, win).float()
                torch.cuda.synchronize()
                what = f"gqa_decode_attention/{name}/win={win}/pos={pos}"
                require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
                err, mag = (got - want).abs().max().item(), want.abs().max().item()
                require(err <= bound * mag, f"{what}: {err} > {bound} * {mag}")
                errs[name] = max(errs[name], (err, mag))
        q = q32.to(torch.bfloat16)
        # one graph, captured at `mid`, replayed at three other positions
        pos_t = device_pos(mid)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = attn.gqa_decode_attention(q, *caches[0], pos_t, scale, win)
        replayed = []
        for pos in (mid, 3, 256 if win > 256 else 200, win - 1):
            pos_t.fill_(pos)
            graph.replay()
            want = attn.gqa_decode_attention_ref(q, *caches[0], pos, scale, win).float()
            err = (out.float() - want).abs().max().item()
            require(err <= KERNEL_BOUND * want.abs().max().item(),
                    f"gqa_decode_attention/win={win}: graph replay at pos {pos}: {err}")
            replayed.append(pos)
        del graph
        times = {}
        for label, pos in (("last", win - 1), ("mid", mid)):
            pt = device_pos(pos)
            kern = lambda c: attn.gqa_decode_attention(q, *c, pt, scale, win)  # noqa: E731
            times[label] = time_ms(kern, caches, torch)
        pos = win - 1
        plain = lambda c: attn.gqa_decode_attention_ref(q, *c, pos, scale, win)  # noqa: E731
        q4 = q.permute(1, 0, 2)[None]  # [1, Hq, 1, d]

        def sdpa(c):  # every slot of the window is live at pos = win - 1: no mask
            k4, v4 = (t[:win].permute(1, 0, 2)[None] for t in c)
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=scale, enable_gqa=True)

        lib_err = (sdpa(caches[0])[0].permute(1, 0, 2).float()
                   - plain(caches[0]).float()).abs().max().item()
        last_bound, by = least(pos)
        row = {"phase": "kernel_attn_decode", "name": "gqa_decode_attention", "hq": hq,
               "hkv": hkv, "d": d, "s": s_max, "win": win, "positions": positions,
               "blocks_per_kv_head": attn.DECODE_CLUSTER,
               "max_abs_err": errs["bf16"][0], "max_abs_plain": errs["bf16"][1],
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
               "f32_max_abs_err": errs["f32"][0], "f32_max_abs_plain": errs["f32"][1],
               "f32_bound": f"max_abs_err <= {F32_KERNEL_BOUND} * max_abs_plain",
               "graph_replay_positions": replayed,
               "timed_pos": pos, "ms": times["last"],
               "plain_ms": time_ms(plain, caches, torch), "bound_ms": last_bound, "bound_by": by,
               "mid_pos": mid, "mid_ms": times["mid"], "mid_bound_ms": least(mid)[0],
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


def post_transcription(url: str, audio, response_format: str,
                       temperature: str | None = None) -> tuple[int, str, float]:
    """(status, body, seconds) of one multipart POST (no temperature field:
    the server's 0.4)."""
    import urllib.request

    bd = "chipsmokeboundary"
    fields = {"response_format": response_format, "language": "zh"}
    if temperature is not None:
        fields["temperature"] = temperature
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


class HttpServer:
    """The port's server, built by its CLI's build function from `argv` with
    engine settings overridden, on a local port for the `with` block."""

    def __init__(self, argv: list, **engine_config):
        from qwen3_asr_gguf_tpu_torch.cli import serve

        self.serve = serve
        t0 = time.time()
        self.server, self.engine, self.batcher = serve.build(argv, **engine_config)
        self.init_s = time.time() - t0

    def __enter__(self):
        from http.server import ThreadingHTTPServer

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), self.serve.make_handler(self.server))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        require(get_json(f"{self.url}/health") == {"status": "ok"}, "/health")
        return self

    def post_all(self, jobs: list, temperature: str | None = None) -> list:
        """(status, body, seconds) of concurrent POSTs of (audio, format)."""
        with ThreadPoolExecutor(len(jobs)) as pool:
            return list(pool.map(lambda j: post_transcription(self.url, *j, temperature),
                                 jobs))

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()


def cohort_widths(batcher) -> list:
    """Wrap `batcher._stage_cohort` to record the lanes of every cohort it
    stages (the admission thread calls it through the instance)."""
    widths, inner = [], batcher._stage_cohort

    def staging(reqs):
        cohort = inner(reqs)
        if cohort is not None:
            widths.append(len(cohort.reqs))
        return cohort

    batcher._stage_cohort = staging
    return widths


def serve_phase(torch, dev, model_dir: Path, prec: str = "int4",
                requests: int = SERVE_REQUESTS, long_request: bool = True) -> dict:
    """The port's server, built by its CLI from real arguments, on HTTP:
    concurrent 10 s requests (8 tones, json and text) and, with
    `long_request`, one 50.2 s request (two chunks with memory through
    successive rows). At "int4" every batched product is q4k_matmul_rows, at
    "q4_k" it is q4_matmul at `--max-batch` rows."""
    from qwen3_asr_gguf_tpu_torch.cli import serve
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k, qmm

    argv = ["--model-dir", str(model_dir), "--prec", prec, "--max-batch", "8", "--n-ctx", "2048",
            "--chunk-size", "40", "--device", str(dev)]
    rows_kernel = {"int4": q4k.q4k_matmul_rows, "q4_k": qmm.q4_matmul}[prec]
    # the engine settings of the asr phase: random weights would decode 512 tokens
    with HttpServer(argv, max_new_tokens=96, decode_block=96) as srv:
        engine, batcher, init_s = srv.engine, srv.batcher, srv.init_s
        models = get_json(f"{srv.url}/v1/models")
        require(models["data"][0]["id"] == serve.MODEL_NAME, f"/v1/models: {models}")
        jobs = [(tone(SERVE_CLIP_SECONDS, 200 + 50 * (i % 8)), "json" if i % 2 else "text")
                for i in range(requests)]
        if long_request:
            jobs.append((synthetic_clip(CLIP_SECONDS), "json"))
        for counter in (q4k.q4k_matvec, q4k.q4k_matvec_normed, q4k.q4k_matmul_rows,
                        attn.gqa_rows_q8_attention, qmm.q4_matmul):
            counter.launches = 0
        blocks0, cohorts0 = batcher.stats["n_blocks"], batcher.stats["n_cohorts"]
        widths = cohort_widths(batcher)
        t0 = time.time()
        results = srv.post_all(jobs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"q4k_matmul_rows": q4k.q4k_matmul_rows.launches,
                    "q4k_matvec": q4k.q4k_matvec.launches,
                    "q4k_matvec_normed": q4k.q4k_matvec_normed.launches,
                    "gqa_rows_q8_attention": attn.gqa_rows_q8_attention.launches,
                    "q4_matmul": qmm.q4_matmul.launches}
        stats = get_json(f"{srv.url}/stats")
    texts = []
    for (audio, fmt), (status, body, _) in zip(jobs, results):
        require(status == 200, f"POST answered {status}: {body[:200]}")
        texts.append(json.loads(body)["text"] if fmt == "json" else body)
    require(all(isinstance(t, str) and t for t in texts), "an empty transcript")
    lat = sorted(r[2] for r in results)
    audio_s = sum(len(a) for a, _ in jobs) / 16_000
    steps = (stats["batching"]["n_blocks"] - blocks0) * batcher.block
    cohorts = stats["batching"]["n_cohorts"] - cohorts0
    row = {"phase": "serve" if prec == "int4" else f"serve_{prec}", "kv": "bf16", "argv": argv,
           "engine_init_s": init_s,
           "requests": len(jobs), "audio_s": audio_s, "wall_s": wall,
           "s_audio_per_s": audio_s / wall, "latency_p50_s": lat[len(lat) // 2],
           "latency_p95_s": lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)],
           "text_chars_min": min(len(t) for t in texts), "batcher": stats["batching"],
           "decode_steps": steps, "cohorts": cohorts, "cohort_widths": widths,
           "launches": launches,
           "rows_matmul_launches_per_step": launches[rows_kernel.__name__] / max(steps, 1)}
    emit(row)
    require(launches[rows_kernel.__name__] > 0, f"the rows kernel never launched: {launches}")
    per_step = 4 * engine.dec_cfg.num_layers + 1  # 4 products per layer and the head
    require(len(widths) == cohorts, f"{row['phase']}: {cohorts} cohorts, {widths} staged")
    if prec == "int4":  # a cohort's head: kernel 1 for one lane, kernel 3 for more
        multi = sum(w > 1 for w in widths)
        require(launches["q4k_matmul_rows"] == per_step * steps + multi
                and launches["q4k_matvec"] == len(widths) - multi,
                f"serve: {launches} for {steps} steps ({per_step} each) and cohorts of "
                f"{widths} lanes")
    if prec == "q4_k":  # per step; and the head once per cohort
        require(launches["q4_matmul"] == per_step * steps + cohorts,
                f"serve_q4_k: {launches['q4_matmul']} q4_matmul launches for {steps} steps "
                f"({per_step} each) and {cohorts} staged cohorts")
    del srv, engine, batcher
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


def qmm_kernel_phase(torch, dev, cfg) -> list[dict]:
    """q4_matmul against its plain version: the decode shapes of the 1.7B
    q4_k engine at 1, 8 and 64 rows and the encoder's at 26 and 52 rows."""
    from qwen3_asr_gguf_tpu_torch.ops import qmm
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    text, audio = cfg.text, cfg.audio
    d, m = text.hidden_size, text.intermediate_size
    hq, hkv, hd = text.num_heads, text.num_kv_heads, text.head_dim
    cases = []
    for t in QMM_DECODE_T:
        cases += [("qkv_proj", t, (hq + 2 * hkv) * hd, d), ("o_proj", t, d, hq * hd),
                  ("gateup_proj", t, 2 * m, d), ("down_proj", t, d, m),
                  ("lm_head", t, -(-text.vocab_size // 256) * 256, d)]  # padded to 256 rows
    for t in QMM_ENCODER_T:
        cases += [("enc_fc1", t, audio.encoder_ffn_dim, audio.d_model),
                  ("enc_fc2", t, audio.d_model, audio.encoder_ffn_dim),
                  ("enc_q_w", t, audio.d_model, audio.d_model)]
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rows = []
    for shape, t, n, k in cases:
        nbytes = n * k // 2 + 8 * n * (k // 32)

        def random_weight():  # any bytes are a valid weight: drawn on the card
            return qt.Q4Weight(
                packed=torch.randint(0, 256, (n, k // 2), generator=g, device=dev,
                                     dtype=torch.uint8),
                scale=torch.rand((n, k // 32), generator=g, device=dev) * 1e-2 + 1e-3,
                minv=torch.rand((n, k // 32), generator=g, device=dev) * 8e-2)

        weights = [random_weight() for _ in range(max(2, -(-(128 << 20) // nbytes)))]
        x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
        kern = lambda w: qmm.q4_matmul(x, w)  # noqa: E731
        plain = lambda w: qmm.q4_matmul_ref(x, w)  # noqa: E731
        err, scale = rel_check(torch, f"q4_matmul/{shape}/T={t}", kern(weights[0]),
                               plain(weights[0]))
        ms = time_ms(kern, weights, torch)
        # every input read once, the output written once; the bf16 mma passes
        # the kernel runs (whole 8-row tiles, one plane for a bf16 x). The
        # first design did 2 T N K f32 operations outside the tensor cores.
        moved = nbytes + 2 * t * (k + n)
        least, by = bound_ms(moved, 2 * (-(-t // 8) * 8) * n * k, "bf16")
        first_least, first_by = bound_ms(moved, 2 * t * n * k, "f32")
        n_dense = max(2, -(-(128 << 20) // (2 * n * k)))
        dense = [qt.dequant_q4(w, dtype=torch.bfloat16) for w in weights[:n_dense]]
        row = {"phase": "kernel_qmm", "name": "q4_matmul", "shape": shape, "t": t, "n": n,
               "k": k, "max_abs_err": err, "max_abs_plain": scale,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
               "ms": ms, "plain_ms": time_ms(plain, weights, torch),
               "bound_ms": least, "bound_by": by,
               "first_design_bound_ms": first_least, "first_design_bound_by": first_by,
               "library_ms": time_ms(lambda w: torch.matmul(x, w.T), dense, torch),
               "library": "torch.matmul on the dequantized bf16 weight (2.7x the weight bytes)",
               "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6)}
        emit(row)
        rows.append(row)
        del weights, dense
    return rows


def mlp_kernel_phase(torch, dev) -> list[dict]:
    """fused_mlp_matvec against its plain version at the 1.7B and 0.6B MLP
    shapes, beside the same MLP through three int8_matmul products."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import mlp
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows = []
    for d, m in ((2048, 6144), (1024, 3072)):
        nbytes = 3 * d * m + 4 * (2 * m + d)

        def random_args():  # (wg, sg, wu, su, wd, sd)
            out = []
            for shape in ((m, d), (m, d), (d, m)):
                out.append(torch.randint(-127, 128, shape, generator=g, device=dev,
                                         dtype=torch.int8))
                out.append(torch.rand(shape[0], generator=g, device=dev) * 4e-4 + 1e-4)
            return tuple(out)

        sets = [random_args() for _ in range(max(2, -(-(128 << 20) // nbytes)))]
        x = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
        kern = lambda a: mlp.fused_mlp_matvec(x, *a)  # noqa: E731
        plain = lambda a: mlp.fused_mlp_matvec_ref(x, *a)  # noqa: E731

        def unfused(a):  # gate|up as one int8_matmul, silu * up, down: the unfused decode MLP
            wg, sg, wu, su, wd, sd = a
            layer = {"gateup_proj": qt.Int8Weight(q=torch.cat([wg, wu]), scale=torch.cat([sg, su])),
                     "down_proj": qt.Int8Weight(q=wd, scale=sd)}
            return lambda: dec._mlp(layer, x)

        err, scale = rel_check(torch, f"fused_mlp_matvec/D={d}/M={m}", kern(sets[0]),
                               plain(sets[0]))
        _, act = mlp._launch(x, *sets[0], mlp.TILE_M)
        kq, _ = mlp.quantize_act_tiles(act[None, :], mlp.TILE_M)
        pq, _ = mlp.quantize_act_tiles(mlp.mlp_act_ref(x, *sets[0][:4]), mlp.TILE_M)
        flipped = int((kq != pq).sum())
        layers = [unfused(a) for a in sets]
        lib_err = (layers[0]().float() - plain(sets[0]).float()).abs().max().item()
        # the three weights and their scales read once, x read, out written;
        # 2 * 3 D M int8 operations
        least, by = bound_ms(nbytes + 2 * 2 * d, 6 * d * m, "int8")
        ms = time_ms(kern, sets, torch)
        row = {"phase": "kernel_mlp", "name": "fused_mlp_matvec", "shape": f"D={d}/M={m}",
               "hidden": d, "m": m, "tile_m": mlp.TILE_M, "max_abs_err": err,
               "max_abs_plain": scale,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain; at most "
                        f"{MLP_FLIP_LIMIT} flipped act values",
               "ok": flipped <= MLP_FLIP_LIMIT, "flipped_actq": flipped, "actq_values": m,
               "ms": ms, "plain_ms": time_ms(plain, sets, torch),
               "bound_ms": least, "bound_by": by, "gb_per_s": nbytes / (ms * 1e6),
               "library_ms": time_ms(lambda f: f(), layers, torch),
               "library": "the unfused MLP: two int8_matmul calls (gate|up, down), each one "
                          "torch._int_mm on 32 zero-padded rows, per-row requantization",
               "library_max_abs_diff_vs_plain": lib_err, "weight_mb": nbytes / 1e6}
        emit(row)
        require(row["ok"], f"fused_mlp_matvec D={d} M={m}: {flipped} flipped act values")
        rows.append(row)
        del sets, layers
    return rows


class StepCounter:
    """Counts the decode steps, prefills and LM-head products of a run by
    wrapping the decoder's functions (the runtime calls them through the
    module), independently of the kernels' own launch counts. A step
    replayed as a CUDA graph calls no function: at exit each replay
    (counter `decode.graph_replays`) counts one step and one LM-head
    product, and each capture (`decode.graph_captures`), whose calls ran
    nothing, takes its own away."""

    NAMES = ("forward_step_layers", "forward_step_rows", "forward_prefill", "forward_prefill_at",
             "forward_prefill_lanes", "lm_logits")
    GRAPHED = ("forward_step_layers", "lm_logits")

    def __enter__(self):
        from qwen3_asr_gguf_tpu_torch.models import decoder as dec

        self.dec, self.inner, self.n = dec, {}, dict.fromkeys(self.NAMES, 0)
        self.lock = threading.Lock()  # the demo's sessions decode on two threads
        self.graphs0 = self._graph_counts()
        for name in self.NAMES:
            self.inner[name] = getattr(dec, name)
            setattr(dec, name, self._counting(name))
        return self

    @staticmethod
    def _graph_counts() -> tuple[int, int]:
        from qwen3_asr_gguf_tpu_torch.utils.profiling import TRACER

        return (TRACER.counters.get("decode.graph_replays", 0),
                TRACER.counters.get("decode.graph_captures", 0))

    def _counting(self, name):
        def call(*args, **kw):
            with self.lock:
                self.n[name] += 1
            return self.inner[name](*args, **kw)
        return call

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.dec, name, fn)
        replays, captures = (a - b for a, b in zip(self._graph_counts(), self.graphs0))
        for name in self.GRAPHED:
            self.n[name] += replays - captures

    @property
    def steps(self) -> int:
        return self.n["forward_step_layers"]

    @property
    def prefills(self) -> int:
        return self.n["forward_prefill"] + self.n["forward_prefill_at"]


def precision_step_check(torch, engine, phase: str) -> None:
    """One decode step of a quantized engine through its kernels (as its
    Generator runs it) against the same step on dense bf16 weights with the
    unfused MLP, from the same prefilled cache."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    gen = engine.generator
    cfg = gen.cfg
    dense = P.dequant_prefill_params(gen.params)
    g = torch.Generator(device=engine.device)
    g.manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (64,), generator=g, device=engine.device)
    cache = gen.new_cache()
    dec.forward_prefill(dense, cfg, dec.embed_tokens(dense, ids), cache)
    twin = {k: [t.clone() for t in v] for k, v in cache.items()}
    embd = dense["embed"][int(ids[-1])]
    h_k, _ = dec.forward_step_layers(gen.layers_list, gen.params["final_norm"], cfg, embd, cache,
                                     64, attn_window=256, fused_mlp=gen.fused_mlp)
    h_d, _ = dec.forward_step_layers(dense["layers"], dense["final_norm"], cfg, embd, twin, 64,
                                     attn_window=256)
    head = gen.params["lm_head"]
    dense_head = qt.dequant_int8(head) if isinstance(head, qt.Int8Weight) else qt.dequant_q4(head)
    lk = dec.lm_logits(gen.params, h_k, cfg.vocab_size)
    ld = dec.lm_logits({"lm_head": dense_head}, h_d, cfg.vocab_size)
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    finite = bool(torch.isfinite(lk).all())
    emit({"phase": phase, "logits": list(lk.shape), "finite": finite,
          "cosine_kernel_vs_dense": cos, "bound": STEP_COSINE_BOUND, "fused_mlp": gen.fused_mlp})
    require(finite and lk.shape == (cfg.vocab_size,), f"{phase}: logits malformed")
    require(cos >= STEP_COSINE_BOUND, f"{phase}: cosine {cos} < {STEP_COSINE_BOUND}")


def timed_precision_asr(torch, engine, audio, wrappers) -> dict:
    """One timed call (temperature 0.4) with the wrappers' counts set to 0
    just before and read just after, beside the counted steps and prefills."""
    for w in wrappers:
        w.launches = 0
    with StepCounter() as counter:
        t0 = time.time()
        res = engine.asr(audio, context="", language="Chinese", temperature=0.4)
        torch.cuda.synchronize()
        wall = time.time() - t0
    perf = res.performance
    require(isinstance(res.text, str) and len(res.text) > 0, "empty transcript")
    require(perf["decode_tokens"] > 0 and counter.steps > 0, "no decode steps")
    return {"temperature": 0.4, "audio_s": CLIP_SECONDS, "wall_s": wall,
            "rtf": wall / CLIP_SECONDS, "decode_steps": counter.steps,
            "prefills": counter.prefills, "lm_head_products": counter.n["lm_logits"],
            "ms_per_step": perf["decode_time"] * 1e3 / counter.steps,
            "prefill_s": perf["prefill_time"], "decode_s": perf["decode_time"],
            "encode_s": perf["encode_time"], "decode_tokens": perf["decode_tokens"],
            "text_chars": len(res.text), "launches": {w.__name__: w.launches for w in wrappers}}


def precision_engine(torch, dev, model_dir: Path, precision: str):
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine

    t0 = time.time()
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.q4_k.gguf", precision=precision,
        n_ctx=2048, chunk_size=40.0, memory_num=1, verbose=False, max_new_tokens=96,
        decode_block=96, kv_prefix_reuse=True, kv_cache_dtype="bf16", enable_aligner=False,
    ), device=dev)
    torch.cuda.synchronize()
    emit({"phase": f"engine_init_{precision}", "seconds": time.time() - t0,
          "gpu_mem_gb": torch.cuda.memory_allocated(dev) / 1e9})
    return engine


def int8_dot_routes(torch, engine, steps: int = 8) -> None:
    """Host-clock time of a decode step plus its LM-head product with the int8
    products through torch._int_mm (what the card runs) and through the f64
    route (what the CPU runs), each after a warm-up round."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    gen = engine.generator
    cache = gen.new_cache()
    embd = gen.params["embed"][1]

    def ms_per_step() -> float:
        torch.cuda.synchronize()
        t0 = time.time()
        for pos in range(steps):
            h, _ = dec.forward_step_layers(gen.layers_list, gen.params["final_norm"], gen.cfg,
                                           embd, cache, pos, attn_window=256,
                                           fused_mlp=gen.fused_mlp)
            dec.lm_logits(gen.params, h, gen.cfg.lm_head_dim)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3 / steps

    ms_per_step()
    int_mm = ms_per_step()
    fast = qt.int8_dot
    qt.int8_dot = lambda xq, wq: torch.matmul(xq.double(), wq.double().T).float()
    try:
        ms_per_step()
        f64 = ms_per_step()
    finally:
        qt.int8_dot = fast
    emit({"phase": "int8_dot_routes", "steps": steps, "fused_mlp": gen.fused_mlp,
          "ms_per_step_int_mm": int_mm, "ms_per_step_f64": f64})


def asr_int8_phase(torch, dev, model_dir: Path, audio) -> dict:
    """The int8 engine: kernel 7 and kernel 4 once per layer per decode step;
    then the same call with fused_mlp=False (a Generator over the same
    weights), both walls in this run."""
    from qwen3_asr_gguf_tpu_torch.ops import attn, mlp
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    engine = precision_engine(torch, dev, model_dir, "int8")
    gen = engine.generator
    require(gen.fused_mlp, "the int8 engine did not turn the fused MLP on")
    layers = gen.cfg.num_layers
    engine.asr(audio, context="", language="Chinese", temperature=0.4)  # warm-up
    wrappers = (mlp.fused_mlp_matvec, attn.gqa_decode_attention)
    row = {"phase": "asr_int8", **timed_precision_asr(torch, engine, audio, wrappers)}
    unfused = Generator(gen.params, gen.cfg, n_ctx=gen.n_ctx, eos_ids=tuple(gen.eos_ids),
                        block=gen.block, cache_dtype=gen.cache_dtype, fused_mlp=False,
                        device=dev)
    engine.generator = unfused
    off = timed_precision_asr(torch, engine, audio, wrappers)
    engine.generator = gen
    again = timed_precision_asr(torch, engine, audio, wrappers)
    row["fused_mlp_off"] = {k: off[k] for k in ("wall_s", "rtf", "ms_per_step", "decode_steps",
                                                "launches")}
    row["fused_mlp_on_again"] = {k: again[k] for k in ("wall_s", "rtf", "ms_per_step",
                                                       "decode_steps")}
    emit(row)
    for name, count in row["launches"].items():
        require(count == layers * row["decode_steps"],
                f"asr_int8: {count} launches of {name} for {row['decode_steps']} decode steps "
                f"of {layers} layers")
    require(off["launches"]["fused_mlp_matvec"] == 0, "fused_mlp=False launched the fused MLP")
    precision_step_check(torch, engine, "int8_step_check")
    int8_dot_routes(torch, engine)
    del engine, gen, unfused
    torch.cuda.empty_cache()
    return row


def stream_phase(torch, engine) -> None:
    """StreamingTranscriber over the q4_k engine at the bench_stream settings:
    12 s in 2 s chunks then finish(); the same PCM through a second
    transcriber must end in the same text (greedy; the numpy seed pins the
    seeds of any breaker retry)."""
    import numpy as np

    from qwen3_asr_gguf_tpu_torch.ops import qmm
    from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber

    engine.config.max_new_tokens = STREAM_NEW_TOKENS
    engine.generator.block = STREAM_NEW_TOKENS  # one decode block per streaming step
    audio = synthetic_clip(STREAM_SECONDS)
    piece = int(STREAM_CHUNK_SECONDS * 16_000)

    def run():
        np.random.seed(17)
        st = StreamingTranscriber(engine, language="Chinese", temperature=0.0,
                                  chunk_size_sec=STREAM_CHUNK_SECONDS)
        state = st.init_state()
        lat, first_text_s, t_start = [], None, time.time()
        for off in range(0, len(audio), piece):
            t0 = time.time()
            st.feed(state, audio[off: off + piece])
            torch.cuda.synchronize()
            lat.append(time.time() - t0)
            if first_text_s is None and state.text:
                first_text_s = time.time() - t_start
        t0 = time.time()
        text = st.finish(state)
        return text, state, lat, first_text_s, time.time() - t0

    run()  # warm-up: the first use of these shapes by cuBLAS and the allocator
    qmm.q4_matmul.launches = 0
    with StepCounter() as counter:
        text, state, lat, first_text_s, finish_s = run()
    launches = qmm.q4_matmul.launches
    text2, state2, lat2, _, _ = run()
    ordered = sorted(lat)
    row = {"phase": "stream", "audio_s": STREAM_SECONDS, "chunk_s": STREAM_CHUNK_SECONDS,
           "new_tokens_per_step": STREAM_NEW_TOKENS, "chunks_seen": state.chunks_seen,
           "stream_ttft_s": lat[0], "time_to_first_text_s": first_text_s,
           "chunk_latency_s": lat, "second_run_chunk_latency_s": lat2,
           "stream_p50_chunk_latency_s": ordered[len(ordered) // 2],
           "stream_p95_chunk_latency_s": ordered[min(len(ordered) - 1,
                                                     math.ceil(0.95 * len(ordered)) - 1)],
           "finish_s": finish_s, "text_chars": len(text), "tokens": len(state.tokens),
           "decode_steps": counter.steps, "prefills": counter.prefills,
           "launches": {"q4_matmul": launches}}
    emit(row)
    layers = engine.dec_cfg.num_layers
    require(state.chunks_seen == 6 and state.finished, f"chunks_seen {state.chunks_seen}")
    require(isinstance(text, str) and text and first_text_s is not None, "no streamed text")
    require(launches == 4 * layers * counter.steps + counter.n["lm_logits"] and launches > 0,
            f"stream: {launches} q4_matmul launches for {counter.steps} steps and "
            f"{counter.prefills} prefills")
    require(text2 == text and state2.tokens == state.tokens,
            "two transcribers fed the same PCM disagree")


def asr_q4k_phase(torch, dev, model_dir: Path, audio) -> dict:
    """The q4_k engine: every decode matvec through q4_matmul (qkv, o,
    gate_up and down of each layer and the LM head per step, the head once
    more after each prefill); then streaming on the same engine."""
    from qwen3_asr_gguf_tpu_torch.ops import attn, qmm

    engine = precision_engine(torch, dev, model_dir, "q4_k")
    layers = engine.dec_cfg.num_layers
    engine.asr(audio, context="", language="Chinese", temperature=0.4)  # warm-up
    wrappers = (qmm.q4_matmul, attn.gqa_decode_attention)
    row = {"phase": "asr_q4k", **timed_precision_asr(torch, engine, audio, wrappers)}
    per_step = 4 * layers + 1
    row["q4_matmul_per_step"] = per_step
    emit(row)
    require(row["launches"]["q4_matmul"] == per_step * row["decode_steps"] + row["prefills"],
            f"asr_q4k: {row['launches']['q4_matmul']} q4_matmul launches for "
            f"{row['decode_steps']} steps ({per_step} each) and {row['prefills']} prefills")
    require(row["lm_head_products"] == row["decode_steps"] + row["prefills"],
            "asr_q4k: LM-head products do not add up")
    require(row["launches"]["gqa_decode_attention"] == layers * row["decode_steps"],
            "asr_q4k: decode attention launches do not add up")
    precision_step_check(torch, engine, "q4k_step_check")
    stream_phase(torch, engine)
    del engine
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


def decode_step_check(torch, engine, phase: str = "decode_step_check") -> None:
    """One decode step through the kernels (the int4 matvecs, or cuBLAS on a
    dense bf16 decoder, and the decode attention) vs the same step on dense
    (dequantized) bf16 weights with the plain attention, from the same
    prefilled cache."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn
    from qwen3_asr_gguf_tpu_torch.ops.q4k import Q4KWeight, dequant_mxu

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
    head = gen.params["lm_head"]
    lk = dec.lm_logits(gen.params, h_k, cfg.vocab_size)
    ld = dec.lm_logits({"lm_head": dequant_mxu(head) if isinstance(head, Q4KWeight) else head},
                       h_d, cfg.vocab_size)
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    finite = bool(torch.isfinite(lk).all())
    emit({"phase": phase, "logits": list(lk.shape), "finite": finite,
          "cosine_kernel_vs_dense": cos, "bound": STEP_COSINE_BOUND,
          "decode_attention_launches": kernel_attn})
    require(finite and lk.shape == (cfg.vocab_size,), f"{phase}: logits malformed")
    require(kernel_attn == cfg.num_layers,
            f"{phase}: {kernel_attn} decode-attention launches, want one per layer")
    require(cos >= STEP_COSINE_BOUND, f"{phase}: cosine {cos} < {STEP_COSINE_BOUND}")


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


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def greedy_engine_tokens(torch, engine, audio):
    """(result, tokens, [top1, top2, argmax] per fed LM-head product) of the
    engine's greedy call on one chunk of at most 40 s, aligner off, with
    BATCH_NEW_TOKENS new tokens in one decode block (below the breaker's
    16-token window, so no random retry)."""
    gen = engine.generator
    saved = engine.aligner, engine.config.max_new_tokens, gen.block
    engine.aligner, engine.config.max_new_tokens, gen.block = None, BATCH_NEW_TOKENS, BATCH_NEW_TOKENS
    try:
        res, logits = recorded_greedy(torch, lambda: engine.asr(
            audio, context="", language="Chinese", temperature=0.0, chunk_size_sec=40.0))
    finally:
        engine.aligner, engine.config.max_new_tokens, gen.block = saved
    return res, [row[2] for row in logits], logits


def near_tie_verdict(phase: str, engine_text: str, engine_tokens: list, logits: list,
                     other_text: str, other_tokens: list, limit: int = BATCH_NEW_TOKENS) -> dict:
    """The batched-against-engine rule: equal tokens give equal texts, and
    where the tokens part, the engine's top-2 logit margin at the first
    differing step is within 2 bf16 ulp (a near-tie: the kernels sum in
    other orders). Raises otherwise; returns the verdict's fields. The first
    `limit` tokens are compared."""
    n = min(len(engine_tokens), len(other_tokens), limit)
    first = next((i for i in range(n) if engine_tokens[i] != other_tokens[i]), None)
    row = {"texts_equal": engine_text == other_text, "tokens_compared": n,
           "first_differing_step": first}
    if first is not None:
        top1, top2 = logits[first][:2]
        row.update(engine_top2_margin=top1 - top2, engine_top1=top1,
                   margin_limit=2 * bf16_ulp(top1))
    require(n > 0 and engine_text and other_text, f"{phase}: no tokens")
    require(first is not None or engine_text == other_text,
            f"{phase}: equal tokens but different texts")
    require(first is None or row["engine_top2_margin"] <= row["margin_limit"],
            f"{phase}: tokens part at step {first} with a margin of "
            f"{row.get('engine_top2_margin')} (more than 2 bf16 ulp)")
    return row


def batcher_vs_engine_phase(torch, engine, audio) -> dict:
    """The engine's greedy text (kernels 1, 2 and 4) against a
    ContinuousBatcher's at max_batch 8 (kernel 3, the rows step) on one full
    40 s chunk, BATCH_NEW_TOKENS new tokens (below the breaker's 16). Where
    the tokens part, the engine's top-2 logit margin at the first differing
    step must be within 2 bf16 ulp (a near-tie: the kernels sum in other
    orders). Then `max_batch` 4 runs 8 rows, so every product of a batched
    step is kernel 3 (4 x layers + 1 launches per step), and 72 is refused."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher

    chunk = audio[: 40 * 16_000]
    res, engine_tokens, logits = greedy_engine_tokens(torch, engine, chunk)

    class Recording(ContinuousBatcher):
        def _retire(self, row_idx):
            self.tokens_seen = list(self.rows[row_idx].tokens)
            super()._retire(row_idx)

    cb = Recording(engine, max_batch=8, block=16, max_new_tokens=BATCH_NEW_TOKENS)
    try:
        got = cb.submit(chunk, language="Chinese", temperature=0.0)
        batch_tokens = cb.tokens_seen
    finally:
        cb.close()
    row = {"phase": "batcher_vs_engine", "audio_s": len(chunk) / 16_000,
           "new_tokens": BATCH_NEW_TOKENS, "engine_text": res.text, "batcher_text": got.text,
           **near_tie_verdict("batcher_vs_engine", res.text, engine_tokens, logits, got.text,
                              batch_tokens)}

    # max_batch 4: whole 8-row tiles on the card; above 64 rows refused
    try:
        ContinuousBatcher(engine, max_batch=72)
        refused = False
    except ValueError:
        refused = True
    cb = ContinuousBatcher(engine, max_batch=4, block=16, max_new_tokens=BATCH_NEW_TOKENS)
    try:
        q4k.q4k_matmul_rows.launches = 0
        cb.submit(chunk, language="Chinese", temperature=0.0)
        torch.cuda.synchronize()
        launches, steps, rows = q4k.q4k_matmul_rows.launches, cb.stats["n_blocks"] * cb.block, cb.b
    finally:
        cb.close()
    per_step = 4 * engine.dec_cfg.num_layers + 1
    row.update(max_batch_4_rows=rows, max_batch_4_rows_launches_per_step=launches / max(steps, 1),
               max_batch_72_refused=refused)
    emit(row)
    require(refused, "max_batch 72 was not refused")
    require(rows == 8 and steps > 0 and launches == per_step * steps,
            f"max_batch 4: {rows} rows, {launches} q4k_matmul_rows launches for {steps} steps")
    return row

COHORT_TONES = (3.0, 10.0, 40.0)  # cohort_prefill: five tones of each, and the clip's chunk 1
COHORT_BOUND = 1e-2  # of max|engine|: KV rows and logits, the bf16 bound of the kernel table


def cohort_requests(torch, cb, engine, audio, mem_tokens: list) -> list:
    """The cohort_prefill phase's 16 greedy requests: five tones each of
    COHORT_TONES seconds and the 50.2 s clip's second chunk, which carries
    chunk 0's audio feature and `mem_tokens` (the engine's greedy tokens of
    chunk 0)."""
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import _Request

    reqs = [_Request(audio=tone(sec, 230.0 + 40.0 * i), context="", language="Chinese",
                     temperature=0.0)
            for i, sec in enumerate(sec for sec in COHORT_TONES for _ in range(5))]
    second = _Request(audio=audio, context="", language="Chinese", temperature=0.0, n_chunks=2)
    chunk0 = cb._chunk_audio(second)
    second.mem_feature = cb._encode([chunk0])[0][: engine.encoder.valid_tokens(len(chunk0))]
    second.mem_tokens = list(mem_tokens)
    second.chunk_idx = 1
    return reqs + [second]


def lane_prefills(torch, gen, prompts: list, cache: dict, t_pad: int):
    """The engine's prefill of each prompt on its own (the lane-by-lane
    staging that `prefill_cohort` replaces: `forward_prefill` at the
    prompt's own bucket into its row of `cache`, and one `lm_logits` call)
    -> logits [P, V]."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.runtime.generate import prompt_bucket

    params, cfg, last = gen.prefill_params, gen.step_cfg, []
    for lane, (ids, mask, embd) in enumerate(prompts):
        n = len(ids)
        ids_p, mask_p = gen._padded_prompt(ids, mask, min(prompt_bucket(n), t_pad))
        x = dec.splice_prompt(params, ids_p, mask_p, embd)
        lane_cache = {name: [c[lane] for c in cs] for name, cs in cache.items()}
        hidden, _ = dec.forward_prefill(params, cfg, x, lane_cache, length=n)
        last.append(dec.lm_logits(params, hidden[n - 1], cfg.lm_head_dim))
    return torch.stack(last)


def cohort_prefill(torch, gen, prompts: list, cache: dict, t_pad: int):
    from qwen3_asr_gguf_tpu_torch.runtime.generate import prefill_cohort

    return prefill_cohort(gen.prefill_params, gen.step_cfg, prompts, cache, t_pad)


def synced_median_s(torch, call, runs: int = 3) -> float:
    """Median wall seconds of `runs` calls, each from and to a synchronized card."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.time()
        call()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2]


def kv_lane_rows(torch, cache: dict, l: int, lens):
    """Layer l's K and V of every lane as f32 [P, S, Hkv, hd] (int8
    dequantized), and the mask of each lane's prompt slots [P, S]."""
    out = []
    for name in ("k", "v"):
        x = cache[name][l].float()
        if f"{name}_s" in cache:
            x = x * cache[f"{name}_s"][l][..., None]
        out.append(x)
    valid = torch.arange(out[0].shape[1], device=out[0].device)[None, :] < lens[:, None]
    return out, valid


def cohort_prefill_phase(torch, engine, audio, mem_tokens: list) -> dict:
    """A cohort of 16 greedy requests (COHORT_TONES and the clip's second
    chunk with memory) at the server's defaults (`--max-batch 8 --n-ctx
    2048`, int4 with its dense bf16 prefill weights), with bf16 and with
    int8 KV: the batched admission prefill (`generate.prefill_cohort`: one
    lanes pass, one LM-head call) against the engine's prefill of each
    prompt on its own. Per lane, KV rows [0:len) of every layer and the
    first-token logits within COHORT_BOUND of max|engine|, and the greedy
    first tokens equal or parted at a near-tie within 2 bf16 ulp. Both timed
    (synchronized, median of 3); `_stage_cohort` (encode included) runs the
    same requests in one lanes pass and one head. Returns what the device
    count at the end (`cohort_kernels_phase`) needs."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher
    from qwen3_asr_gguf_tpu_torch.runtime.generate import prompt_bucket

    t_phase = time.time()
    gen, dev = engine.generator, engine.device
    cb = ContinuousBatcher(engine, max_batch=8, block=16)
    try:
        reqs = cohort_requests(torch, cb, engine, audio, mem_tokens)
        chunks = [cb._chunk_audio(r) for r in reqs]
        prompts = [cb._build_admission(r, c, cur)
                   for r, c, cur in zip(reqs, chunks, cb._encode(chunks))]
        lens = [len(ids) for ids, _, _ in prompts]
        t_pad = min(prompt_bucket(max(lens)), cb.n_ctx)
        lens_d = torch.tensor(lens, device=dev)
        p = len(prompts)
        row = {"phase": "cohort_prefill", "lanes": p, "prompt_tokens": lens, "t_pad": t_pad,
               "lane_groups": len(dec.lane_groups(p, gen.step_cfg.num_heads, t_pad)),
               "score_budget_bytes": dec.PREFILL_SCORE_BYTES}
        for kv in (torch.bfloat16, torch.int8):
            name = "bf16" if kv == torch.bfloat16 else "int8"
            caches = [dec.init_cache(gen.step_cfg, t_pad, kv, device=dev, rows=p) for _ in (0, 1)]
            got = cohort_prefill(torch, gen, prompts, caches[0], t_pad).float()
            want = lane_prefills(torch, gen, prompts, caches[1], t_pad).float()
            kv_err = []
            for l in range(gen.step_cfg.num_layers):
                (gk, gv), valid = kv_lane_rows(torch, caches[0], l, lens_d)
                (wk, wv), _ = kv_lane_rows(torch, caches[1], l, lens_d)
                for g_, w_ in ((gk, wk), (gv, wv)):
                    err = ((g_ - w_).abs().amax(dim=(2, 3)) * valid).amax(dim=1)
                    ref = (w_.abs().amax(dim=(2, 3)) * valid).amax(dim=1)
                    kv_err.append(err / ref)
            kv_rel = torch.stack(kv_err).amax(dim=0).tolist()  # per lane
            logit_rel = ((got - want).abs().amax(dim=1)
                         / want.abs().amax(dim=1)).tolist()
            top = torch.topk(want, 2, dim=1).values.tolist()
            firsts = got.argmax(dim=1).tolist(), want.argmax(dim=1).tolist()
            parted = [{"lane": i, "engine_top2_margin": top[i][0] - top[i][1],
                       "margin_limit": 2 * bf16_ulp(top[i][0])}
                      for i in range(p) if firsts[0][i] != firsts[1][i]]
            batched_s = synced_median_s(torch, lambda: cohort_prefill(torch, gen, prompts,
                                                                      caches[0], t_pad))
            lane_s = synced_median_s(torch, lambda: lane_prefills(torch, gen, prompts,
                                                                  caches[1], t_pad))
            row[name] = {"kv_rel_err_max": max(kv_rel), "logits_rel_err_max": max(logit_rel),
                         "first_tokens_equal": p - len(parted), "parted": parted,
                         "batched_s": batched_s, "per_lane_s": lane_s,
                         "per_lane_over_batched": lane_s / batched_s}
            require(max(kv_rel) <= COHORT_BOUND, f"cohort_prefill {name}: KV rows {kv_rel}")
            require(max(logit_rel) <= COHORT_BOUND,
                    f"cohort_prefill {name}: logits {logit_rel}")
            require(all(x["engine_top2_margin"] <= x["margin_limit"] for x in parted),
                    f"cohort_prefill {name}: first tokens part beyond a near-tie: {parted}")
            require(all(math.isfinite(x) for x in kv_rel + logit_rel), "not finite")
            del caches
        with StepCounter() as counter:
            torch.cuda.synchronize()
            t0 = time.time()
            cohort = cb._stage_cohort(reqs)
            torch.cuda.synchronize()
            row["stage_cohort_s"] = time.time() - t0
        row["stage_cohort_calls"] = {k: counter.n[k] for k in (
            "forward_prefill_lanes", "forward_prefill", "lm_logits")}
        require(row["stage_cohort_calls"] == {"forward_prefill_lanes": 1, "forward_prefill": 0,
                                              "lm_logits": 1},
                f"cohort_prefill: _stage_cohort made {row['stage_cohort_calls']}")
        require(cohort is not None and len(cohort.reqs) == p and cohort.t_pad == t_pad,
                "cohort_prefill: _stage_cohort dropped a request")
    finally:
        cb.close()
    row["seconds"] = time.time() - t_phase
    emit(row)
    return {"prompts": prompts, "t_pad": t_pad, "row": row}


def cohort_kernels_phase(torch, gen, held: dict) -> dict:
    """The device kernels of one cohort_prefill batched call and of the
    engine's lane-by-lane loop over the same 16 prompts (torch.profiler
    through `device_window`, as block_profile counts them; the loop one
    lane per session, so that no window is large), on the headline
    generator's prefill weights, derived again and dropped after."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec

    prompts, t_pad = held["prompts"], held["t_pad"]
    cache = dec.init_cache(gen.step_cfg, t_pad, torch.bfloat16, device=gen.device,
                           rows=len(prompts))
    try:
        cohort_prefill(torch, gen, prompts, cache, t_pad)
        torch.cuda.synchronize()
        kernels, sessions = device_window(
            torch, lambda: cohort_prefill(torch, gen, prompts, cache, t_pad))
        counts, tries = {"batched": len(kernels), "per_lane": []}, {"batched": sessions}
        for lane, prompt in enumerate(prompts):
            row = {name: [c[lane: lane + 1] for c in cs] for name, cs in cache.items()}
            kernels, tries[f"lane_{lane}"] = device_window(
                torch, lambda: lane_prefills(torch, gen, [prompt], row, t_pad))
            counts["per_lane"].append(len(kernels))
    finally:
        gen._prefill_params = None
        del cache
        torch.cuda.empty_cache()
    per_lane = sum(counts["per_lane"])
    row = {"phase": "cohort_kernels", "lanes": len(prompts), "t_pad": t_pad,
           "device_kernels": {"batched": counts["batched"], "per_lane": per_lane},
           "per_lane_by_lane": counts["per_lane"], "sessions": tries}
    emit(row)
    require(0 < counts["batched"] < per_lane, f"cohort_kernels: {row['device_kernels']}")
    return row


def chunk_prompt(torch, engine, audio):
    """(ids, mask, embeddings) of the headline call's first chunk prompt: the
    clip's first 40 s, "Chinese", no carried text."""
    n_audio = engine.encoder.valid_tokens(40 * 16_000)
    feat = engine.encoder.encode(torch.from_numpy(audio[: 40 * 16_000]).to(engine.device))
    ids, mask = engine._build_prompt_ids(n_audio, "", "", "Chinese")
    return ids, mask, feat[:n_audio]


def asr_pipeline_phase(torch, engine, audio) -> dict:
    """The engine's pipelined chunk dispatch (one block per chunk: chunk i+1
    queued from chunk i's emitted buffer; the align worker with chunk 0's and
    the last chunk's speculative aligns) against its synchronous flow
    (`pipelined_dispatch=False`) on the clip, greedy, aligner on, at
    BATCH_NEW_TOKENS new tokens per chunk in one block: below the breaker's
    window, since a retry samples with other seeds in the two flows. Text,
    per-chunk tokens and items equal; where the tokens part (the speculative
    prefill may pad to another bucket, so cuBLAS may sum in another order),
    the synchronous flow's top-2 margin at the first differing step must be
    within 2 bf16 ulp. Then each flow timed twice, P S S P (host clock)."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec

    gen, aligner = engine.generator, engine.aligner
    saved = engine.config.max_new_tokens, gen.block, engine.config.pipelined_dispatch
    engine.config.max_new_tokens = gen.block = BATCH_NEW_TOKENS
    runs = {}

    def one(pipelined: bool, record: bool):
        engine.config.pipelined_dispatch = pipelined
        chunks, taken, pads = [], [], []
        inner_c, inner_s = engine._collect_chunk, engine._safe_decode
        inner_a = aligner.spec_align_collect
        inner_p, inner_pa = dec.forward_prefill, dec.forward_prefill_at

        def collect(*a, **k):
            res = inner_c(*a, **k)
            chunks.append((list(res.stable_tokens), res.is_aborted))
            return res

        def safe(*a, **k):
            res, cache = inner_s(*a, **k)
            chunks.append((list(res.stable_tokens), res.is_aborted))
            return res, cache

        def spec(*a, **k):
            out = inner_a(*a, **k)
            taken.append(out is not None)
            return out

        def padded(inner):
            def call(params, cfg, embd, *a, **k):
                if params is not aligner.runner.params:
                    pads.append(int(embd.shape[0]))
                return inner(params, cfg, embd, *a, **k)
            return call

        engine._collect_chunk, engine._safe_decode, aligner.spec_align_collect = collect, safe, spec
        dec.forward_prefill, dec.forward_prefill_at = padded(inner_p), padded(inner_pa)

        def call():
            return engine.asr(audio, context="", language="Chinese", temperature=0.0)

        try:
            t0 = time.time()
            if record:
                res, logits = recorded_greedy(torch, call,
                                              keep=lambda p: p is not aligner.runner.params)
            else:
                res, logits = call(), None
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            del engine._collect_chunk, engine._safe_decode, aligner.spec_align_collect
            dec.forward_prefill, dec.forward_prefill_at = inner_p, inner_pa
        return {"res": res, "logits": logits, "wall_s": wall, "pads": pads,
                "chunks": [t for t, aborted in chunks if not aborted],
                "aborted": sum(a for _, a in chunks), "spec_aligns_taken": sum(taken),
                "spec_aligns_tried": len(taken)}

    try:
        for pipelined in (True, False):
            runs[pipelined] = one(pipelined, record=True)
        walls = {True: [], False: []}
        for pipelined in (True, False, False, True):
            walls[pipelined].append(one(pipelined, record=False)["wall_s"])
    finally:
        engine.config.max_new_tokens, gen.block, engine.config.pipelined_dispatch = saved
    p, q = runs[True], runs[False]
    items = {k: [(i.text, i.start_time, i.end_time) for i in (r["res"].alignment.items
                                                              if r["res"].alignment else [])]
             for k, r in runs.items()}
    row = {"phase": "asr_pipeline", "audio_s": len(audio) / 16_000,
           "new_tokens_per_chunk": BATCH_NEW_TOKENS, "texts_equal": p["res"].text == q["res"].text,
           "chunks": len(p["chunks"]), "chunk_tokens_equal": p["chunks"] == q["chunks"],
           "items": len(items[True]), "items_equal": items[True] == items[False],
           "prefill_pads": {"pipelined": p["pads"], "synchronous": q["pads"]},
           "aborted_chunks": {"pipelined": p["aborted"], "synchronous": q["aborted"]},
           "spec_aligns_taken": p["spec_aligns_taken"], "spec_aligns_tried": p["spec_aligns_tried"],
           "wall_s": {"pipelined": walls[True], "synchronous": walls[False]},
           **near_tie_verdict("asr_pipeline", q["res"].text, [r[2] for r in q["logits"]],
                              q["logits"], p["res"].text, [r[2] for r in p["logits"]],
                              limit=len(q["logits"]))}
    emit(row)
    require(p["aborted"] == q["aborted"] == 0, "asr_pipeline: a chunk aborted below the window")
    require(len(p["chunks"]) == len(q["chunks"]) == math.ceil(len(audio) / (40 * 16_000)),
            f"asr_pipeline: {len(p['chunks'])} / {len(q['chunks'])} chunks read")
    if row["first_differing_step"] is None:
        require(row["chunk_tokens_equal"], "asr_pipeline: equal streams, other chunk tokens")
        require(row["items_equal"] or p["pads"] != q["pads"],
                "asr_pipeline: equal prompts and tokens, other aligned items")
        require(items[True], "asr_pipeline: no aligned items")
    return row


def block_sync_free_phase(torch, engine, audio, phase: str = "block_sync_free") -> dict:
    """The tests' check of a dispatched chunk at full width: the headline
    engine's `_dispatch_chunk` (the chunk-0 prefill and one 96-step block)
    and one block queued behind it raise nothing under
    torch.cuda.set_sync_debug_mode("error"), greedy and at 0.4; the host's
    queueing time per step (ms) and the wait in `collect_block`."""
    gen = engine.generator
    ids, mask, feat = chunk_prompt(torch, engine, audio)
    warm = engine._dispatch_chunk(ids, mask, feat, 0.4)
    gen.collect_block(warm["packed"])
    torch.cuda.synchronize()
    row = {"phase": phase, "block": gen.block, "runs": {}}
    for temperature in (0.0, 0.4):
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = engine._dispatch_chunk(ids, mask, feat, temperature)
            t1 = time.time()
            _, packed = gen.decode_block_dispatch(pend["state"], temperature)
            t2 = time.time()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        toks, finished, _ = gen.collect_block(pend["packed"])
        more, _, _ = gen.collect_block(packed)
        t3 = time.time()
        row["runs"][str(temperature)] = {
            "tokens": len(toks), "more_tokens": len(more), "finished": finished,
            "chunk_dispatch_s": t1 - t0, "block_dispatch_s": t2 - t1, "collect_wait_s": t3 - t2,
            "ms_per_queued_step": (t2 - t1) * 1e3 / max(len(more), 1)}
        require(len(toks) == gen.block or finished, f"{phase}: {len(toks)} tokens")
    emit(row)
    return row


def random_experts(torch, dev, g, e: int = MOE_EXPERTS, m: int = MOE_WIDTH, d: int = 2048):
    """Random q4_0 expert planes (`ops.moe.ExpertWeights`) of `e` experts
    [M, D] / [D, M] drawn on the card: any nibbles are valid weights."""
    from qwen3_asr_gguf_tpu_torch.ops import moe

    def planes(n, k):
        return (torch.randint(0, 256, (e, n, k // 2), generator=g, device=dev, dtype=torch.uint8),
                (torch.rand((e, n, k // 32), generator=g, device=dev) * 2e-3 + 1e-4).half())

    return moe.ExpertWeights(*planes(m, d), *planes(m, d), *planes(d, m))


def expert_call(torch, dev, g, x_dtype):
    """(one expert_matvec call's arguments but the experts: x [1, 2048],
    ids, wts) at MOE_SLOTS slots: 6 routed experts, then the shared
    SwiGLU's two halves (experts 64 and 65) at weight 1."""
    x = torch.randn((1, 2048), generator=g, device=dev).to(x_dtype)
    ids = torch.tensor([5, 63, 17, 0, 40, 9, 64, 65], dtype=torch.int32, device=dev)
    wts = torch.cat([torch.rand(6, generator=g, device=dev) * 0.4,
                     torch.ones(2, device=dev)])
    return x, ids, wts


def eager_ms(torch, fn, args: list, runs: int = TIMED_RUNS) -> float:
    """Wall time of one call launched from the host, between CUDA events
    around `runs` back-to-back calls cycling through `args` (host launch
    time included: the time a step outside a graph pays)."""
    for a in args:
        fn(a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(runs):
        fn(args[i % len(args)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def moe_kernel_phase(torch, dev) -> list[dict]:
    """Kernel 8 (`ops.moe.expert_matvec`) against its plain version at
    Moonlight-16B-A3B's widths: MOE_SLOTS slots of [1408, 2048] over 66
    experts (64 routed and the shared SwiGLU's halves), bf16 and f32 x,
    within KERNEL_BOUND * max|plain|. Timed as phase 3 (a CUDA graph of
    calls over MOE_COPIES copies of the experts, so each call streams its
    slots cold from HBM), beside its bound (the slots' bytes over the
    memory rate) and a library yardstick (torch.bmm on the slots' experts
    dequantized to bf16 and gathered beforehand: gate|up, then down); and
    the same calls launched from the host (`eager_ms`), which is what a
    reading outside a graph measures."""
    from qwen3_asr_gguf_tpu_torch.ops import moe

    g = torch.Generator(device=dev)
    g.manual_seed(8)
    copies = [random_experts(torch, dev, g) for _ in range(MOE_COPIES)]
    rows = []
    for x_dtype in (torch.bfloat16, torch.float32):
        x, ids, wts = expert_call(torch, dev, g, x_dtype)
        err, scale = rel_check(torch, f"expert_matvec/{x_dtype}",
                               moe.expert_matvec(x, copies[0], ids, wts),
                               moe.expert_matvec_ref(x, copies[0], ids, wts))
        row = {"phase": "kernel", "name": "expert_matvec", "shape": "8x[1408,2048]",
               "x": str(x_dtype).removeprefix("torch."), "slots": MOE_SLOTS,
               "max_abs_err": err, "max_abs_plain": scale,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True}
        if x_dtype == torch.bfloat16:
            m, d = MOE_WIDTH, 2048
            nbytes = MOE_SLOTS * 3 * m * d * 18 // 32 + 2 * 2 * d + 8 * MOE_SLOTS
            kern = lambda w: moe.expert_matvec(x, w, ids, wts)  # noqa: E731
            plain = lambda w: moe.expert_matvec_ref(x, w, ids, wts)  # noqa: E731
            ms = time_ms(kern, copies, torch)
            least, by = bound_ms(nbytes, 2 * MOE_SLOTS * 3 * m * d, "int8")
            dense = []
            for w in copies[:4]:
                sel = ids.long()
                gu = torch.cat([moe.dequant(w.gate_qs[sel], w.gate_d[sel]),
                                moe.dequant(w.up_qs[sel], w.up_d[sel])], 1).to(torch.bfloat16)
                dense.append((gu, moe.dequant(w.down_qs[sel], w.down_d[sel]).to(torch.bfloat16)))

            def library(w):
                gu = torch.bmm(w[0], x.expand(MOE_SLOTS, 1, d).transpose(1, 2))[..., 0]
                act = torch.nn.functional.silu(gu[:, :m]) * gu[:, m:]
                y = torch.bmm(w[1], act[..., None])[..., 0]
                return (wts[:, None].to(y.dtype) * y).sum(0)

            row.update({"ms": ms, "plain_ms": eager_ms(torch, plain, copies, 10),
                        "bound_ms": least, "bound_by": by,
                        "library_ms": time_ms(library, dense, torch),
                        "library": "two torch.bmm on the slots' experts dequantized to bf16 "
                                   "and gathered beforehand (4x the weight bytes)",
                        "eager_ms": eager_ms(torch, kern, copies),
                        "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6),
                        "roofline_pct": 100.0 * least / ms})
            del dense
        emit(row)
        rows.append(row)
    del copies
    torch.cuda.empty_cache()
    return rows


def ensure_moe_checkpoint(torch, dev) -> tuple[Path, dict]:
    """(directory, benchmark configuration) of the Moonlight-16B-A3B
    checkpoint, written on the card by the benchmark's writer for its
    configuration (`benchmark/architectures/mla_moe.py`) under
    .bench_cache/torch/."""
    from benchmark.architectures import mla_moe as arch

    cfg = json.loads((REPO / MOE_CONFIG).read_text())
    t0 = time.time()
    model_dir, written = arch.checkpoint(cfg, REPO / ".bench_cache" / "torch", dev)
    torch.cuda.empty_cache()
    emit({"phase": "moe_checkpoint", "config": cfg["name"], "written": written,
          "seconds": time.time() - t0})
    return model_dir, cfg


def moe_asr_phase(torch, dev, audio) -> dict:
    """QwenASREngine on the Moonlight-16B-A3B preset at the published widths
    (27 layers, 64 routed experts top-6 and 2 shared, vocabulary 163,840)
    behind the 1.7B's tower, at the benchmark cell's engine settings: a
    warm-up call, then one call at 0.4 with the launch counts set to 0 just
    before it: kernel 8 once per MoE layer per decode step (each call two
    device launches, `device_kernels`), kernel 6 (kv_a_proj) once per layer
    per step, every step replayed as a CUDA graph; then the chunk dispatch
    and a block queued behind it under set_sync_debug_mode("error") (phase
    moe_sync_free: no host read of the routing)."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.ops import moe, q4k, qmm
    from qwen3_asr_gguf_tpu_torch.utils.profiling import TRACER

    model_dir, cfg = ensure_moe_checkpoint(torch, dev)
    e = cfg["engine"]
    t0 = time.time()
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.q4_k.gguf", precision=e["precision"],
        n_ctx=e["n_ctx"], chunk_size=e["chunk_size"], memory_num=e["memory_num"],
        verbose=False, max_new_tokens=96, decode_block=96,
        kv_prefix_reuse=e["kv_prefix_reuse"], kv_cache_dtype=e["kv_cache_dtype"],
        pipelined_dispatch=e["pipelined_dispatch"]), device=dev)
    text = engine.dec_cfg
    init_s = time.time() - t0
    t0 = time.time()
    engine.asr(audio, context="", language="Chinese", temperature=0.4)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    wrappers = (moe.expert_matvec, qmm.q4_matmul, q4k.q4k_matvec, q4k.q4k_matvec_normed)
    for w in wrappers:
        w.launches = 0
    before = {k: TRACER.counters.get(k, 0) for k in ("decode.steps", "decode.graph_replays")}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = engine.asr(audio, context="", language="Chinese", temperature=0.4)
    torch.cuda.synchronize()
    wall = time.time() - t0
    steps, replays = (TRACER.counters.get(k, 0) - before[k] for k in before)
    counts = {w.__name__: w.launches for w in wrappers}
    n_moe = text.num_layers - text.first_k_dense_replace
    perf = res.performance
    row = {"phase": "moe_asr", "preset": cfg["name"], "temperature": 0.4, "audio_s": CLIP_SECONDS,
           "init_s": init_s, "warmup_s": warm_s, "wall_s": wall, "rtf": wall / CLIP_SECONDS,
           "decode_steps": steps, "graph_replays": replays, "launches": counts,
           "moe_layers": n_moe, "decode_tokens": perf["decode_tokens"],
           "decode_ms_per_step": perf["decode_time"] * 1e3 / max(steps, 1),
           "text_chars": len(res.text),
           "peak_gpu_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(row)
    require(steps > 0 and len(res.text) > 0, "moe_asr: no decode steps or an empty transcript")
    require(replays == steps, f"moe_asr: {replays} of {steps} steps replayed as a graph")
    require(counts["expert_matvec"] == n_moe * steps,
            f"moe_asr: kernel 8 called {counts['expert_matvec']} times for {steps} steps "
            f"of {n_moe} MoE layers")
    require(counts["q4_matmul"] == text.num_layers * steps,
            f"moe_asr: kernel 6 (kv_a_proj) {counts['q4_matmul']} for {steps} steps")
    block_sync_free_phase(torch, engine, audio, phase="moe_sync_free")
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    return row


def moe_device_kernels(torch, dev) -> dict:
    """The device kernels one expert_matvec call puts on the card
    (torch.profiler through `device_launches`): two, gate/up of every slot
    and then down of every slot summed."""
    from qwen3_asr_gguf_tpu_torch.ops import moe

    g = torch.Generator(device=dev)
    g.manual_seed(9)
    w = random_experts(torch, dev, g)
    x, ids, wts = expert_call(torch, dev, g, torch.bfloat16)
    call = lambda: moe.expert_matvec(x, w, ids, wts)  # noqa: E731
    call()
    torch.cuda.synchronize()
    names, tries = device_launches(torch, call)
    row = {"phase": "moe_device_kernels", "per_call": names, "sessions": tries}
    emit(row)
    require(len(names) == 2, f"expert_matvec: {names} on the device for one call")
    return row


def encode_towers(torch, dev, model_dir: Path) -> dict:
    """name -> (config, params) of the encode_graph phase's towers: the
    checkpoint's 1.7B (int4) and aligner (int8) encoders, and a random 0.6B
    int4 tower written once under .bench_cache/torch/."""
    from qwen3_asr_gguf_tpu_torch import preset
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models import encoder as enc
    from qwen3_asr_gguf_tpu_torch.models import params as P

    small = REPO / ".bench_cache" / "torch" / "encoder-0.6b" / "qwen3_asr_encoder.safetensors"
    if not small.exists():
        cfg = preset("qwen3-asr-0.6b").audio
        tree = np_init_like(enc.init_shapes(cfg), 2)
        tree["pos_embed"] = enc.sinusoid_positions(cfg.max_source_positions, cfg.d_model)
        small.parent.mkdir(parents=True, exist_ok=True)
        P.save_encoder_safetensors(str(small), cfg, tree)
        del tree
    return {"1.7b": P.load_encoder_quantized(str(model_dir / "qwen3_asr_encoder.safetensors"),
                                             kind="int4", device=dev),
            "aligner": P.load_encoder_quantized(
                str(model_dir / "qwen3_aligner_encoder.safetensors"), kind="int8", device=dev),
            "0.6b": P.load_encoder_quantized(str(small), kind="int4", device=dev)}


def encode_graph_phase(torch, dev, model_dir: Path) -> list[dict]:
    """The encoder as a replayed CUDA graph per input key against the eager
    encode (`cuda_graphs=False`) on the same weights: bit for bit, both
    timed, kernel 6's launches (the 2 s key's products) counted once per
    replay; then `encode_kernel_counts` in a process of its own."""
    from qwen3_asr_gguf_tpu_torch.ops import qmm
    from qwen3_asr_gguf_tpu_torch.runtime.encoder_runner import EncoderRunner

    rows = []
    for name, (cfg, params) in encode_towers(torch, dev, model_dir).items():
        eager = EncoderRunner(params, cfg, device=dev, cuda_graphs=False)
        graph = EncoderRunner(params, cfg, device=dev)
        for n, bucketed in ENCODE_GRAPH_KEYS[name]:
            audio = synthetic_clip(n / 16_000 + 1)[:n]
            key = graph.encode_key(n, bucketed)
            src = torch.from_numpy(audio).to(dev) if key[0] == "aligned" else audio
            fresh = key not in graph.graphs
            launches0 = qmm.q4_matmul.launches
            want = eager.encode(src, bucketed=bucketed)
            eager_launches = qmm.q4_matmul.launches - launches0
            got = graph.encode(src, bucketed=bucketed)  # the key's capture when fresh
            launches1 = qmm.q4_matmul.launches
            again = graph.encode(src, bucketed=bucketed)
            torch.cuda.synchronize()
            replay_launches = qmm.q4_matmul.launches - launches1
            equal = torch.equal(got, want) and torch.equal(again, want)
            eager_ms = 1e3 * synced_median_s(
                torch, lambda: eager.encode(src, bucketed=bucketed), ENCODE_TIMED_RUNS[0])
            graph_ms = 1e3 * synced_median_s(
                torch, lambda: graph.encode(src, bucketed=bucketed), ENCODE_TIMED_RUNS[1])
            row = {"phase": "encode_graph", "tower": name, "layers": cfg.encoder_layers,
                   "weights": "int8" if name == "aligner" else "int4", "samples": n,
                   "bucketed": bucketed, "key": list(key), "captured_here": fresh,
                   "valid_tokens": graph.valid_tokens(n), "rows": int(want.shape[-2]),
                   "bit_equal": equal, "eager_ms": eager_ms, "graph_ms": graph_ms,
                   "speedup": eager_ms / graph_ms,
                   "q4_matmul_launches": {"eager": eager_launches, "replay": replay_launches}}
            emit(row)
            rows.append(row)
            require(equal, f"encode_graph {name} {key}: graph and eager differ")
            require(replay_launches == eager_launches,
                    f"encode_graph {name} {key}: {replay_launches} q4_matmul launches counted "
                    f"for a replay, {eager_launches} for an eager encode")
        require(set(graph.graphs) == {graph.encode_key(n, b) for n, b in ENCODE_GRAPH_KEYS[name]},
                f"encode_graph {name}: keys {sorted(graph.graphs)}")
        del eager, graph
        torch.cuda.empty_cache()
    short = [r for r in rows if r["key"] == ["aligned", 2 * 16_000]]
    require(short and short[0]["q4_matmul_launches"]["eager"] > 0,
            "encode_graph: the 2 s key's products never ran kernel 6")
    # the device kernels in a process of its own: profiler sessions late in a
    # process lose their markers once many events were recorded, and the
    # phases after this one count theirs
    script = ENCODE_KERNELS_SCRIPT.format(repo=str(REPO), model_dir=str(model_dir))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=900)
    require(proc.returncode == 0, f"encode_graph kernels: rc {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({"phase": "encode_graph_kernels", "per_encode": counts,
          "keys": {name: list(keys[0]) for name, keys in ENCODE_GRAPH_KEYS.items()}})
    require(all(c["eager"] > 1000 and c["replay"] >= c["eager"] for c in counts.values()),
            f"encode_graph kernels: {counts}")
    return rows


ENCODE_KERNELS_SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
print(json.dumps(cs.encode_kernel_counts(torch, torch.device("cuda", 0), cs.Path({model_dir!r}))))
"""


def encode_kernel_counts(torch, dev, model_dir: Path) -> dict:
    """tower -> the device kernels of one eager encode and of one replay at
    its first key of ENCODE_GRAPH_KEYS (`device_launches`)."""
    from qwen3_asr_gguf_tpu_torch.runtime.encoder_runner import EncoderRunner

    device_launches(torch, None)  # until a session sees the markers alone
    out = {}
    for name, (cfg, params) in encode_towers(torch, dev, model_dir).items():
        n, bucketed = ENCODE_GRAPH_KEYS[name][0]
        eager = EncoderRunner(params, cfg, device=dev, cuda_graphs=False)
        graph = EncoderRunner(params, cfg, device=dev)
        audio = synthetic_clip(n / 16_000 + 1)[:n]
        src = torch.from_numpy(audio).to(dev) if graph.encode_key(n, bucketed)[0] == "aligned" \
            else audio
        for runner in (eager, graph):  # warm; the graph's capture
            runner.encode(src, bucketed=bucketed)
        torch.cuda.synchronize()
        out[name] = {kind: len(device_launches(
            torch, lambda r=r: r.encode(src, bucketed=bucketed))[0])
            for kind, r in (("eager", eager), ("replay", graph))}
    return out


def moe_phase(torch, dev, audio) -> tuple[list, dict]:
    """Kernel 8 and the sparse-expert engine: `moe_kernel_phase`, then
    `moe_asr_phase`. -> (kernel rows, the asr row)."""
    rows = moe_kernel_phase(torch, dev)
    return rows, moe_asr_phase(torch, dev, audio)


def device_window(torch, call) -> tuple[list, int]:
    """([(name, start_us, end_us)] of the device kernels that one call of
    `call` puts on the card, profiler sessions it took). torch.profiler (CUDA
    events only) may record nothing at all in a session, most often in the
    first ones of a process while CUPTI comes up: so a marker kernel
    (torch.cuda._sleep, `spin_kernel`) runs just before and just after the
    call, and a session that does not show both markers saw nothing and is
    repeated, at most PROFILE_TRIES times. The result is every other device
    event of the first session that shows both."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            if call is not None:
                call()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("spin_kernel" in n for n, _, _ in ev) == 2:
            return [e for e in ev if "spin_kernel" not in e[0]], tries
        seen.append([n for n, _, _ in ev])
    raise RuntimeError(f"no profiler session of {PROFILE_TRIES} saw both markers: {seen}")


def fresh_block(gen, state, seed: int):
    """One decode block at 0.4 from `state` with its own seed and latch watch."""
    import dataclasses

    from qwen3_asr_gguf_tpu_torch.runtime.generate import DoneWatch

    fresh = dataclasses.replace(state, watch=DoneWatch(), generator=gen._rng(seed))
    return gen.decode_block(fresh, 0.4)


def time_blocks(torch, gen, state, runs: int = 3) -> list[tuple[float, int]]:
    """[(wall seconds, steps)] of `runs` 96-step decode blocks of the headline
    engine from chunk 0's prefill at temperature 0.4 (greedy would end a
    block at the repetition latch after 16 steps), on the host clock."""
    out = []
    for seed in range(runs):
        torch.cuda.synchronize()
        with StepCounter() as sc:
            t0 = time.time()
            fresh_block(gen, state, seed)
            wall = time.time() - t0
        out.append((wall, sc.steps))
    return out


def block_profile_phase(torch, gen, state, walls: list) -> dict:
    """ms per step of the `time_blocks` runs, then one torch.profiler window
    of the same block: device kernels per step, their busy time (the union
    of their intervals) and the card's idle share over the block (from the
    first kernel's start to the last one's end, and over the unprofiled
    wall). Last of all: a profiler session after this window's ~126,000
    events records too few to trust."""
    layers = gen.cfg.num_layers
    for tries in range(1, PROFILE_TRIES + 1):
        with StepCounter() as sc:
            kernels, sessions = device_window(torch, lambda: fresh_block(gen, state, 0))
        # a session that lost events shows fewer than the step's 4 x layers + 1
        # q4_k matvecs; it is repeated
        if sum("q4k_matvec" in n for n, _, _ in kernels) == (4 * layers + 1) * sc.steps:
            break
    else:
        raise RuntimeError(f"block_profile: no session of {PROFILE_TRIES} saw every matvec")
    spans = sorted((a, b) for _, a, b in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    names: dict = {}
    for n, _, _ in kernels:
        names[n[:80]] = names.get(n[:80], 0) + 1
    ms_step = min(w / max(n, 1) for w, n in walls) * 1e3
    busy_ms_step = busy / 1e3 / max(sc.steps, 1)
    row = {"phase": "block_profile", "temperature": 0.4, "steps": [n for _, n in walls],
           "wall_s": [w for w, _ in walls],
           "ms_per_step": ms_step, "profiled_steps": sc.steps, "device_kernels": len(kernels),
           "kernels_per_step": len(kernels) / max(sc.steps, 1), "busy_ms_per_step": busy_ms_step,
           "profiled_window_ms": window / 1e3,
           "idle_share_profiled": 1 - busy / window if window else None,
           "idle_share_unprofiled": 1 - busy_ms_step / ms_step,
           "top_kernels": dict(sorted(names.items(), key=lambda kv: -kv[1])[:12]),
           "sessions": sessions, "windows": tries}
    emit(row)
    require(sc.steps > 0 and kernels, "block_profile: no step or no kernel seen")
    return row


SRT_CUE = re.compile(r"(\d+):(\d+):(\d+),(\d+) --> (\d+):(\d+):(\d+),(\d+)")


def answer_items(fmt: str, body: str) -> tuple[str, list]:
    """(text, [(start, end)]) of a verbose_json or srt answer."""
    if fmt == "verbose_json":
        out = json.loads(body)
        return out["text"], [(w["start"], w["end"]) for w in out["words"]]

    def sec(h, m, s, ms):
        return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000.0

    cues = [(sec(*m.groups()[:4]), sec(*m.groups()[4:])) for m in SRT_CUE.finditer(body)]
    text = "".join(line for line in body.splitlines()
                   if line.strip() and not line.strip().isdigit() and " --> " not in line)
    return text, cues


def serve_timestamp_phase(torch, dev, model_dir: Path) -> dict:
    """The server from `--timestamp` (int4, continuous batching, 8 rows, the
    0.6B aligner at int4 beside the decoder): 8 concurrent 10 s requests as
    verbose_json and srt, a 3 s one and the 50.2 s clip as verbose_json,
    aligned on the batcher's align pool. Every answer with text must carry
    items (a failed alignment degrades to none, so a swallowed failure fails
    here), inside [0, clip end + 320 s] (random weights pick any of the 4000
    classes), starts in order; every product of a batched step is
    q4k_matmul_rows. The 3 s request's conv features (39 rows) go through
    q4_matmul in both int4 encoders, which must launch."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k, qmm
    from qwen3_asr_gguf_tpu_torch.runtime.aligner import STEP_MS, TIMESTAMP_CLASSES

    t_phase = time.time()
    argv = ["--model-dir", str(model_dir), "--prec", "int4", "--max-batch", "8", "--n-ctx",
            "2048", "--chunk-size", "40", "--device", str(dev), "--timestamp"]
    jobs = [(tone(SERVE_CLIP_SECONDS, 200 + 50 * i), "srt" if i % 2 else "verbose_json")
            for i in range(8)] + [(tone(3.0, 620.0), "verbose_json"),
                                  (synthetic_clip(CLIP_SECONDS), "verbose_json")]
    with HttpServer(argv, max_new_tokens=96, decode_block=96) as srv:
        require(srv.batcher.supports_timestamps, "the batcher takes no timestamps")
        blocks0 = srv.batcher.stats["n_blocks"]
        widths = cohort_widths(srv.batcher)
        q4k.q4k_matmul_rows.launches = qmm.q4_matmul.launches = 0
        t0 = time.time()
        results = srv.post_all(jobs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, qmm_launches = q4k.q4k_matmul_rows.launches, qmm.q4_matmul.launches
        stats = get_json(f"{srv.url}/stats")
        steps = (stats["batching"]["n_blocks"] - blocks0) * srv.batcher.block
        layers, init_s = srv.engine.dec_cfg.num_layers, srv.init_s
    n_items = []
    for (audio, fmt), (status, body, _) in zip(jobs, results):
        require(status == 200, f"POST answered {status}: {body[:200]}")
        text, items = answer_items(fmt, body)
        latest = len(audio) / 16_000 + TIMESTAMP_CLASSES * STEP_MS / 1000.0
        require(not text or items, f"a {fmt} answer with text and no items")
        require([a for a, _ in items] == sorted(a for a, _ in items), "starts out of order")
        require(all(0.0 <= a <= b <= latest for a, b in items),
                f"items outside [0, {latest}]: {items[:4]}")
        n_items.append(len(items))
    per_step = 4 * layers + 1
    row = {"phase": "serve_timestamp", "argv": argv, "engine_init_s": init_s,
           "requests": len(jobs), "formats": [f for _, f in jobs], "wall_s": wall,
           "audio_s": sum(len(a) for a, _ in jobs) / 16_000, "items_or_srt_cues": n_items,
           "batcher": stats["batching"], "decode_steps": steps, "cohort_widths": widths,
           "q4k_matmul_rows_launches": launches, "q4_matmul_launches": qmm_launches,
           "rows_matmul_launches_per_step": launches / max(steps, 1),
           "seconds": time.time() - t_phase}
    emit(row)
    require(sum(n_items) > 0, "no aligned items at all")
    require(qmm_launches > 0, "serve_timestamp: q4_matmul never launched on the short request")
    # and one head per cohort of more than one lane (one lane: kernel 1)
    multi = sum(w > 1 for w in widths)
    require(steps > 0 and launches == per_step * steps + multi,
            f"serve_timestamp: {launches} q4k_matmul_rows launches for {steps} steps "
            f"({per_step} each) and {multi} cohorts of more than one lane ({widths})")
    torch.cuda.empty_cache()
    return row


def int8_rows_route(torch, engine) -> dict:
    """One batched int8 rows step (forward_step_rows on Int8Weight products)
    at 2 and 8 rows: every product goes through torch._int_mm (the rows
    zero-padded to INT_MM_MIN_ROWS), its logits bit-equal to the exact f64
    route's, and the ms per step of each (host clock, after a warm-up)."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    params, cfg, dev = engine.generator.prefill_params, engine.dec_cfg, engine.device
    per_step = 4 * cfg.num_layers + 1
    out = {}
    for b in (2, 8):
        caches = dec.init_cache(cfg, 256, torch.bfloat16, device=dev, rows=b)
        twin = {k: [c.clone() for c in v] for k, v in caches.items()}
        embd = params["embed"][torch.arange(1, b + 1, device=dev)]
        poss = torch.arange(b, device=dev) * 7

        def step(kv):
            h, _ = dec.forward_step_rows(params["layers"], params["final_norm"], cfg, embd, kv,
                                         poss, attn_window=256)
            return dec.lm_logits(params, h, cfg.lm_head_dim)

        def ms(kv, n=8):
            step(kv)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(n):
                step(kv)
            torch.cuda.synchronize()
            return (time.time() - t0) * 1e3 / n

        calls, int_mm = [], torch._int_mm
        torch._int_mm = lambda a, w: calls.append(a.shape[0]) or int_mm(a, w)
        try:
            got = step(caches)
        finally:
            torch._int_mm = int_mm
        ms_int_mm = ms(caches)
        fast = qt.int8_dot
        qt.int8_dot = lambda xq, wq: torch.matmul(xq.double(), wq.double().T).float()
        try:
            want = step(twin)
            ms_f64 = ms(twin)
        finally:
            qt.int8_dot = fast
        out[b] = {"int_mm_calls": len(calls), "int_mm_rows": sorted(set(calls)),
                  "bit_equal": bool(torch.equal(got, want)),
                  "finite": bool(torch.isfinite(got).all()),
                  "ms_per_step_int_mm": ms_int_mm, "ms_per_step_f64": ms_f64}
    emit({"phase": "int8_rows_route", "rows": out, "min_rows": qt.INT_MM_MIN_ROWS})
    for b, r in out.items():
        require(r["int_mm_calls"] == per_step and r["int_mm_rows"] == [qt.INT_MM_MIN_ROWS],
                f"int8 rows step at {b} rows: {r['int_mm_calls']} torch._int_mm calls at "
                f"{r['int_mm_rows']} rows, want {per_step} at {qt.INT_MM_MIN_ROWS}")
        require(r["bit_equal"] and r["finite"], f"int8 rows step at {b} rows: _int_mm != f64")
    return out


def serve_micro_phase(torch, dev, model_dir: Path, prec: str = "int4") -> dict:
    """`--batch-mode micro` at `--prec int4` (served at int8, as in the JAX
    package) or `q4_k`: 8 concurrent 10 s requests over HTTP at temperature
    1e-6 (the server maps 0 to 0.4), then the same PCM submitted to the
    MicroBatcher at temperature 0, BATCH_NEW_TOKENS new tokens each. The
    greedy round is the one compared: its argmax takes the first of tied
    maxima, as the engine's does, where 1e-6 draws between them. A lone
    request runs on the engine and must give the engine's greedy text. Each
    batched row's tokens are held to the engine's greedy tokens by the
    near-tie rule, with the engine's step in the rows step's math: the plain
    attention (a bf16 rows step has no attention kernel, in the JAX package
    either; kernel 4 rounds its probabilities against a running max) and, at
    int8, fused_mlp=False (the rows step quantizes the MLP's act per row,
    kernel 7 per 512-column tile). At q4_k every product of a batched step is
    q4_matmul at the batch's rows."""
    import hashlib

    from qwen3_asr_gguf_tpu_torch.audio.io import load_audio
    from qwen3_asr_gguf_tpu_torch.ops import attn, mlp, qmm
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    t_phase = time.time()
    name = "serve_micro" if prec == "int4" else f"serve_micro_{prec}"
    argv = ["--model-dir", str(model_dir), "--prec", prec, "--batch-mode", "micro",
            "--batch-window", "0.25", "--max-batch", "8", "--n-ctx", "2048", "--chunk-size",
            "40", "--device", str(dev)]
    audios = [tone(SERVE_CLIP_SECONDS, 200 + 50 * i) for i in range(8)]
    heard = [load_audio(wav_bytes(a)) for a in audios]  # what the server transcribes
    jobs = [(a, "json") for a in audios]
    wrappers = (qmm.q4_matmul, mlp.fused_mlp_matvec, attn.gqa_decode_attention)

    def key(audio) -> str:
        return hashlib.sha1(audio.tobytes()).hexdigest()

    with HttpServer(argv, max_new_tokens=BATCH_NEW_TOKENS, decode_block=BATCH_NEW_TOKENS) as srv:
        engine, batcher = srv.engine, srv.batcher
        gen, run_batch = batcher.batched.gen, batcher._run_batch
        batches, timings, generate = [], [], gen.generate

        def recording_batch(batch):
            batches.append([key(p.audio) for p in batch])
            return run_batch(batch)

        def recording_generate(*args, **kw):
            t0 = time.time()
            rows = generate(*args, **kw)
            timings.append(time.time() - t0)
            batches[-1] = dict(zip(batches[-1], rows))
            return rows

        batcher._run_batch, gen.generate = recording_batch, recording_generate
        for w in wrappers:
            w.launches = 0
        with StepCounter() as counter:
            t0 = time.time()
            results = srv.post_all(jobs, temperature="0.000001")
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        stats = get_json(f"{srv.url}/stats")
        init_s, served = srv.init_s, list(batches)
        batches.clear()
        with ThreadPoolExecutor(len(heard)) as pool:
            greedy = list(pool.map(
                lambda a: batcher.submit(a, language="Chinese", temperature=0.0), heard))
    for status, body, _ in results:
        require(status == 200 and json.loads(body)["text"], f"POST answered {status}: {body[:200]}")
    tokens = {k: v for b in batches for k, v in b.items()}
    row = {"phase": name, "argv": argv, "precision": engine.config.precision,
           "engine_init_s": init_s, "requests": len(jobs), "wall_s": wall,
           "audio_s": len(jobs) * SERVE_CLIP_SECONDS, "batches": stats["batches"],
           "batched_requests": stats["batched_requests"],
           "batch_widths": [len(b) for b in served], "rows_steps": counter.n["forward_step_rows"],
           "generate_s": timings, "launches": launches,
           "greedy_batch_widths": [len(b) for b in batches]}
    require(stats["batches"] >= 1, f"{name}: no micro batch formed")
    if prec == "q4_k":
        # 4 products per layer and the head per rows step and per step of a
        # lone request on the engine; the head once per batch (its lanes
        # prefill) and once per engine prefill
        per_step = 4 * engine.dec_cfg.num_layers + 1
        want = (per_step * (counter.n["forward_step_rows"] + counter.steps)
                + counter.n["forward_prefill_lanes"] + counter.prefills)
        row.update(q4_matmul_per_step=per_step, engine_steps=counter.steps,
                   engine_prefills=counter.prefills,
                   batch_prefills=counter.n["forward_prefill_lanes"])
        require(counter.n["forward_prefill_lanes"] == stats["batches"] == len(served),
                f"{name}: {counter.n['forward_prefill_lanes']} lanes prefills for "
                f"{stats['batches']} batches")
        require(launches["q4_matmul"] == want,
                f"{name}: {launches['q4_matmul']} q4_matmul launches, {want} expected "
                f"({per_step} per rows or engine step, one per batch and engine prefill)")
    lone = [(a, res.text) for a, res in zip(heard, greedy) if key(a) not in tokens]
    for audio, text in lone:  # ran on the engine as it serves
        require(text == greedy_engine_tokens(torch, engine, audio)[0].text,
                f"{name}: a lone request's text differs from the engine's")
    gen0, fast = engine.generator, attn.gqa_decode_attention
    if gen0.fused_mlp:
        engine.generator = Generator(gen0.params, gen0.cfg, n_ctx=gen0.n_ctx,
                                     eos_ids=tuple(gen0.eos_ids), block=gen0.block,
                                     cache_dtype=gen0.cache_dtype, fused_mlp=False, device=dev)
    attn.gqa_decode_attention = attn.gqa_decode_attention_ref
    verdicts = []
    try:
        for audio, res in zip(heard, greedy):
            if key(audio) in tokens:
                want, engine_tokens, logits = greedy_engine_tokens(torch, engine, audio)
                verdicts.append(near_tie_verdict(name, want.text, engine_tokens, logits, res.text,
                                                 tokens[key(audio)]))
    finally:
        attn.gqa_decode_attention, engine.generator = fast, gen0
    row["compared_with"] = {"fused_mlp": False, "attention": "plain", "lone": len(lone),
                            "rows_equal": sum(v["first_differing_step"] is None
                                              for v in verdicts), "verdicts": verdicts}
    if engine.config.precision == "int8":
        row["int8_rows_route"] = int8_rows_route(torch, engine)
    row["seconds"] = time.time() - t_phase
    emit(row)
    del engine, batcher, srv
    torch.cuda.empty_cache()
    return row


def cut_preset(name: str, layers: int) -> str:
    """A preset of `name`'s widths at `layers` decoder and encoder layers,
    registered in the port's table; returns its name."""
    import dataclasses

    from qwen3_asr_gguf_tpu_torch.models import configs

    cut = f"{name}-{layers}l"
    base = configs.PRESETS[name]
    configs.PRESETS[cut] = dataclasses.replace(
        base, audio=dataclasses.replace(base.audio, encoder_layers=layers),
        text=dataclasses.replace(base.text, num_layers=layers))
    return cut


def ensure_half_checkpoint() -> Path:
    """A random-weight qwen3-asr-1.7b with an f16 GGUF decoder at HALF_LAYERS
    layers (the route, not the depth, is what the phase checks), in a
    directory of its own beside the q4_k checkpoint."""
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    name = cut_preset(PRESET, HALF_LAYERS)
    out = REPO / ".bench_cache" / "torch" / f"{name}-f16"
    t0 = time.time()
    built = not (out / "qwen3_asr_llm.f16.gguf").exists()
    if built:
        make_synthetic_checkpoint(str(out), name, quant="f16", seed=0)
    emit({"phase": "checkpoint_f16", "preset": name, "built": built,
          "seconds": time.time() - t0})
    return out


def asr_bf16_phase(torch, dev) -> dict:
    """QwenASREngine at precision "bf16" on the f16 GGUF (the encoder rounded
    f32 -> f16 -> bf16): every decode product is one cuBLAS call on the dense
    bf16 weights and the attention is kernel 4, 28 launches per step; timed
    as asr_int8 (aligner off), with the step check against the plain
    attention."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.ops import attn

    t_phase = time.time()
    model_dir = ensure_half_checkpoint()
    t0 = time.time()
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.f16.gguf", precision="bf16",
        n_ctx=2048, chunk_size=40.0, memory_num=1, verbose=False, max_new_tokens=96,
        decode_block=96, kv_prefix_reuse=True, kv_cache_dtype="bf16", enable_aligner=False,
    ), device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    layer = engine.generator.params["layers"][0]
    require(layer["qkv_proj"].dtype == torch.bfloat16, "the bf16 decoder is not dense bf16")
    require(engine.encoder.params["proj1_w"].dtype == torch.bfloat16, "encoder not bf16")
    audio = synthetic_clip(CLIP_SECONDS)
    engine.asr(audio, context="", language="Chinese", temperature=0.4)  # warm-up
    row = {"phase": "asr_bf16", "engine_init_s": init_s,
           "gpu_mem_gb": torch.cuda.memory_allocated(dev) / 1e9,
           **timed_precision_asr(torch, engine, audio, (attn.gqa_decode_attention,))}
    layers = engine.dec_cfg.num_layers
    row["seconds"] = time.time() - t_phase
    emit(row)
    require(row["launches"]["gqa_decode_attention"] == layers * row["decode_steps"],
            f"asr_bf16: {row['launches']['gqa_decode_attention']} decode attention launches "
            f"for {row['decode_steps']} steps of {layers} layers")
    decode_step_check(torch, engine, "bf16_step_check")
    del engine
    torch.cuda.empty_cache()
    return row


def transcribe_cli_phase(torch, dev, model_dir: Path) -> dict:
    """`cli/transcribe.py main([...])` at its defaults (int4, 40 s chunks,
    temperature 0.4) with `--timestamp` on a wav of the 50.2 s clip: the
    .txt, .srt and .json it writes, the .json's items in order and in bounds,
    and the headline path's kernels (1, 2, 4) launched. The CLI has no
    token-budget flag; the engine's max_new_tokens and decode_block are the
    asr phase's 96, set in the port's schema default for this call."""
    import dataclasses

    from qwen3_asr_gguf_tpu_torch import schema
    from qwen3_asr_gguf_tpu_torch.cli import transcribe
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k
    from qwen3_asr_gguf_tpu_torch.runtime.aligner import STEP_MS, TIMESTAMP_CLASSES

    t_phase = time.time()
    work = REPO / ".bench_cache" / "torch" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "clip.wav").write_bytes(wav_bytes(synthetic_clip(CLIP_SECONDS)))
    wrappers = (q4k.q4k_matvec, q4k.q4k_matvec_normed, attn.gqa_decode_attention)
    for w in wrappers:
        w.launches = 0

    @dataclasses.dataclass
    class Config(schema.ASREngineConfig):
        max_new_tokens: int = 96
        decode_block: int = 96

    saved, schema.ASREngineConfig = schema.ASREngineConfig, Config
    try:
        rc = transcribe.main([str(work / "clip.wav"), "--model-dir", str(model_dir),
                              "--timestamp", "--output-dir", str(work / "out"), "--quiet", "-y",
                              "--device", str(dev)])
    finally:
        schema.ASREngineConfig = saved
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    files = {s: work / "out" / f"clip{s}" for s in (".txt", ".srt", ".json")}
    require(rc == 0, f"transcribe.main returned {rc}")
    require(all(f.exists() for f in files.values()), f"missing outputs: {files}")
    items = json.loads(files[".json"].read_text(encoding="utf-8"))
    latest = CLIP_SECONDS + TIMESTAMP_CLASSES * STEP_MS / 1000.0
    starts = [it["start"] for it in items]
    row = {"phase": "transcribe_cli", "rc": rc, "items": len(items),
           "txt_chars": len(files[".txt"].read_text(encoding="utf-8").strip()),
           "srt_cues": len(SRT_CUE.findall(files[".srt"].read_text(encoding="utf-8"))),
           "launches": launches, "seconds": time.time() - t_phase}
    emit(row)
    require(items and row["txt_chars"] > 0 and row["srt_cues"] > 0, "empty CLI outputs")
    require(starts == sorted(starts), "CLI items out of order")
    require(all(0.0 <= it["start"] <= it["end"] <= latest for it in items),
            "CLI items out of bounds")
    require(all(c > 0 for c in launches.values()), f"a headline kernel never launched: {launches}")
    torch.cuda.empty_cache()
    return row


def q4_weight_products(gguf: Path) -> int:
    """The `Q4Weight` products of one prefill of the `q4_k` loader's decoder,
    read from the GGUF: each 2-D q4_k layer matrix once, plus the head,
    which the loader requantizes to a `Q4Weight` when the hidden size is a
    multiple of 64 (models/params.py `load_decoder_gguf`)."""
    from qwen3_asr_gguf_tpu_torch.formats import GGUFReader
    from qwen3_asr_gguf_tpu_torch.formats import quants as q

    r = GGUFReader(str(gguf))
    layers = sum(1 for name, ti in r.tensors.items() if name.startswith("blk.")
                 and ti.ggml_type == q.GGML_Q4_K and len(ti.shape) == 2)
    hidden = r.tensors["token_embd.weight"].shape[1]
    return layers + (hidden % 64 == 0)


def captured(call):
    """(what `call()` returns, what it printed) for an entry point called in
    this process."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = call()
    return result, buf.getvalue()


def quant_accuracy_phase(torch, dev, model_dir: Path) -> dict:
    """`cli/quant_accuracy.py main` on the 1.7B q4_k checkpoint: exit code 0,
    the encoder int4 cosine >= 0.96 and the decoder hidden cosine >= 0.90;
    the 64-row q4_k prefill takes every `Q4Weight` product of the call
    through q4_matmul (the encoders' 130 rows dequantize). The CPU's values
    are the tests' (tests/test_torch_fidelity.py), not rerun here."""
    from qwen3_asr_gguf_tpu_torch.cli import quant_accuracy
    from qwen3_asr_gguf_tpu_torch.ops import qmm

    t_phase = time.time()
    products = q4_weight_products(model_dir / "qwen3_asr_llm.q4_k.gguf")
    qmm.q4_matmul.launches = 0
    rc, out = captured(lambda: quant_accuracy.main(["--model-dir", str(model_dir),
                                                    "--device", str(dev)]))
    torch.cuda.synchronize()
    launches = qmm.q4_matmul.launches
    report = json.loads(out)
    row = {"phase": "quant_accuracy", "rc": rc, "report": report,
           "q4_weight_products": products, "launches": {"q4_matmul": launches},
           "seconds": time.time() - t_phase}
    emit(row)
    require(rc == 0 and report["encoder_pass"] and report["decoder_pass"],
            f"quant_accuracy failed a bar: {report}")
    require(report["encoder_int4_cosine"] >= quant_accuracy.ENCODER_BAR
            and report["decoder_hidden_cosine"] >= quant_accuracy.DECODER_BAR, "bars")
    require(launches == products, f"quant_accuracy: {launches} q4_matmul launches for "
                                  f"{products} Q4Weight products")
    torch.cuda.empty_cache()
    return row


PPL_WINDOW, PPL_MAX_TOKENS, PPL_BAR_PCT = 512, 2048, 9.0
PPL_CARD_VS_CPU = 1e-3  # relative, f32 perplexity of one window


def perplexity_phase(torch, dev, model_dir: Path) -> dict:
    """`cli/perplexity.py main --compare f32` on the 1.7B q4_k GGUF over the
    repo's README (window 512, 2048 tokens): both perplexities finite and
    the delta within 9%; each precision timed; no q4_matmul launch (513-row
    windows dequantize per call). Then the f32 perplexity of the first
    window on the card against the same on the CPU (within 1e-3)."""
    import numpy as np

    from qwen3_asr_gguf_tpu_torch.cli import perplexity
    from qwen3_asr_gguf_tpu_torch.formats import GGUFReader
    from qwen3_asr_gguf_tpu_torch.ops import qmm
    from qwen3_asr_gguf_tpu_torch.text.tokenizer import BPETokenizer

    t_phase = time.time()
    llm = model_dir / "qwen3_asr_llm.q4_k.gguf"
    seconds, inner = {}, perplexity.compute_ppl

    def timed(path, ids, *, precision, window, device):
        t0 = time.time()
        out = inner(path, ids, precision=precision, window=window, device=device)
        torch.cuda.synchronize()
        seconds[precision] = time.time() - t0
        return out

    qmm.q4_matmul.launches = 0
    perplexity.compute_ppl = timed
    try:
        rc, out = captured(lambda: perplexity.main([
            "--llm", str(llm), "--text", str(REPO / "README.md"), "--compare", "f32",
            "--window", str(PPL_WINDOW), "--max-tokens", str(PPL_MAX_TOKENS),
            "--device", str(dev)]))
    finally:
        perplexity.compute_ppl = inner
    launches = qmm.q4_matmul.launches
    report = json.loads(out)
    tok = BPETokenizer.from_gguf_kv(GGUFReader(str(llm)).kv)
    ids = np.asarray(tok.encode((REPO / "README.md").read_text(encoding="utf-8"))
                     [: PPL_WINDOW + 1], dtype=np.int32)
    card = inner(str(llm), ids, precision="f32", window=PPL_WINDOW, device=dev)
    t0 = time.time()
    cpu = inner(str(llm), ids, precision="f32", window=PPL_WINDOW, device="cpu")
    rel = abs(card - cpu) / cpu
    row = {"phase": "perplexity", "rc": rc, "report": report, "seconds_per_precision": seconds,
           "launches": {"q4_matmul": launches}, "first_window_f32": {"card": card, "cpu": cpu,
           "rel_diff": rel, "bound": PPL_CARD_VS_CPU, "cpu_s": time.time() - t0},
           "seconds": time.time() - t_phase}
    emit(row)
    require(rc == 0 and report["tokens"] == PPL_MAX_TOKENS, f"perplexity: {report}")
    require(all(math.isfinite(report[k]) for k in ("ppl_q4_k", "ppl_f32")), "ppl not finite")
    require(abs(report["delta_pct"]) <= PPL_BAR_PCT, f"ppl delta {report['delta_pct']}%")
    require(launches == 0, f"perplexity: {launches} q4_matmul launches on 513-row windows")
    require(rel <= PPL_CARD_VS_CPU, f"f32 ppl card {card} vs cpu {cpu}")
    torch.cuda.empty_cache()
    return row


DEMO_SECONDS, DEMO_CHUNK_SECONDS, DEMO_NEW_TOKENS = 12.0, 2.0, 15


def demo_streaming_phase(torch, dev, model_dir: Path) -> dict:
    """`cli/demo_streaming.py` at its default `--prec int8` on the 1.7B
    checkpoint (15 new tokens per step, greedy, below the breaker's window):
    two sessions over HTTP at once, each 12 s of a tone in 2 s base64
    chunks, every chunk request of one in flight with the other's (the
    store feeds them in turn); each final text equals a
    `StreamingTranscriber`'s alone on the same engine and chunks, whose
    per-chunk latency is timed beside the sessions'. Every decode step of
    the sessions runs fused_mlp_matvec and gqa_decode_attention once per
    layer."""
    import base64
    import urllib.request
    from http.server import ThreadingHTTPServer

    from qwen3_asr_gguf_tpu_torch.cli import demo_streaming
    from qwen3_asr_gguf_tpu_torch.ops import attn, mlp
    from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber

    t_phase = time.time()
    store, _ = demo_streaming.build(["--model-dir", str(model_dir), "--device", str(dev)],
                                    max_new_tokens=DEMO_NEW_TOKENS,
                                    decode_block=DEMO_NEW_TOKENS)
    engine = store.transcriber.engine
    init_s = time.time() - t_phase
    require(engine.generator.fused_mlp, "the demo's int8 engine runs no fused MLP")
    piece = int(DEMO_CHUNK_SECONDS * 16_000)
    audios = [tone(DEMO_SECONDS, f) for f in (310.0, 470.0)]
    pieces = [[a[i: i + piece] for i in range(0, len(a), piece)] for a in audios]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), demo_streaming.make_handler(store))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    together = threading.Barrier(2)
    finals, lat = [None, None], [[], []]

    def session(i):
        sid = post("/api/start", {})["sid"]
        for p in pieces[i]:
            together.wait(timeout=600)
            t0 = time.time()
            post("/api/chunk", {"sid": sid, "pcm": base64.b64encode(p.tobytes()).decode()})
            lat[i].append(time.time() - t0)
        finals[i] = post("/api/finish", {"sid": sid})["text"]

    wrappers = (mlp.fused_mlp_matvec, attn.gqa_decode_attention)
    try:
        for i in range(2):  # warm-up: each session alone, uncounted
            st = StreamingTranscriber(engine, chunk_size_sec=DEMO_CHUNK_SECONDS)
            state = st.init_state()
            st.feed(state, audios[i][: 2 * piece])
        for w in wrappers:
            w.launches = 0
        with StepCounter() as counter, ThreadPoolExecutor(2) as pool:
            t0 = time.time()
            list(pool.map(session, range(2)))
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = {w.__name__: w.launches for w in wrappers}
    finally:
        httpd.shutdown()
        httpd.server_close()
    alone, alone_lat = [], [[], []]
    for i in range(2):
        st = StreamingTranscriber(engine, chunk_size_sec=DEMO_CHUNK_SECONDS)
        state = st.init_state()
        for p in pieces[i]:
            t0 = time.time()
            st.feed(state, p)
            torch.cuda.synchronize()
            alone_lat[i].append(time.time() - t0)
        alone.append(st.finish(state))
    layers = engine.dec_cfg.num_layers
    row = {"phase": "demo_streaming", "engine_init_s": init_s, "sessions": 2,
           "audio_s": DEMO_SECONDS, "chunk_s": DEMO_CHUNK_SECONDS, "wall_s": wall,
           "chunk_latency_s": lat, "alone_chunk_latency_s": alone_lat,
           "decode_steps": counter.steps, "prefills": counter.prefills,
           "launches": launches, "texts_equal_alone": [finals[i] == alone[i] for i in range(2)],
           "text_chars": [len(t) for t in finals], "seconds": time.time() - t_phase}
    emit(row)
    require(all(finals) and finals == alone, f"demo texts {finals} != alone {alone}")
    require(counter.steps > 0 and all(n == layers * counter.steps for n in launches.values()),
            f"demo: {launches} launches for {counter.steps} decode steps of {layers} layers")
    del store, engine
    torch.cuda.empty_cache()
    return row


HF_PRESET = "qwen3-asr-0.6b"
HF_LAYERS = 4  # verify_weights_0p6b: the HF directory's depth (published widths)
HALF_LAYERS = 4  # asr_bf16: the f16 checkpoint's depth (published widths)


def ensure_hf_checkpoint() -> tuple[Path, float, bool]:
    """(directory, seconds, written now) of a seeded bf16 HF-layout
    qwen3-asr-0.6b checkpoint at HF_LAYERS layers beside the others."""
    from qwen3_asr_gguf_tpu_torch.devtools.hf_checkpoint import write_hf_checkpoint

    name = cut_preset(HF_PRESET, HF_LAYERS)
    out = REPO / ".bench_cache" / "torch" / f"{name}-hf"
    t0 = time.time()
    built = not (out / "model.safetensors").exists()
    if built:
        write_hf_checkpoint(str(out), name, seed=0)
    return out, time.time() - t0, built


def verify_weights_phase(torch, dev) -> dict:
    """The convert-and-verify path on a 0.6B HF-layout bf16 directory:
    `python -m qwen3_asr_gguf_tpu_torch.export --hf` (f16), then
    `cli/verify_weights.py verify(..., quant="q4_k")`: convert, load (the
    f32 engine transcribes 4 s; kernel 4 on its f32 cache) and both fidelity
    stages PASS (q4_matmul on every Q4Weight product of quant_accuracy's
    prefill); the oracle stage SKIP, naming the missing reference modeling.
    The CLI's f16 GGUF equals verify's byte for byte."""
    import filecmp

    from qwen3_asr_gguf_tpu_torch import preset
    from qwen3_asr_gguf_tpu_torch.cli import verify_weights
    from qwen3_asr_gguf_tpu_torch.ops import attn, qmm

    t_phase = time.time()
    hf, hf_s, hf_built = ensure_hf_checkpoint()
    work = REPO / ".bench_cache" / "torch" / "verify"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    cli = subprocess.run([sys.executable, "-m", "qwen3_asr_gguf_tpu_torch.export", "--hf",
                          str(hf), "--out", str(work / "cli"), "--quant", "f16"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    cli_s = time.time() - t0
    require(cli.returncode == 0, f"export --hf failed: {cli.stderr[-2000:]}")
    wrappers = (attn.gqa_decode_attention, qmm.q4_matmul)
    for w in wrappers:
        w.launches = 0
    t0 = time.time()
    with StepCounter() as counter:
        _, out = captured(lambda: verify_weights.verify(
            str(hf), str(work / "model"), quant="q4_k", device=str(dev)))
    torch.cuda.synchronize()
    verify_s = time.time() - t0
    stages = {}
    for line in out.splitlines():
        m = re.match(r"\[\s*(PASS|FAIL|SKIP)\] ([\w/-]+): (.*)", line)
        if m:
            stages[m.group(2)] = (m.group(1), m.group(3))
    launches = {w.__name__: w.launches for w in wrappers}
    products = q4_weight_products(work / "model" / "qwen3_asr_llm.q4_k.gguf")
    same_f16 = filecmp.cmp(work / "cli" / "qwen3_asr_llm.f16.gguf",
                           work / "model" / "qwen3_asr_llm.f16.gguf", shallow=False)
    layers = preset(cut_preset(HF_PRESET, HF_LAYERS)).text.num_layers
    row = {"phase": "verify_weights_0p6b", "preset": HF_PRESET, "layers": layers, "hf_written": hf_built,
           "hf_write_s": hf_s, "export_cli_s": cli_s, "verify_s": verify_s,
           "stages": stages, "decode_steps": counter.steps, "launches": launches,
           "q4_weight_products": products, "cli_f16_equals_verify_f16": same_f16,
           "seconds": time.time() - t_phase}
    emit(row)
    for stage in ("convert", "load", "fidelity/quant-cosine", "fidelity/ppl-delta"):
        require(stages.get(stage, ("missing",))[0] == "PASS", f"verify {stage}: {stages}")
    require(stages["oracle"] == ("SKIP", f"reference modeling not found: "
                                         f"{verify_weights.REF_TB}"), f"oracle: {stages}")
    require(same_f16, "the export CLI's f16 GGUF differs from verify's")
    require(counter.steps > 0 and launches["gqa_decode_attention"] == layers * counter.steps,
            f"verify: {launches} for {counter.steps} decode steps")
    require(launches["q4_matmul"] == products,
            f"verify: {launches['q4_matmul']} q4_matmul launches for {products} products")
    torch.cuda.empty_cache()
    return row


def examples_phase(torch, dev, model_dir: Path) -> dict:
    """The example twins: `examples.run_asr` at its defaults (int4, 40 s
    chunks, temperature 0.4; max_new_tokens 96 through the schema's
    default, which no argument sets) on a wav of the 50.2 s clip, kernels 1,
    2 and 4 launching; `examples.run_aligner` (the 0.6B aligner at its
    default int8) on a 10 s tone and a 12-word text, one item per word
    inside the clip plus the 4000 classes' span."""
    import dataclasses

    from qwen3_asr_gguf_tpu_torch.examples import run_aligner, run_asr
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k
    from qwen3_asr_gguf_tpu_torch.runtime.aligner import STEP_MS, TIMESTAMP_CLASSES

    t_phase = time.time()
    work = REPO / ".bench_cache" / "torch" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "clip.wav").write_bytes(wav_bytes(synthetic_clip(CLIP_SECONDS)))
    (work / "tone.wav").write_bytes(wav_bytes(tone(10.0, 440.0)))
    wrappers = (q4k.q4k_matvec, q4k.q4k_matvec_normed, attn.gqa_decode_attention)
    for w in wrappers:
        w.launches = 0

    @dataclasses.dataclass
    class Config(run_asr.ASREngineConfig):
        max_new_tokens: int = 96
        decode_block: int = 96

    saved, run_asr.ASREngineConfig = run_asr.ASREngineConfig, Config
    try:
        _, asr_out = captured(lambda: run_asr.main(
            [str(model_dir), str(work / "clip.wav"), "--device", str(dev)]))
    finally:
        run_asr.ASREngineConfig = saved
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    asr_s = time.time() - t_phase
    t0 = time.time()
    _, align_out = captured(lambda: run_aligner.main(
        [str(model_dir), str(work / "tone.wav"), ALIGN_CHECK_TEXT, "English",
         "--device", str(dev)]))
    items = []
    for line in align_out.splitlines():
        m = re.match(r"\[\s*([\d.]+) -\s*([\d.]+)\] (.*)", line)
        if m and m.group(3).strip():
            items.append((float(m.group(1)), float(m.group(2)), m.group(3)))
    transcript = asr_out.split("--- transcript ---\n", 1)[-1].split("\n--- performance ---")[0]
    latest = 10.0 + TIMESTAMP_CLASSES * STEP_MS / 1000.0
    row = {"phase": "examples", "run_asr_s": asr_s, "transcript_chars": len(transcript.strip()),
           "launches": launches, "run_aligner_s": time.time() - t0, "aligned_words": len(items),
           "items_head": items[:3], "seconds": time.time() - t_phase}
    emit(row)
    require(transcript.strip() and "decode_tokens" in asr_out, "run_asr printed no transcript")
    require(all(n > 0 for n in launches.values()), f"run_asr: a kernel never launched {launches}")
    require([w for _, _, w in items] == ALIGN_CHECK_TEXT.split(), f"aligned words {items}")
    require(all(0.0 <= a <= b <= latest for a, b, _ in items), f"items out of bounds {items}")
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# parallel/: tensor-parallel decode and serving, SP encode, the train step
# --------------------------------------------------------------------------

TP = 2  # ranks of the multi-rank phases, all on cuda:0 (gloo: NCCL refuses two ranks on a card)
TP_TIMED_RUNS = 20  # the local-shape kernels: replays per timing
TP_NEW_TOKENS = 8  # tp_batcher: greedy tokens per request
TRAIN_MEL_SECONDS = 10.0
TRAIN_STEPS = 3
TRAIN_CUT_LAYERS = 2
TRAIN_LOSS_REL = 1e-5  # f32: a loss of the same step in another world (sums in other orders)
TRAIN_GRAD_REL = 1e-4  # f32: each gradient leaf within this much of its largest entry
SP_ATOL, SP_RTOL = 2e-5, 1e-4  # the JAX dry run's bound
SP_WINDOWS, SP_LAYERS = 8, 4


def tp_local_shapes(cfg, tp: int) -> list[tuple[str, int, int]]:
    """(name, N, K) of the local q4_k tiles of a tp-way 1.7B decode step
    (unfused weights; the head padded to whole 2*BN*tp rows)."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    d, m = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mult = 2 * q4k.BN * tp
    return [("q_proj", hq * hd // tp, d), ("k_proj/v_proj", hkv * hd // tp, d),
            ("o_proj", d, hq * hd // tp), ("gate_proj/up_proj", m // tp, d),
            ("down_proj", d, m // tp), ("lm_head", -(-cfg.vocab_size // mult) * mult // tp, d)]


def tp_kernel_phase(torch, dev, cfg, tp: int = TP) -> list[dict]:
    """Kernels 1 and 3 (T = 8) at every local tile of a tp-way decode step,
    and kernels 4 and 5 (B = 8) over the local heads, each against its plain
    version (KERNEL_BOUND) and timed as in phases kernel, kernel_rows,
    kernel_attn_decode and kernel_attn (TP_TIMED_RUNS replays)."""
    global TIMED_RUNS
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k

    saved_runs, TIMED_RUNS = TIMED_RUNS, TP_TIMED_RUNS
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    rows = []
    try:
        for shape, n, k in tp_local_shapes(cfg, tp):
            nbytes, weights = cold_weights(torch, dev, g, n, k)
            for name, t in (("q4k_matvec", 1), ("q4k_matmul_rows", 8)):
                x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
                if t == 1:
                    kern = lambda w: q4k.q4k_matvec(x, w)  # noqa: E731
                    plain = lambda w: q4k.q4k_matvec_ref(x, w)  # noqa: E731
                else:
                    kern = lambda w: q4k.q4k_matmul_rows(x, w)  # noqa: E731
                    plain = lambda w: q4k.q4k_matmul_rows_ref(x, w)  # noqa: E731
                err, mag = rel_check(torch, f"{name}/tp{tp}/{shape}", kern(weights[0]),
                                     plain(weights[0]))
                ms = time_ms(kern, weights, torch)
                least, by = bound_ms(nbytes + 2 * t * (k + n), 2 * t * n * k, "int8")
                row = {"phase": "kernel_tp", "tp": tp, "name": name, "shape": shape, "t": t,
                       "n": n, "k": k, "max_abs_err": err, "max_abs_plain": mag,
                       "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
                       "ms": ms, "plain_ms": time_ms(plain, weights, torch),
                       "bound_ms": least, "bound_by": by,
                       "library_ms": dense_matmul_ms(torch, x, weights),
                       "library": "torch.matmul on the dequantized bf16 weight",
                       "gb_per_s": nbytes / (ms * 1e6)}
                emit(row)
                rows.append(row)
            del weights
        hq, hkv, d = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
        s_max, scale = 2048, d ** -0.5
        q1 = (torch.randn((1, hq, d), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        caches = [tuple(torch.randn((s_max, hkv, d), generator=g, device=dev)
                        .to(torch.bfloat16) for _ in "kv") for _ in range(16)]
        b = 8
        qb = (torch.randn((b, hq, d), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        q8 = []
        for _ in range(4):
            kq, ks = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
            vq, vs = dec._quant_kv(torch.randn((b, s_max, hkv, d), generator=g, device=dev))
            q8.append((kq, ks, vq, vs))
        for win in (256, 1024, 2048):
            pos = win - 1
            pt = torch.tensor([pos], dtype=torch.int32, device=dev)
            kern = lambda c: attn.gqa_decode_attention(q1, *c, pt, scale, win)  # noqa: E731
            plain = lambda c: attn.gqa_decode_attention_ref(q1, *c, pos, scale, win)  # noqa: E731
            err, mag = rel_check(torch, f"gqa_decode_attention/tp{tp}/win={win}",
                                 kern(caches[0]), plain(caches[0]))
            q4 = q1.permute(1, 0, 2)[None]

            def sdpa(c):
                k4, v4 = (t[:win].permute(1, 0, 2)[None] for t in c)
                return torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale, enable_gqa=True)

            least, by = bound_ms(2 * win * hkv * d * 2 + 2 * 2 * hq * d, 4 * win * hq * d, "bf16")
            row = {"phase": "kernel_tp", "tp": tp, "name": "gqa_decode_attention", "hq": hq,
                   "hkv": hkv, "d": d, "s": s_max, "win": win, "pos": pos,
                   "max_abs_err": err, "max_abs_plain": mag,
                   "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
                   "ms": time_ms(kern, caches, torch), "plain_ms": time_ms(plain, caches, torch),
                   "bound_ms": least, "bound_by": by, "library_ms": time_ms(sdpa, caches, torch),
                   "library": "scaled_dot_product_attention(enable_gqa=True) on the [:win] views"}
            emit(row)
            rows.append(row)
            spread = torch.randint(0, win, (b - 3,), generator=g, device=dev)
            poss = torch.cat([torch.tensor([5, 255, win - 1], device=dev), spread])
            kern = lambda c: attn.gqa_rows_q8_attention(qb, *c, poss, scale, win)  # noqa: E731
            plain = lambda c: attn.gqa_rows_q8_attention_ref(qb, *c, poss, scale, win)  # noqa: E731
            err, mag = rel_check(torch, f"gqa_rows_q8_attention/tp{tp}/win={win}",
                                 kern(q8[0]), plain(q8[0]))
            slots = int((poss + 1).sum())
            least, by = bound_ms(slots * hkv * (2 * d + 8) + 2 * 2 * b * hq * d,
                                 4 * slots * hq * d, "bf16")
            row = {"phase": "kernel_tp", "tp": tp, "name": "gqa_rows_q8_attention", "b": b,
                   "hq": hq, "hkv": hkv, "d": d, "s": s_max, "win": win, "poss": poss.tolist(),
                   "max_abs_err": err, "max_abs_plain": mag,
                   "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": True,
                   "ms": time_ms(kern, q8, torch), "plain_ms": time_ms(plain, q8, torch),
                   "bound_ms": least, "bound_by": by, "library_ms": None,
                   "library": "none: no single PyTorch call folds the int8 cache's scales in"}
            emit(row)
            rows.append(row)
    finally:
        TIMED_RUNS = saved_runs
    return rows


def random_tree(torch, shapes: dict, seed: int, dev) -> dict:
    """Weights of a stacked shape tree drawn on the card (norms and LayerNorm
    weights 1, biases 0, the rest N(0, 0.02)) as per-layer lists: every rank
    that asks with one seed gets the same values."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def fill(name, shape):
        if "norm" in name or name in ("ln1_w", "ln2_w", "ln_post_w"):
            return torch.ones(shape, device=dev)
        if name.endswith("_b"):
            return torch.zeros(shape, device=dev)
        return torch.randn(shape, generator=g, device=dev) * 0.02

    out = {k: fill(k, v) for k, v in sorted(shapes.items()) if k != "layers"}
    stacked = {k: fill(k, v) for k, v in sorted(shapes["layers"].items())}
    n = next(iter(stacked.values())).shape[0]
    out["layers"] = [{k: v[i] for k, v in stacked.items()} for i in range(n)]
    return out


def recorded_products(torch, run, keep=None):
    """(result of run(), one list per LM-head product of a fed step in it, of
    [top1, top2, argmax, ids, values] per row of its logits: the two largest
    logits, the argmax, and the ids and logits of the top four). A decode
    block's steps queued after its latch (which emit -1) are not fed steps
    and are left out: the block's packed result names them. `keep(params)`
    picks the products to record by their weights (all by default)."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    products, blocks, inner, dispatch = [], [], dec.lm_logits, Generator.decode_block_dispatch

    def recording(params, *args, **kw):
        out = inner(params, *args, **kw)
        if keep is None or keep(params):
            rows = []
            for row in out.float().reshape(-1, out.shape[-1]):
                top = torch.topk(row, 4)
                vals = top.values.tolist()
                rows.append([vals[0], vals[1], int(row.argmax()), top.indices.tolist(), vals])
            products.append(rows)
        return out

    def dispatching(self, *args, **kw):
        first = len(products)
        # eager steps: a replayed graph calls no `lm_logits` to record
        graphs, self.cuda_graphs = self.cuda_graphs, False
        try:
            state, packed = dispatch(self, *args, **kw)
        finally:
            self.cuda_graphs = graphs
        blocks.append((first, len(products), packed))
        return state, packed

    dec.lm_logits, Generator.decode_block_dispatch = recording, dispatching
    try:
        result = run()
    finally:
        dec.lm_logits, Generator.decode_block_dispatch = inner, dispatch
    latched = set()
    for first, end, packed in blocks:
        if packed is not None:
            emitted = packed.fetch()[:-2]
            latched.update(j for j in range(first, end) if emitted[j - first] < 0)
    return result, [p for j, p in enumerate(products) if j not in latched]


def recorded_greedy(torch, run, keep=None):
    """(result of run(), [top1, top2, argmax] of every fed LM-head product in it)."""
    result, products = recorded_products(torch, run, keep)
    return result, [row for rows in products for row in rows]


def greedy_clip(torch, engine, audio):
    """(text, fed tokens, logits record) of the engine's greedy call on the
    whole clip with BATCH_NEW_TOKENS new tokens per chunk in one block
    (below the breaker's window: no random retry), aligner off. One block per
    chunk is the pipelined chunk dispatch (chunk i+1 queued from chunk i's
    emitted buffer); with no breaker no queued chunk is thrown away, and the
    recorder leaves out steps queued after a latch."""
    gen = engine.generator
    saved = engine.aligner, engine.config.max_new_tokens, gen.block
    engine.aligner, engine.config.max_new_tokens, gen.block = (None, BATCH_NEW_TOKENS,
                                                               BATCH_NEW_TOKENS)
    try:
        res, logits = recorded_greedy(torch, lambda: engine.asr(
            audio, context="", language="Chinese", temperature=0.0))
    finally:
        engine.aligner, engine.config.max_new_tokens, gen.block = saved
    return res.text, [r[2] for r in logits], logits


INT8_KV_NOISE_REL = 0.02  # of the top logit; one int8 KV step is 1/127 of a head's amax


def int8_kv_verdict(phase: str, ref_text: str, ref: list, got_text: str, got: list,
                    limit: int) -> dict:
    """The near-tie rule where both runs quantize their K and V to int8 per
    (slot, head): a rank's bf16 partial sums move some values across an
    int8 rounding step, so the logits of two runs on the same tokens differ
    by more than bf16 rounding. `ref` / `got` are `recorded_products` rows
    per fed token. Let eps be INT8_KV_NOISE_REL of the reference's largest
    top logit. Over the steps where the tokens agree, the two runs' top
    logits must agree within eps; where the tokens part, the token `got`
    chose must be among the reference's top four and within 2 eps of the
    reference's top logit (two logits that each move by at most eps can
    swap only so close). Raises otherwise."""
    n = min(len(ref), len(got), limit)
    first = next((i for i in range(n) if ref[i][2] != got[i][2]), None)
    same = range(n if first is None else first)
    noise = max((abs(ref[j][0] - got[j][0]) for j in same), default=0.0)
    scale = max(abs(r[0]) for r in ref[:n])
    eps = INT8_KV_NOISE_REL * scale
    row = {"texts_equal": ref_text == got_text, "tokens_compared": n,
           "first_differing_step": first, "top1_noise": noise, "noise_limit": eps}
    require(n > 0 and ref_text and got_text, f"{phase}: no tokens")
    require(noise <= eps,
            f"{phase}: top logits differ by {noise} on the same tokens (> {row['noise_limit']})")
    require(first is not None or ref_text == got_text,
            f"{phase}: equal tokens but different texts")
    if first is not None:
        r, g = ref[first], got[first]
        row.update(ref_top4=r[3], ref_top4_logits=r[4], got_token=g[2],
                   got_top4=g[3], got_top4_logits=g[4], gap_limit=2 * eps)
        require(g[2] in r[3], f"{phase}: tokens part at step {first} outside the reference's "
                              f"top four: {row}")
        row["gap"] = r[0] - r[4][r[3].index(g[2])]
        require(row["gap"] <= row["gap_limit"],
                f"{phase}: tokens part at step {first} on a token {row['gap']} below the "
                f"reference's top (limit {row['gap_limit']})")
    return row


def tone_requests(seconds: float = SERVE_CLIP_SECONDS):
    return [tone(seconds, f) for f in (220.0, 330.0)]


def lockstep_batcher_run(torch, engine) -> dict:
    """Two greedy 10 s tones through a ContinuousBatcher on `engine` (the
    lockstep loop under a mesh: rank 0 submits, the others follow); per rank
    the texts (rank 0), kernels 3 and 5's launches and the rows steps."""
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher

    wrappers = (q4k.q4k_matmul_rows, attn.gqa_rows_q8_attention)
    for w in wrappers:
        w.launches = 0
    t0 = time.time()
    cb = ContinuousBatcher(engine, max_batch=2, block=TP_NEW_TOKENS,
                           max_new_tokens=TP_NEW_TOKENS)
    texts, streams = None, None
    if cb.leader:
        try:
            texts, products = recorded_products(torch, lambda: [
                cb.submit(a, language="English", temperature=0.0, timeout=600.0).text
                for a in tone_requests()])
        finally:
            cb.close()
        # one request at a time (submit waits): its staging prefill is a
        # one-row product, then it is row 0 of each rows step
        streams = []
        for rows in products:
            if len(rows) == 1:
                streams.append([rows[0]])
            else:
                streams[-1].append(rows[0])
    else:
        cb.follow()
    torch.cuda.synchronize()
    return {"texts": texts, "streams": streams, "rows": cb.b,
            "steps": cb.stats["n_blocks"] * cb.block,
            "launches": {w.__name__: w.launches for w in wrappers},
            "seconds": time.time() - t0}


def with_int8_kv(torch, engine):
    """`engine` with its generator's KV cache dtype set to int8, as
    `kv_cache_dtype="int8"` builds it (a batcher takes its caches' dtype from
    there), without loading the checkpoint again. Its single-stream steps
    run eagerly on fresh int8 caches: the graphs and the cache pool hold
    bf16 caches."""
    engine.config.kv_cache_dtype = "int8"
    engine.generator.cache_dtype = torch.int8
    engine.generator.cuda_graphs = False
    return engine


def tp_engine(torch, model_dir: str, mesh_shape, dev):
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine

    return QwenASREngine(ASREngineConfig(
        model_dir=model_dir, llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4", n_ctx=2048,
        chunk_size=40.0, memory_num=1, verbose=False, max_new_tokens=96, decode_block=96,
        kv_prefix_reuse=True, kv_cache_dtype="bf16", enable_aligner=False, mesh_shape=mesh_shape,
    ), device=dev)


def _rank_setup():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch


def train_config(layers: int | None = None):
    import dataclasses

    from qwen3_asr_gguf_tpu_torch import preset

    cfg = preset(PRESET)
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, audio=dataclasses.replace(cfg.audio, encoder_layers=layers),
            text=dataclasses.replace(cfg.text, num_layers=layers))
    return cfg


def train_batch(cfg):
    """B = 2, TRAIN_MEL_SECONDS of mel, the audio tokens at slots 1 .. Ta and
    32 text tokens after them."""
    from qwen3_asr_gguf_tpu_torch.models.encoder import get_feat_extract_output_lengths
    from qwen3_asr_gguf_tpu_torch.parallel import train as T

    t_mel = int(TRAIN_MEL_SECONDS * 100)
    n_audio = get_feat_extract_output_lengths(t_mel, cfg.audio.n_window)
    return T.thinker_batch(cfg, 2, t_mel, n_audio + 33, n_audio, seed=0)


def _world_one_rank(rank, world, device, model_dir, audio, ref_path):
    """The NCCL world of one rank: the engine at mesh {"model": 1} on the
    clip (tp_engine_nccl), the lockstep batcher's single-rank references at
    bf16 and int8 KV, the full-depth train step, and the 2-layer train
    reference for tp_train."""
    torch = _rank_setup()
    from qwen3_asr_gguf_tpu_torch.parallel import sharding as S
    from qwen3_asr_gguf_tpu_torch.parallel import train as T

    dev = torch.device(device)
    out = {"backend": torch.distributed.get_backend()}
    t0 = time.time()
    engine = tp_engine(torch, model_dir, {"model": 1}, dev)
    out["engine_init_s"] = time.time() - t0
    layer = engine.generator.params["layers"][0]
    out["unfused"] = "q_proj" in layer and "qkv_proj" not in layer
    t0 = time.time()
    out["text"], out["tokens"], _ = greedy_clip(torch, engine, audio)
    out["clip_s"] = time.time() - t0
    out["batcher_bf16"] = lockstep_batcher_run(torch, engine)
    out["batcher_int8"] = lockstep_batcher_run(torch, with_int8_kv(torch, engine))
    del engine
    torch.cuda.empty_cache()

    cfg = train_config()
    mesh = S.make_mesh({"model": 1})
    init_fn, step_fn = T.make_train_step(cfg, mesh, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    state = init_fn(0)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    batch = train_batch(cfg)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        state, loss = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(loss)
    n_params = sum(t.numel() for _, t in T._leaves(state.params))
    out["train"] = {"layers": cfg.text.num_layers, "encoder_layers": cfg.audio.encoder_layers,
                    "params": n_params, "init_s": init_s, "losses": losses, "step_s": step_s,
                    "peak_gpu_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                    "batch": {k: list(v.shape) for k, v in batch.items()}}
    del state
    torch.cuda.empty_cache()

    cut = train_config(TRAIN_CUT_LAYERS)
    init_fn, step_fn = T.make_train_step(cut, mesh, device=dev)
    state = init_fn(1)
    batch = train_batch(cut)
    state, loss1 = step_fn(state, batch)
    grads = {name: t.grad.detach().cpu().clone() for name, t in T._leaves(state.params)}
    state, loss2 = step_fn(state, batch)
    torch.save({"losses": [loss1, loss2], "grads": grads}, ref_path)
    out["train_cut_losses"] = [loss1, loss2]
    return out


def _tp_world_rank(rank, world, device, model_dir, ref_path, ckpt_path):
    """A gloo world of TP ranks on cuda:0: tp_decode, sp_encode, tp_batcher
    and tp_train."""
    torch = _rank_setup()
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
    from qwen3_asr_gguf_tpu_torch.models import encoder as enc
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k
    from qwen3_asr_gguf_tpu_torch.parallel import dryrun as D
    from qwen3_asr_gguf_tpu_torch.parallel import sharding as S
    from qwen3_asr_gguf_tpu_torch.parallel import train as T
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    dev = torch.device(device)
    mesh = S.make_mesh({"model": world})
    out = {}

    # tp_decode: the 1.7B decoder's widths at 2 layers, f32, vocab 151,936
    t0 = time.time()
    flag = D.flagship_text()
    params = random_tree(torch, dec.init_shapes(flag), 2, dev)
    prompt = D.spliced_prompt(flag, 3)
    single = D.generator_tokens(params, flag, prompt, device=dev)
    tp_toks = D.generator_tokens(params, flag, prompt, mesh=mesh, device=dev)
    del params
    torch.cuda.empty_cache()
    out["f32"] = {"single": single, "tp": tp_toks, "seconds": time.time() - t0}

    # packed int4 at the same widths: the 1.7B q4_k GGUF's first 2 layers and its head
    t0 = time.time()
    import dataclasses

    cfg4, p4, _ = P.load_decoder_gguf(f"{model_dir}/qwen3_asr_llm.q4_k.gguf", precision="int4",
                                      device=dev)
    cfg4 = dataclasses.replace(cfg4, num_layers=2)
    p4 = dict(p4, layers=p4["layers"][:2])
    torch.cuda.empty_cache()
    prompt4 = D.spliced_prompt(cfg4, 4)

    def run4(gen):
        st_ = gen.start_spliced(prompt4[0], prompt4[1], prompt4[2].to(dev, torch.bfloat16),
                                temperature=0.0, seed=5)
        for w in (q4k.q4k_matvec, attn.gqa_decode_attention):
            w.launches = 0
        toks, _, _, _ = gen.decode_block(st_, temperature=0.0)
        torch.cuda.synchronize()
        return toks, {w.__name__: w.launches for w in (q4k.q4k_matvec, attn.gqa_decode_attention)}

    gen1 = Generator(p4, cfg4, n_ctx=512, block=8, cache_dtype=torch.bfloat16, device=dev)
    (single4, _), logits4 = recorded_greedy(torch, lambda: run4(gen1))
    del gen1
    gen2 = Generator(p4, cfg4, n_ctx=512, block=8, cache_dtype=torch.bfloat16, device=dev,
                     mesh=mesh)
    tiles = {n: list(w.shape) for n, w in gen2.params["layers"][0].items() if hasattr(w, "sub_t")}
    tiles["lm_head"] = list(gen2.params["lm_head"].shape)
    tp4, launches4 = run4(gen2)
    del gen2, p4
    torch.cuda.empty_cache()
    out["int4"] = {"single": single4, "tp": tp4, "launches": launches4, "tiles": tiles,
                   "single_logits": logits4, "seconds": time.time() - t0}

    # sp_encode: the 1.7B encoder's widths, SP_LAYERS layers, SP_WINDOWS windows
    t0 = time.time()
    ecfg = dataclasses.replace(train_config().audio, encoder_layers=SP_LAYERS,
                               attention_mode="windowed")
    eparams = random_tree(torch, enc.init_shapes(ecfg), 4, dev)
    win = ecfg.tokens_per_window * (ecfg.n_window_infer // ecfg.n_window)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    hidden = torch.randn((SP_WINDOWS * win, ecfg.d_model), generator=g, device=dev) * 0.1
    whole = enc.backend_transformer(eparams, ecfg, hidden)
    split = enc.backend_transformer(eparams, ecfg, hidden, sp_group=mesh.get_group("model"))
    torch.cuda.synchronize()
    diff = (split - whole).abs()
    out["sp"] = {"windows": SP_WINDOWS, "tokens": SP_WINDOWS * win, "layers": SP_LAYERS,
                 "max_abs_diff": diff.max().item(),
                 "within": bool(torch.all(diff <= SP_ATOL + SP_RTOL * whole.abs())),
                 "seconds": time.time() - t0}
    del eparams, whole, split
    torch.cuda.empty_cache()

    # tp_batcher: the 1.7B int4 checkpoint at full depth, bf16 and int8 KV
    t0 = time.time()
    engine = tp_engine(torch, model_dir, {"model": world}, dev)
    init_s = time.time() - t0
    for kv in ("bf16", "int8"):
        if kv == "int8":
            engine = with_int8_kv(torch, engine)
        out[f"batcher_{kv}"] = {**lockstep_batcher_run(torch, engine), "engine_init_s": init_s,
                                "layers": engine.dec_cfg.num_layers}
    del engine
    torch.cuda.empty_cache()

    # tp_train: the 2-layer cut against the world of one, then a checkpoint round trip
    t0 = time.time()
    cut = train_config(TRAIN_CUT_LAYERS)
    init_fn, step_fn = T.make_train_step(cut, mesh, device=dev)
    state = init_fn(1)
    batch = train_batch(cut)
    state, loss1 = step_fn(state, batch)
    ref = torch.load(ref_path, map_location="cpu", weights_only=True)
    specs = [s for _, s in T._leaves(T.thinker_param_specs(cut))]
    rank_m, n_m = S.mesh_dim(mesh, "model")
    worst = 0.0
    for (name, leaf), spec in zip(T._leaves(state.params), specs):
        want = S.split_leaf(ref["grads"][name], spec, rank_m, n_m).to(dev)
        err = (leaf.grad - want).abs().max().item()
        if want.abs().max().item() > 1e-8:  # a leaf whose gradient is 0 (the key bias) aside
            worst = max(worst, err / want.abs().max().item())
        if err > TRAIN_GRAD_REL * want.abs().max().item() + 1e-9:
            raise RuntimeError(f"tp_train: gradient {name} off by {err} "
                               f"(largest entry {want.abs().max().item()})")
    del ref
    T.save_checkpoint(ckpt_path, state, cut, mesh)
    back = T.restore_checkpoint(ckpt_path, init_fn(7), cut, mesh)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(T._leaves(state.params),
                                                           T._leaves(back.params)))
    state, loss2 = step_fn(state, batch)
    out["train"] = {"losses": [loss1, loss2], "grad_worst_rel": worst,
                    "checkpoint_params_equal": same, "checkpoint_step": back.step,
                    "seconds": time.time() - t0}
    return out


def tp_phases(torch, dev, model_dir: Path, audio, engine_greedy: tuple) -> dict:
    """tp_engine_nccl, tp_decode, sp_encode, tp_batcher and train_step: the
    NCCL world of one rank, then the gloo world of TP ranks on this card."""
    from qwen3_asr_gguf_tpu_torch.ops import q4k
    from qwen3_asr_gguf_tpu_torch.parallel.launch import spawn

    work = REPO / ".bench_cache" / "torch" / "tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cuda0 = lambda r: "cuda:0"  # noqa: E731
    t0 = time.time()
    one = spawn(_world_one_rank, 1, "nccl", cuda0, str(work / "world1"),
                args=(str(dev), str(model_dir), audio, str(work / "train_ref.pt")), threads=8,
                timeout=1100)[0]
    world_one_s = time.time() - t0

    text, tokens, logits = engine_greedy
    verdict = near_tie_verdict("tp_engine_nccl", text, tokens, logits, one["text"],
                               one["tokens"], limit=len(tokens))
    row = {"phase": "tp_engine_nccl", "backend": one["backend"], "mesh": {"model": 1},
           "unfused": one["unfused"], "engine_init_s": one["engine_init_s"],
           "clip_s": one["clip_s"], "audio_s": CLIP_SECONDS, "new_tokens_per_chunk":
           BATCH_NEW_TOKENS, "engine_text": text, "mesh_text": one["text"], **verdict}
    emit(row)
    require(one["backend"] == "nccl" and one["unfused"], f"tp_engine_nccl: {row}")

    tr = one["train"]
    row = {"phase": "train_step", "world": 1, "backend": "nccl", **tr,
           "params_gb_f32": tr["params"] * 4 / 1e9}
    emit(row)
    require(all(math.isfinite(x) for x in tr["losses"]) and tr["losses"][-1] < tr["losses"][0],
            f"train_step: losses {tr['losses']}")

    t0 = time.time()
    ranks = spawn(_tp_world_rank, TP, "gloo", cuda0, str(work / "world2"),
                  args=(str(dev), str(model_dir), str(work / "train_ref.pt"), str(work / "ckpt.pt")),
                  threads=4, timeout=1100)
    tp_world_s = time.time() - t0
    lead = ranks[0]
    f32, i4 = lead["f32"], lead["int4"]
    steps4 = len(i4["tp"])
    int4_verdict = near_tie_verdict("tp_decode/int4", str(i4["single"]), i4["single"],
                                    i4["single_logits"], str(i4["tp"]), i4["tp"], limit=steps4)
    row = {"phase": "tp_decode", "tp": TP, "backend": "gloo (CUDA tensors taken directly)",
           "f32_vocab": 151936, "f32_single": f32["single"], "f32_tp": f32["tp"],
           "f32_s": f32["seconds"], "int4_single": i4["single"], "int4_tp": i4["tp"],
           "int4_tiles": i4["tiles"], "int4_s": i4["seconds"],
           "int4_launches_per_rank": [r["int4"]["launches"] for r in ranks],
           "int4_near_tie": int4_verdict, "ranks_equal": all(
               (r["f32"]["tp"], r["int4"]["tp"]) == (f32["tp"], i4["tp"]) for r in ranks),
           "world_s": tp_world_s, "world_one_s": world_one_s}
    emit(row)
    require(f32["single"] == f32["tp"] and len(f32["tp"]) == 8, f"tp_decode f32: {row}")
    require(row["ranks_equal"], "tp_decode: the ranks emitted different tokens")
    for r in ranks:
        got = r["int4"]["launches"]
        require(got == {"q4k_matvec": 15 * steps4, "gqa_decode_attention": 2 * steps4},
                f"tp_decode int4: launches {got} for {steps4} steps")

    sp = lead["sp"]
    emit({"phase": "sp_encode", "tp": TP, **sp, "bound": f"atol {SP_ATOL}, rtol {SP_RTOL}"})
    require(all(r["sp"]["within"] for r in ranks), f"sp_encode: {sp}")

    for kv in ("bf16", "int8"):
        ref, got = one[f"batcher_{kv}"], lead[f"batcher_{kv}"]
        per_step = 7 * got["layers"] + 1
        # each request's fed tokens against the world of one's, by the near-tie
        # rule (bf16 KV) or its int8-KV twin
        verdicts = []
        for j in range(len(ref["texts"])):
            what = f"tp_batcher {kv} request {j}"
            if kv == "int8":
                verdicts.append(int8_kv_verdict(what, ref["texts"][j], ref["streams"][j],
                                                got["texts"][j], got["streams"][j],
                                                TP_NEW_TOKENS))
            else:
                verdicts.append(near_tie_verdict(
                    what, ref["texts"][j], [r[2] for r in ref["streams"][j]],
                    ref["streams"][j], got["texts"][j], [r[2] for r in got["streams"][j]],
                    limit=TP_NEW_TOKENS))
        row = {"phase": "tp_batcher", "tp": TP, "kv": kv, "single_texts": ref["texts"],
               "tp_texts": got["texts"], "verdicts": verdicts, "rows": got["rows"],
               "steps": got["steps"],
               "launches_per_rank": [r[f"batcher_{kv}"]["launches"] for r in ranks],
               "per_step_q4k_matmul_rows": per_step, "engine_init_s": got["engine_init_s"],
               "seconds": got["seconds"]}
        emit(row)
        require(all(got["texts"]), f"tp_batcher {kv}: an empty transcript")
        for r in ranks:
            b = r[f"batcher_{kv}"]
            require(b["steps"] > 0 and b["launches"]["q4k_matmul_rows"] == per_step * b["steps"],
                    f"tp_batcher {kv}: {b}")
            if kv == "int8":
                require(b["launches"]["gqa_rows_q8_attention"] == got["layers"] * b["steps"],
                        f"tp_batcher int8: {b}")

    tt = lead["train"]
    ref_losses = one["train_cut_losses"]
    row = {"phase": "train_step", "world": TP, "backend": "gloo", "layers": TRAIN_CUT_LAYERS,
           **tt, "world_one_losses": ref_losses,
           "bound": f"loss rel {TRAIN_LOSS_REL}; each gradient leaf <= {TRAIN_GRAD_REL} x its "
                    "largest entry + 1e-9"}
    emit(row)
    require(abs(tt["losses"][0] - ref_losses[0]) <= TRAIN_LOSS_REL * abs(ref_losses[0]),
            f"tp_train: losses {tt['losses']} vs {ref_losses}")
    require(tt["checkpoint_params_equal"] and tt["checkpoint_step"] == 1, f"tp_train: {tt}")
    shutil.rmtree(work, ignore_errors=True)
    return {"q4k_matvec": lead["int4"]["launches"]["q4k_matvec"],
            "gqa_decode_attention": lead["int4"]["launches"]["gqa_decode_attention"],
            "q4k_matmul_rows": lead["batcher_bf16"]["launches"]["q4k_matmul_rows"],
            "gqa_rows_q8_attention": lead["batcher_int8"]["launches"]["gqa_rows_q8_attention"]}


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
    # the checkpoints are written on a thread of their own (host work) while
    # the kernel phases time the card (CUDA events on the device)
    with ThreadPoolExecutor(max_workers=1) as pool:
        checkpoint = pool.submit(ensure_checkpoint)
        kernel_rows = kernel_phase(torch, dev, cfg.text)
        kernel_rows += rows_kernel_phase(torch, dev, cfg.text)
        kernel_rows += attn_kernel_phase(torch, dev, cfg.text)
        kernel_rows += decode_attn_kernel_phase(torch, dev, cfg.text)
        kernel_rows += qmm_kernel_phase(torch, dev, cfg)
        kernel_rows += mlp_kernel_phase(torch, dev)
        model_dir = checkpoint.result()
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
    def ms_per_step(res, counts) -> float:
        """The call's decode time per queued step (the counted normed matvecs)."""
        steps = counts["q4k_matvec_normed"] // (2 * cfg.text.num_layers)
        return res.performance["decode_time"] * 1e3 / max(steps, 1)

    aligner, fast = engine.aligner, attn.gqa_decode_attention
    res, wall, counts = timed_asr(0.4)
    compare, step_ms = {"aligned_kernel": wall}, {"aligned_kernel": ms_per_step(res, counts)}
    engine.aligner = None
    compare["aligner_off"] = timed_asr(0.4)[1]
    engine.aligner = aligner
    # the plain attention in eager steps: the captured graphs replay the kernel
    attn.gqa_decode_attention = attn.gqa_decode_attention_ref
    graphs, engine.generator.cuda_graphs = engine.generator.cuda_graphs, False
    try:
        _, compare["aligned_plain_attention"], plain_counts = timed_asr(0.4)
    finally:
        attn.gqa_decode_attention, engine.generator.cuda_graphs = fast, graphs
    compare["aligned_kernel_again"] = timed_asr(0.4)[1]
    engine.config.pipelined_dispatch = False  # the synchronous flow
    try:
        res, compare["pipelined_off"], counts = timed_asr(0.4)
        step_ms["pipelined_off"] = ms_per_step(res, counts)
    finally:
        engine.config.pipelined_dispatch = True
    emit({"phase": "asr_compare", "temperature": 0.4, "audio_s": CLIP_SECONDS,
          "wall_s": compare, "rtf": {k: v / CLIP_SECONDS for k, v in compare.items()},
          "ms_per_step": step_ms})
    require(plain_counts["gqa_decode_attention"] == 0, "the plain attention launched the kernel")

    asr_pipeline_phase(torch, engine, audio)
    block_sync_free_phase(torch, engine, audio)
    decode_step_check(torch, engine)
    align_check(torch, engine, model_dir)
    emb = engine.encoder.encode(torch.from_numpy(audio[: 40 * 16_000]).to(dev))
    n_tok = engine.encoder.valid_tokens(40 * 16_000)
    require(tuple(emb.shape) == (n_tok, cfg.audio.output_dim), f"encoder shape {tuple(emb.shape)}")
    require(bool(torch.isfinite(emb).all()), "encoder output not finite")
    emit({"phase": "encoder_check", "shape": list(emb.shape), "finite": True})
    encode_graph_phase(torch, dev, model_dir)

    for kv in (torch.bfloat16, torch.int8):
        rows_step_check(torch, engine, kv)
    batcher_vs_engine_phase(torch, engine, audio)
    engine_greedy = greedy_clip(torch, engine, audio)  # tp_engine_nccl's reference
    # chunk 1 carries chunk 0's greedy tokens less the 5-token rollback
    cohort_held = cohort_prefill_phase(torch, engine, audio, engine_greedy[1][:10])
    # block_profile's generator and chunk-0 prefill state, held to the end
    # (the dense prefill copy is dropped)
    block_gen = engine.generator
    block_state = block_gen.start_spliced(*chunk_prompt(torch, engine, audio), temperature=0.4,
                                          seed=0)
    block_gen._prefill_params = None
    del engine
    torch.cuda.empty_cache()

    ran_int8 = asr_int8_phase(torch, dev, model_dir, audio)
    ran_q4k = asr_q4k_phase(torch, dev, model_dir, audio)
    served = serve_phase(torch, dev, model_dir)
    served_int8 = serve_int8_phase(torch, dev, model_dir)
    serve_phase(torch, dev, model_dir, prec="q4_k", requests=8, long_request=False)
    serve_timestamp_phase(torch, dev, model_dir)
    serve_micro_phase(torch, dev, model_dir)
    serve_micro_phase(torch, dev, model_dir, prec="q4_k")
    asr_bf16_phase(torch, dev)
    transcribe_cli_phase(torch, dev, model_dir)
    quant_accuracy_phase(torch, dev, model_dir)
    perplexity_phase(torch, dev, model_dir)
    demo_streaming_phase(torch, dev, model_dir)
    verify_weights_phase(torch, dev)
    examples_phase(torch, dev, model_dir)
    # the MoE engine takes ~41 GB: free the earlier phases' engines first (the
    # serve phases' batchers sit in reference cycles, and each engine holds its
    # encoder's and decoder's graph pools until it is collected)
    gc.collect()
    torch.cuda.empty_cache()
    moe_rows, moe_asr = moe_phase(torch, dev, audio)
    kernel_rows += tp_kernel_phase(torch, dev, cfg.text)
    tp_launches = tp_phases(torch, dev, model_dir, audio, engine_greedy)
    block_walls = time_blocks(torch, block_gen, block_state)
    device_kernels_phase(torch, dev, cfg.text)
    moe_device_kernels(torch, dev)
    cohort_kernels_phase(torch, block_gen, cohort_held)
    del cohort_held
    # its one large profiler session last: the sessions after such a window
    # lose events
    block_profile_phase(torch, block_gen, block_state, block_walls)
    del block_gen, block_state
    # each kernel's launches from the run of its own path
    launches["q4k_matmul_rows"] = served["launches"]["q4k_matmul_rows"]
    launches["gqa_rows_q8_attention"] = served_int8["launches"]["gqa_rows_q8_attention"]
    launches["q4_matmul"] = ran_q4k["launches"]["q4_matmul"]
    launches["fused_mlp_matvec"] = ran_int8["launches"]["fused_mlp_matvec"]
    paths = {"q4k_matvec": "asr (temperature 0.4)", "q4k_matvec_normed": "asr (temperature 0.4)",
             "gqa_decode_attention": "asr (temperature 0.4)",
             "q4k_matmul_rows": "serve (bf16 KV)", "gqa_rows_q8_attention": "serve_int8_kv",
             "q4_matmul": "asr_q4k (temperature 0.4)",
             "fused_mlp_matvec": "asr_int8 (temperature 0.4)"}

    def case(r):
        tp = f"tp{r['tp']} " if "tp" in r else ""
        if "t" in r:
            return f"{tp}{r['shape']}/T={r['t']}"
        return tp + (r.get("shape") or f"win={r['win']}")

    def total(rows, key):
        return None if any(r[key] is None for r in rows) else sum(r[key] for r in rows)

    timed = ("ms", "plain_ms", "bound_ms", "library_ms")
    kernels = []
    for name in REPLACES:
        mine = [r for r in kernel_rows if r["name"] == name]
        # one call at each of the kernel's main-path shapes, summed: the
        # multi-row matmul at T = 8 (the serving batch), the attention
        # kernels at the 1024-slot window, q4_matmul at T = 1 (the decode
        # step), the fused MLP at the 1.7B shape
        main_t = 1 if name == "q4_matmul" else ROWS_T[0]
        summed = [r for r in mine if r.get("t", main_t) == main_t and "tp" not in r
                  and r.get("win", ATTN_HEADLINE_WIN) == ATTN_HEADLINE_WIN
                  and r.get("hidden", cfg.text.hidden_size) == cfg.text.hidden_size]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name], "path": paths[name],
            # per rank, in the tp = 2 phases (tp_decode: one decode block; tp_batcher)
            "tp_launches": tp_launches.get(name),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{key: total(summed, key) for key in timed},
            "bound_by": summed[0]["bound_by"],
            "shapes": {case(r): {**{key: r[key] for key in timed},
                                 "max_abs_err": r["max_abs_err"]} for r in mine},
        })
    # kernel 8, the port's own (no TPU kernel): its bf16 row's times
    timed_row = next(r for r in moe_rows if "ms" in r)
    kernels.append({
        "name": "expert_matvec", "route": "cuda",
        "source": "qwen3_asr_gguf_tpu_torch/csrc/moe_matvec.cu", "replaces": None,
        "launches": moe_asr["launches"]["expert_matvec"], "path": "moe_asr (temperature 0.4)",
        "device_kernels_per_call": 2, "max_abs_err": max(r["max_abs_err"] for r in moe_rows),
        **{key: timed_row[key] for key in timed + ("eager_ms", "bound_by")},
        "shapes": {f"{timed_row['shape']}/{r['x']}": {"max_abs_err": r["max_abs_err"]}
                   for r in moe_rows}})
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
