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
   (CUDA events, median of 50 launches, L2 flushed before each);
4. builds the shared native codec (when g++ is present) and a random-weight
   qwen3-asr-1.7b int4 checkpoint in .bench_cache/torch/;
5. QwenASREngine at the bench headline settings (int4, bf16 KV, 40 s chunks,
   decode_block = max_new_tokens = 96, KV prefix reuse, no aligner) on a
   50.2 s synthetic clip: one warm-up pass, then temperature 0.4 and 0,
   each with the kernels' launch counts of that run;
6. one full-width decode step through the kernels against the same step on
   dense dequantized weights (cosine bound), and finite encoder output.

The last lines are the kernels summary, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device, or run where the
package is missing, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PRESET = "qwen3-asr-1.7b"
CLIP_SECONDS = 50.2
TIMED_RUNS = 50
KERNEL_BOUND = 1e-2  # max|kernel - plain| <= KERNEL_BOUND * max|plain| (bf16 outputs)
STEP_COSINE_BOUND = 0.99  # int8-activation kernel path vs dense bf16 weights


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


def kernel_phase(torch, dev, cfg) -> list[dict]:
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    d, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    head_rows = -(-v // 1024) * 1024  # the engine pads the head to 1024 rows
    cases = [  # (kernel, shape name, N, K)
        ("q4k_matvec", "o_proj", d, hq * hd),
        ("q4k_matvec", "down_proj", d, m),
        ("q4k_matvec", "lm_head", head_rows, d),
        ("q4k_matvec_normed", "qkv_proj", (hq + 2 * hkv) * hd, d),
        ("q4k_matvec_normed", "gateup_proj", 2 * m, d),
    ]
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def random_weight(n, k):
        # any bytes are a valid q4_k weight in this layout: draw it on the card
        return q4k.Q4KWeight(
            packed=torch.randint(0, 256, (n // 2, k), generator=g, device=dev, dtype=torch.uint8),
            sub_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
            min_t=torch.randint(0, 64, (k // 32, n), generator=g, device=dev, dtype=torch.int8),
            dd_t=torch.rand((2 * (k // 256), n), generator=g, device=dev) * 1e-3,
        )

    rows = []
    for name, shape, n, k in cases:
        nbytes = n * k // 2 + 2 * (k // 32) * n + 4 * (k // 128) * n
        weights = [random_weight(n, k) for _ in range(max(2, -(-(128 << 20) // nbytes)))]
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
        row = {"phase": "kernel", "name": name, "shape": shape, "n": n, "k": k,
               "max_abs_err": err, "max_abs_plain": scale,
               "bound": f"max_abs_err <= {KERNEL_BOUND} * max_abs_plain", "ok": ok,
               "ms": ms, "plain_ms": time_ms(plain, weights, torch),
               "weight_mb": nbytes / 1e6, "gb_per_s": nbytes / (ms * 1e6)}
        emit(row)
        require(ok, f"{name}/{shape}: kernel disagrees with its plain version ({err} > bound)")
        rows.append(row)
        del weights
    return rows


def ensure_checkpoint() -> Path:
    from qwen3_asr_gguf_tpu import native
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
    emit({"phase": "checkpoint", "preset": PRESET, "native_codec": native.available(),
          "native_build_s": native_s, "built": built, "seconds": time.time() - t1})
    return out


def synthetic_clip(seconds: float):
    import numpy as np

    t = np.arange(int(seconds * 16_000)) / 16_000
    return (np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t) * 0.3).astype(np.float32)


def decode_step_check(torch, engine) -> None:
    """One decode step through the int4 kernels vs the same step on dense
    dequantized bf16 weights, from the same prefilled cache."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec
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
    h_k, _ = dec.forward_step_layers(gen.params["layers"], gen.params["final_norm"], cfg,
                                     embd, cache, 64, attn_window=256)
    h_d, _ = dec.forward_step_layers(dense["layers"], dense["final_norm"], cfg, embd, twin, 64,
                                     attn_window=256)
    lk = dec.lm_logits(gen.params, h_k, cfg.vocab_size)
    ld = dec.lm_logits({"lm_head": dequant_mxu(gen.params["lm_head"])}, h_d, cfg.vocab_size)
    cos = torch.nn.functional.cosine_similarity(lk, ld, dim=0).item()
    finite = bool(torch.isfinite(lk).all())
    emit({"phase": "decode_step_check", "logits": list(lk.shape), "finite": finite,
          "cosine_kernel_vs_dense": cos, "bound": STEP_COSINE_BOUND})
    require(finite and lk.shape == (cfg.vocab_size,), "decode-step logits malformed")
    require(cos >= STEP_COSINE_BOUND, f"decode step: cosine {cos} < {STEP_COSINE_BOUND}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from qwen3_asr_gguf_tpu.models.configs import preset
    from qwen3_asr_gguf_tpu.schema import ASREngineConfig
    from qwen3_asr_gguf_tpu.text.tokenizer import _HAS_REGEX
    from qwen3_asr_gguf_tpu_torch import QwenASREngine
    from qwen3_asr_gguf_tpu_torch.ops import _build, q4k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tokenizer_regex": _HAS_REGEX})

    t0 = time.time()
    _build.build(force=True)
    _build.lib()
    emit({"phase": "build", "seconds": time.time() - t0, "nvcc": _build.find_nvcc(),
          "flags": _build.NVCC_FLAGS, "lib": str(_build.LIB_PATH.relative_to(REPO))})

    cfg = preset(PRESET)
    kernel_rows = kernel_phase(torch, dev, cfg.text)

    model_dir = ensure_checkpoint()
    t0 = time.time()
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(model_dir), llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4",
        n_ctx=2048, chunk_size=40.0, memory_num=1, verbose=False, max_new_tokens=96,
        decode_block=96, kv_prefix_reuse=True, kv_cache_dtype="bf16", enable_aligner=False,
    ), device=dev)
    emit({"phase": "engine_init", "seconds": time.time() - t0,
          "gpu_mem_gb": torch.cuda.memory_allocated(dev) / 1e9})

    audio = synthetic_clip(CLIP_SECONDS)
    t0 = time.time()
    engine.asr(audio, context="", language="Chinese", temperature=0.4)
    torch.cuda.synchronize()
    emit({"phase": "warmup", "seconds": time.time() - t0})

    launches = {}
    for temp in (0.4, 0.0):
        q4k.q4k_matvec.launches = 0
        q4k.q4k_matvec_normed.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        res = engine.asr(audio, context="", language="Chinese", temperature=temp)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {"q4k_matvec": q4k.q4k_matvec.launches,
                  "q4k_matvec_normed": q4k.q4k_matvec_normed.launches}
        perf = res.performance
        row = {"phase": "asr", "temperature": temp, "audio_s": CLIP_SECONDS, "wall_s": wall,
               "rtf": wall / CLIP_SECONDS, "prefill_tokens": perf["prefill_tokens"],
               "decode_tokens": perf["decode_tokens"], "prefill_s": perf["prefill_time"],
               "decode_s": perf["decode_time"], "encode_s": perf["encode_time"],
               "decode_tok_per_s": perf["decode_tokens"] / max(perf["decode_time"], 1e-9),
               "text_chars": len(res.text), "launches": counts,
               # two normed matvecs (qkv, gate_up) per layer per decode step;
               # unlike decode_tokens (the final attempt of each chunk) this
               # includes the steps of breaker retries
               "decode_steps": counts["q4k_matvec_normed"] // (2 * cfg.text.num_layers),
               "peak_gpu_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        emit(row)
        require(perf["decode_tokens"] > 0, "no decode tokens")
        require(isinstance(res.text, str) and len(res.text) > 0, "empty transcript")
        require(all(c > 0 for c in counts.values()), f"a kernel never launched: {counts}")
        require(math.isfinite(wall), "wall time not finite")
        if temp == 0.4:
            launches = counts

    decode_step_check(torch, engine)
    emb = engine.encoder.encode(torch.from_numpy(audio[: 40 * 16_000]).to(dev))
    n_tok = engine.encoder.valid_tokens(40 * 16_000)
    require(tuple(emb.shape) == (n_tok, cfg.audio.output_dim), f"encoder shape {tuple(emb.shape)}")
    require(bool(torch.isfinite(emb).all()), "encoder output not finite")
    emit({"phase": "encoder_check", "shape": list(emb.shape), "finite": True})

    replaces = {
        "q4k_matvec": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:324",
        "q4k_matvec_normed": "qwen3_asr_gguf_tpu/ops/pallas_q4k.py:594",
    }
    kernels = []
    for name in replaces:
        mine = [r for r in kernel_rows if r["name"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": "qwen3_asr_gguf_tpu_torch/csrc/q4k_matvec.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # one call at each of the kernel's main-path shapes, summed
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "shapes": {r["shape"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
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
