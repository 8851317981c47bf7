"""Quantization fidelity gate on the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/cli/quant_accuracy.py).

The int4 and int8 encoders' cosine and MAE against the f32 master on one
clip, and the q4_k decoder's hidden-state cosine and greedy agreement
against the dense f32 decoder of the same GGUF on 64 random token ids. Bars:
encoder int4 cosine >= 0.96 (the reference's published bar), decoder
hidden cosine >= 0.90; exit code 1 when one fails.

  python -m qwen3_asr_gguf_tpu_torch.cli.quant_accuracy --model-dir model/ [--audio a.wav] \\
      [--device cuda|cpu]

The quantized encoders are `models.params.load_encoder_quantized`, whose
weights are bit-equal to the JAX package's `quantize_encoder_params` of the
same f32 master. On the card the q4_k prefill's 64 rows take every
`Q4Weight` product through the fused dequant + matmul kernel
(`ops.qmm.q4_matmul`), as the JAX package does on the TPU; on the CPU both
packages dequantize and multiply. Logits are compared over the real
vocabulary (padded head rows sliced away).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .device import cli_device

ENCODER_BAR = 0.96
DECODER_BAR = 0.90
DECODER_IDS = 64


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.cli.quant_accuracy")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--audio", default=None, help="wav file (default: synthetic 10 s)")
    p.add_argument("--llm-fn", default=None)
    p.add_argument("--encoder-fn", default="qwen3_asr_encoder.safetensors")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    import torch

    from ..audio.io import load_audio
    from ..models import decoder as dec
    from ..models import params as P
    from ..runtime.encoder_runner import EncoderRunner
    from .transcribe import _resolve_llm_fn

    if args.audio:
        audio = load_audio(args.audio)
    else:
        t = np.arange(int(16000 * args.seconds)) / 16000
        audio = (np.sin(2 * np.pi * 300 * t) * np.sin(2 * np.pi * 1.3 * t) * 0.4).astype(np.float32)

    def encode(params, cfg) -> np.ndarray:
        runner = EncoderRunner(params, cfg, device=device)
        with torch.inference_mode():
            out = runner.encode(audio)[: runner.valid_tokens(len(audio))]
        return out.float().cpu().numpy()

    report: dict = {}

    # encoder: f32 vs int4 / int8 ---------------------------------------------
    enc_path = os.path.join(args.model_dir, args.encoder_fn)
    enc_cfg, enc_params = P.load_encoder_safetensors(enc_path, device=device)
    ref = encode(enc_params, enc_cfg)
    del enc_params
    for kind in ("int4", "int8"):
        q_cfg, q_params = P.load_encoder_quantized(enc_path, kind=kind, device=device)
        got = encode(q_params, q_cfg)
        report[f"encoder_{kind}_cosine"] = round(cosine(ref, got), 5)
        report[f"encoder_{kind}_mae"] = round(float(np.abs(ref - got).mean()), 6)
    report["encoder_pass"] = report["encoder_int4_cosine"] >= ENCODER_BAR

    # decoder: dense vs q4_k --------------------------------------------------
    llm_fn = args.llm_fn or _resolve_llm_fn(args.model_dir, "q4_k")
    llm = os.path.join(args.model_dir, llm_fn)
    cfg_q, params_q, _ = P.load_decoder_gguf(llm, precision="q4_k", device=device)
    cfg_d, params_d, _ = P.load_decoder_gguf(llm, precision="f32", device=device)

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg_q.vocab_size, size=DECODER_IDS)).to(device)
    with torch.inference_mode():
        embd = dec.embed_tokens(params_d, ids)  # f32 rows, fed to both decoders
        h_d, _ = dec.forward_prefill(params_d, cfg_d, embd, None)
        h_q, _ = dec.forward_prefill(params_q, cfg_q, embd.float(), None)
        logits_d = dec.lm_logits(params_d, h_d, cfg_d.lm_head_dim)
        logits_q = dec.lm_logits(params_q, h_q, cfg_q.lm_head_dim)
        agree = float((logits_d.argmax(-1) == logits_q.argmax(-1)).float().mean())
    report["decoder_hidden_cosine"] = round(
        cosine(h_d.float().cpu().numpy(), h_q.float().cpu().numpy()), 5)
    report["decoder_greedy_agreement"] = round(agree, 4)
    report["decoder_pass"] = report["decoder_hidden_cosine"] >= DECODER_BAR

    print(json.dumps(report, indent=2))
    return 0 if report["encoder_pass"] and report["decoder_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
