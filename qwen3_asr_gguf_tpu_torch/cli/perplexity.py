"""Decoder perplexity tool on the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/cli/perplexity.py).

Token-level perplexity of a GGUF decoder over a text corpus, at one or two
precisions, with the relative delta (the q4_k fidelity bar: PPL within +9%
of the dense weights).

  python -m qwen3_asr_gguf_tpu_torch.cli.perplexity --llm model/qwen3_asr_llm.q4_k.gguf \\
      --text corpus.txt [--compare f32] [--window 512] [--device cuda|cpu]

Each window of `window + 1` tokens is one causal prefill in f32; its last
window is zero-padded and the padding keys are masked. A quantized product
of more than 64 rows (`ops.qmm.MAX_ROWS`) dequantizes its weight per call,
as the JAX package does on the TPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .device import cli_device


def compute_ppl(llm_path: str, token_ids: np.ndarray, *, precision: str, window: int,
                device="cuda") -> float:
    import torch

    from ..models import decoder as dec
    from ..models import params as P

    cfg, params, _ = P.load_decoder_gguf(llm_path, precision=precision, device=device)
    total_nll, total_n = 0.0, 0
    with torch.inference_mode():
        for start in range(0, len(token_ids) - 1, window):
            ids = token_ids[start: start + window + 1]
            if len(ids) < 2:
                break
            valid = len(ids) - 1
            if len(ids) < window + 1:
                ids = np.concatenate([ids, np.zeros(window + 1 - len(ids), ids.dtype)])
            t = torch.from_numpy(ids.astype(np.int64)).to(device)
            embd = dec.embed_tokens(params, t).float()
            hidden, _ = dec.forward_prefill(params, cfg, embd, None, length=valid + 1)
            logits = dec.lm_logits(params, hidden, cfg.lm_head_dim)
            logp = torch.log_softmax(logits[:-1].float(), dim=-1)
            nll = -logp.gather(-1, t[1:, None])[:, 0]
            total_nll += float(nll[:valid].sum())
            total_n += valid
    return float(np.exp(total_nll / max(total_n, 1)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.cli.perplexity")
    p.add_argument("--llm", required=True, help="decoder GGUF path")
    p.add_argument("--text", required=True, help="UTF-8 text corpus")
    p.add_argument("--precision", default="q4_k")
    p.add_argument("--compare", default=None, help="second precision (e.g. f32) for delta")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=16384)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    from ..formats import GGUFReader
    from ..text.tokenizer import BPETokenizer

    tok = BPETokenizer.from_gguf_kv(GGUFReader(args.llm).kv)
    with open(args.text, encoding="utf-8") as f:
        ids = np.asarray(tok.encode(f.read())[: args.max_tokens], dtype=np.int32)
    if len(ids) < 2:
        print("corpus too small", file=sys.stderr)
        return 2

    report = {"tokens": int(len(ids)), "window": args.window}
    report[f"ppl_{args.precision}"] = round(
        compute_ppl(args.llm, ids, precision=args.precision, window=args.window, device=device), 4
    )
    if args.compare:
        base = compute_ppl(args.llm, ids, precision=args.compare, window=args.window,
                           device=device)
        report[f"ppl_{args.compare}"] = round(base, 4)
        report["delta_pct"] = round(
            100.0 * (report[f"ppl_{args.precision}"] - base) / base, 2
        )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
