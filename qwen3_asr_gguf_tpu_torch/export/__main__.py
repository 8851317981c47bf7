"""Export CLI of the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/export/__main__.py): one-step checkpoint conversion.

  python -m qwen3_asr_gguf_tpu_torch.export --hf <hf_checkpoint_dir> --out model/
  python -m qwen3_asr_gguf_tpu_torch.export --synthetic --preset qwen3-asr-1.7b --out model/
  python -m qwen3_asr_gguf_tpu_torch.export --llm --hf <qwen3_text_dir> --out llm.q4_k.gguf

Host code only (numpy); the files are byte-identical to the JAX CLI's.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.export")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", help="HuggingFace checkpoint directory to convert")
    src.add_argument("--synthetic", action="store_true", help="generate random weights")
    p.add_argument("--out", required=True, help="output model directory")
    p.add_argument("--preset", default="qwen3-asr-1.7b", help="synthetic architecture preset")
    p.add_argument("--quant", default="q4_k", choices=["q4_k", "q8_0", "f16", "f32"])
    p.add_argument("--aligner", action="store_true", help="export as forced-aligner model")
    p.add_argument(
        "--llm", action="store_true",
        help="convert a plain Qwen3ForCausalLM text checkpoint to one decoder GGUF",
    )
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from .convert import convert_hf_checkpoint, convert_text_llm, make_synthetic_checkpoint

    if args.llm:
        if args.synthetic:
            p.error("--llm requires --hf (a real text checkpoint)")
        cfg = convert_text_llm(args.hf, args.out, quant=args.quant)
        print(
            f"wrote {args.out}: text {cfg.num_layers}L/{cfg.hidden_size}d "
            f"vocab {cfg.vocab_size}, quant={args.quant}"
        )
        return 0
    if args.synthetic:
        thinker = make_synthetic_checkpoint(
            args.out, args.preset, seed=args.seed, quant=args.quant, aligner=args.aligner
        )
    else:
        thinker = convert_hf_checkpoint(args.hf, args.out, quant=args.quant, aligner=args.aligner)
    print(
        f"wrote {args.out}: text {thinker.text.num_layers}L/{thinker.text.hidden_size}d, "
        f"audio {thinker.audio.encoder_layers}L/{thinker.audio.d_model}d, quant={args.quant}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
