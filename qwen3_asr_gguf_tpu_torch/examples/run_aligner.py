"""Minimal forced-aligner usage on the PyTorch port (twin of
examples/run_aligner.py).

    python -m qwen3_asr_gguf_tpu_torch.examples.run_aligner \
        model/ audio.wav "已知的转写文本" [Chinese] [--device cpu]
"""

import argparse

from qwen3_asr_gguf_tpu_torch.audio.io import load_audio
from qwen3_asr_gguf_tpu_torch.cli.device import cli_device
from qwen3_asr_gguf_tpu_torch.runtime.aligner import QwenForcedAligner
from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.examples.run_aligner")
    p.add_argument("model_dir")
    p.add_argument("audio")
    p.add_argument("text")
    p.add_argument("language", nargs="?", default="Chinese")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cpu")
    args = p.parse_args(argv)

    aligner = QwenForcedAligner(AlignerConfig(model_dir=args.model_dir),
                                device=cli_device(args.device, "the example"))
    audio = load_audio(args.audio)
    result = aligner.align(audio, args.text, language=args.language)

    for item in result.items:
        print(f"[{item.start_time:7.3f} - {item.end_time:7.3f}] {item.text}")
    print("--- performance ---", result.performance)


if __name__ == "__main__":
    main()
