"""Minimal engine usage on the PyTorch port (twin of examples/run_asr.py).

    python -m qwen3_asr_gguf_tpu_torch.examples.run_asr model/ audio.wav [Chinese] [--device cpu]
"""

import argparse

from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
from qwen3_asr_gguf_tpu_torch.cli.device import cli_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.examples.run_asr")
    p.add_argument("model_dir")
    p.add_argument("audio")
    p.add_argument("language", nargs="?", default=None)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cpu")
    args = p.parse_args(argv)

    engine = QwenASREngine(ASREngineConfig(model_dir=args.model_dir),
                           device=cli_device(args.device, "the example"))
    result = engine.transcribe(
        args.audio,
        language=args.language,
        context="",           # optional domain-biasing system prompt
        start_second=0.0,
        duration=0.0,          # 0 = whole file
        temperature=0.4,
        rollback_num=5,
    )
    print("\n--- transcript ---")
    print(result.text)
    print("--- performance ---")
    for k, v in (result.performance or {}).items():
        print(f"  {k}: {v}")
    engine.shutdown()


if __name__ == "__main__":
    main()
