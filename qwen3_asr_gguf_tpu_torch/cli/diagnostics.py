"""Hardware diagnostics on the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/cli/diagnostics.py): the audio encoder's RTF (best of
three calls after a warm-up) and the device memory before loading, after
loading and at the peak.

  python -m qwen3_asr_gguf_tpu_torch.cli.diagnostics --model-dir model/ [--seconds 40] \\
      [--int4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..utils.profiling import device_memory_report
from .device import cli_device


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.cli.diagnostics")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--encoder-fn", default="qwen3_asr_encoder.safetensors")
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--int4", action="store_true", help="benchmark the int4 encoder")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    import torch

    from ..models import params as P
    from ..runtime.encoder_runner import EncoderRunner

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    report: dict = {"backend": device.type, "device": name}
    report["memory_baseline"] = device_memory_report(device)

    t0 = time.time()
    path = os.path.join(args.model_dir, args.encoder_fn)
    if args.int4:
        enc_cfg, enc_params = P.load_encoder_quantized(path, kind="int4", device=device)
    else:
        enc_cfg, enc_params = P.load_encoder_safetensors(path, device=device)
    runner = EncoderRunner(enc_params, enc_cfg, device=device)
    _sync(device)
    report["encoder_load_s"] = round(time.time() - t0, 2)
    report["memory_after_load"] = device_memory_report(device)

    audio = np.random.default_rng(0).standard_normal(
        int(16_000 * args.seconds)
    ).astype(np.float32) * 0.2
    times = []
    with torch.inference_mode():
        runner.encode(audio)  # warm-up
        for _ in range(3):
            _sync(device)
            t0 = time.time()
            runner.encode(audio)
            _sync(device)
            times.append(time.time() - t0)
    best = min(times)
    report["encoder_seconds_audio"] = args.seconds
    report["encoder_time_s"] = round(best, 4)
    report["encoder_rtf"] = round(best / args.seconds, 5)
    report["memory_peak"] = device_memory_report(device)

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
