"""OpenAI-compatible transcription server on the PyTorch port.

    python -m qwen3_asr_gguf_tpu_torch.cli.serve --model-dir DIR [--device cuda|cpu]
    torchrun --nproc-per-node N -m qwen3_asr_gguf_tpu_torch.cli.serve --model-dir DIR \\
        --mesh model=N

The HTTP surface is `cli/http.py` (`ASRServer`, `make_handler`,
`parse_multipart`, the port's copy of the JAX package's):

  POST /v1/audio/transcriptions   multipart: file, model, language, prompt,
                                  temperature, response_format
  GET  /v1/models | /health | /stats | /demo

with the port's engine and, by default (`--batch-mode continuous`,
`--max-batch 8`), the port's `ContinuousBatcher` behind it; `--batch-mode
micro` puts a `MicroBatcher` there instead (while `--batch-window` > 0);
outside continuous mode `--prec int4` runs at int8, as in the JAX package.
`--timestamp` loads the forced aligner (`qwen3_aligner_*` beside the
decoder): srt, vtt and verbose_json answers carry word times, aligned on the
continuous batcher's align pool. `--device` names the torch device; there is
no fallback to another one. `--mesh model=N` serves tensor-parallel over the
ranks of a `torchrun` launch (NCCL, one card per rank; gloo with `--device
cpu`): rank 0 listens and runs admission, and the other ranks follow the
continuous batcher's lockstep loop (`ContinuousBatcher.follow`); under a
mesh only `--batch-mode continuous` with `--max-batch` > 1 serves.
`--prewarm` is left out: PyTorch has no programs to load before traffic.
"""

from __future__ import annotations

import argparse
import sys
from http.server import ThreadingHTTPServer

from .device import cli_device
from .http import ASRServer, make_handler
from .transcribe import _resolve_llm_fn, parse_mesh

MODEL_NAME = "qwen3-asr-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qwen3-asr-torch-serve")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--prec", default="int4")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--chunk-size", type=float, default=40.0)
    p.add_argument("--timestamp", action="store_true",
                   help="enable the aligner (srt/vtt/verbose_json words)")
    p.add_argument("--llm-fn", default=None)
    p.add_argument("--batch-window", type=float, default=0.05,
                   help="micro-batch gather window seconds (0 disables batching)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--mesh", default=None,
                   help="TP-shard the decoder over the torchrun ranks, e.g. 'model=2'")
    p.add_argument("--batch-mode", choices=["continuous", "micro", "off"],
                   default="continuous",
                   help="continuous = per-request admission into free decode rows; "
                        "micro = window-coalesced batches; off = one request at a time "
                        "on the engine")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p


def build_from_args(args: argparse.Namespace, **engine_config):
    """(server, engine, batcher) for parsed arguments; `engine_config`
    overrides fields of the engine's `ASREngineConfig`."""
    from ..runtime.engine import QwenASREngine
    from ..schema import AlignerConfig, ASREngineConfig

    device = cli_device(args.device, "the server")
    mesh_shape = parse_mesh(args.mesh)
    if mesh_shape:
        if args.batch_mode != "continuous" or args.max_batch < 2:
            raise ValueError("--mesh serves through the continuous batcher: "
                             "--batch-mode continuous with --max-batch > 1")
        from ..parallel.launch import init_from_env

        init_from_env("gloo" if device.type == "cpu" else "nccl")
    llm_fn = args.llm_fn or _resolve_llm_fn(args.model_dir, args.prec)
    precision = {"f16": "bf16"}.get(args.prec, args.prec)
    if precision == "int4" and args.max_batch > 1 and args.batch_mode != "continuous":
        # as in the JAX package: a micro batch decodes on the prefill-side
        # weights (dense bf16 at int4); continuous batching has a rows kernel
        # for the int4 weights (q4k_matmul_rows) and keeps int4
        print("[info] micro-batched serving uses precision=int8 "
              "(use --batch-mode continuous to serve int4)", file=sys.stderr)
        precision = "int8"
    cfg = ASREngineConfig(
        model_dir=args.model_dir, llm_fn=llm_fn, precision=precision,
        n_ctx=args.n_ctx, chunk_size=args.chunk_size, verbose=False,
        enable_aligner=args.timestamp, mesh_shape=mesh_shape,
    )
    if args.timestamp:
        cfg.align_config = AlignerConfig(
            model_dir=args.model_dir, llm_fn=llm_fn.replace("asr", "aligner"),
            encoder_fn="qwen3_aligner_encoder.safetensors", precision=precision,
            n_ctx=args.n_ctx,
        )
    for name, value in engine_config.items():
        setattr(cfg, name, value)
    engine = QwenASREngine(cfg, device=device)
    batcher = None
    if args.max_batch > 1 and args.batch_mode == "continuous":
        from ..runtime.continuous import ContinuousBatcher

        batcher = ContinuousBatcher(engine, max_batch=args.max_batch)
    elif args.max_batch > 1 and args.batch_mode == "micro" and args.batch_window > 0:
        from ..runtime.microbatch import MicroBatcher

        batcher = MicroBatcher(engine, window_s=args.batch_window, max_batch=args.max_batch)
    return ASRServer(engine, model_name=MODEL_NAME, batcher=batcher), engine, batcher


def build(argv=None, **engine_config):
    """(server, engine, batcher) from command-line arguments."""
    return build_from_args(build_parser().parse_args(argv), **engine_config)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    server, _, batcher = build_from_args(args)
    if batcher is not None and batcher.lockstep and not batcher.leader:
        batcher.follow()  # returns when rank 0 closes its batcher
        return 0
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"listening on http://{args.host}:{args.port}  (POST /v1/audio/transcriptions)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if batcher is not None:
            batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
