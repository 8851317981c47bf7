"""OpenAI-compatible transcription server on the PyTorch port.

    python -m qwen3_asr_gguf_tpu_torch.cli.serve --model-dir DIR [--device cuda|cpu]

The HTTP surface is `cli/http.py` (`ASRServer`, `make_handler`,
`parse_multipart`, the port's copy of the JAX package's):

  POST /v1/audio/transcriptions   multipart: file, model, language, prompt,
                                  temperature, response_format
  GET  /v1/models | /health | /stats | /demo

with the port's engine and, by default (`--batch-mode continuous`,
`--max-batch 8`), the port's `ContinuousBatcher` behind it. `--device` names
the torch device; there is no fallback to another one. Not ported yet (each
raises NotImplementedError, see ROADMAP.md): `--mesh`, `--batch-mode micro`
and `--timestamp`. `--prewarm` is left out: PyTorch has no programs to load
before traffic.
"""

from __future__ import annotations

import argparse
import sys
from http.server import ThreadingHTTPServer
from pathlib import Path

from .http import ASRServer, make_handler

MODEL_NAME = "qwen3-asr-torch"


def _resolve_llm_fn(model_dir: str, prec: str) -> str:
    """Precision -> decoder filename (reference transcribe.py:29-35)."""
    candidates = {
        "q4_k": "qwen3_asr_llm.q4_k.gguf",
        "int4": "qwen3_asr_llm.q4_k.gguf",
        "int8": "qwen3_asr_llm.q4_k.gguf",
        "bf16": "qwen3_asr_llm.f16.gguf",
        "f16": "qwen3_asr_llm.f16.gguf",
        "f32": "qwen3_asr_llm.f32.gguf",
    }
    fn = candidates[prec]
    if not Path(model_dir, fn).exists():
        for alt in dict.fromkeys(candidates.values()):
            if Path(model_dir, alt).exists():
                print(f"[warn] {fn} not found; using {alt}", file=sys.stderr)
                return alt
    return fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qwen3-asr-torch-serve")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--prec", default="int4")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--chunk-size", type=float, default=40.0)
    p.add_argument("--timestamp", action="store_true",
                   help="enable the aligner (the server's align pool is not ported yet)")
    p.add_argument("--llm-fn", default=None)
    p.add_argument("--batch-window", type=float, default=0.05,
                   help="micro-batch gather window seconds (micro mode, not ported yet)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--mesh", default=None,
                   help="TP-shard the decoder over a device mesh (not ported yet)")
    p.add_argument("--batch-mode", choices=["continuous", "micro", "off"],
                   default="continuous",
                   help="continuous = per-request admission into free decode rows; "
                        "off = one request at a time on the engine")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p


def build_from_args(args: argparse.Namespace, **engine_config):
    """(server, engine, batcher) for parsed arguments; `engine_config`
    overrides fields of the engine's `ASREngineConfig`."""
    import torch

    from ..runtime.engine import QwenASREngine
    from ..schema import ASREngineConfig

    if args.mesh:
        raise NotImplementedError("--mesh: tensor-parallel serving is not ported yet "
                                  "(ROADMAP.md Queue 1, item 7)")
    if args.timestamp:
        raise NotImplementedError("--timestamp: the server's align pool is not ported yet "
                                  "(ROADMAP.md Queue 1, item 4); the engine itself aligns "
                                  "with ASREngineConfig(enable_aligner=True)")
    if args.batch_mode == "micro":
        raise NotImplementedError("--batch-mode micro: MicroBatcher is not ported yet "
                                  "(ROADMAP.md Queue 1, item 4)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the server runs on --device "
                           f"{args.device} or not at all (pass --device cpu to choose the CPU)")
    cfg = ASREngineConfig(
        model_dir=args.model_dir,
        llm_fn=args.llm_fn or _resolve_llm_fn(args.model_dir, args.prec),
        precision={"f16": "bf16"}.get(args.prec, args.prec),
        n_ctx=args.n_ctx, chunk_size=args.chunk_size, verbose=False,
    )
    for name, value in engine_config.items():
        setattr(cfg, name, value)
    engine = QwenASREngine(cfg, device=device)
    batcher = None
    if args.max_batch > 1 and args.batch_mode == "continuous":
        from ..runtime.continuous import ContinuousBatcher

        batcher = ContinuousBatcher(engine, max_batch=args.max_batch)
    return ASRServer(engine, model_name=MODEL_NAME, batcher=batcher), engine, batcher


def build(argv=None, **engine_config):
    """(server, engine, batcher) from command-line arguments."""
    return build_from_args(build_parser().parse_args(argv), **engine_config)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    server, _, batcher = build_from_args(args)
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
