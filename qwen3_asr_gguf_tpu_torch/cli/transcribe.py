"""Transcription CLI on the PyTorch port (counterpart of
`qwen3_asr_gguf_tpu/cli/transcribe.py`).

    python -m qwen3_asr_gguf_tpu_torch.cli.transcribe a.wav [b.wav ...] --model-dir DIR \\
        [--prec int4|q4_k|int8|bf16|f16|f32] [--timestamp] [--device cuda|cpu]
    torchrun --nproc-per-node N -m qwen3_asr_gguf_tpu_torch.cli.transcribe a.wav \\
        --model-dir DIR --mesh model=N

The JAX package's flags: several input files, precision, forced language,
context prompt, time window, chunk and memory control, and with
`--timestamp` forced alignment written as `.srt` and `.json` beside the
`.txt`. `--dml` and `--vulkan` are accepted and do nothing. `--device`
names the torch device; there is no fallback to another one. `--mesh
model=N` (or `data=D,model=N`) runs the decoder tensor-parallel over the
ranks of a `torchrun` launch (NCCL, each rank on its card cuda:LOCAL_RANK;
gloo with `--device cpu`): every rank reads the inputs and transcribes, and
rank 0 alone writes the output files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from .device import cli_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-asr-torch",
        description="Qwen3-ASR transcription (PyTorch + CUDA)",
    )
    p.add_argument("files", nargs="+", help="audio files to transcribe")
    p.add_argument("--model-dir", default=os.environ.get("QWEN3_ASR_MODEL_DIR", "model"),
                   help="checkpoint directory")
    p.add_argument("--prec", default="int4", choices=["q4_k", "int4", "int8", "bf16", "f16", "f32"],
                   help="weight precision")
    p.add_argument("--language", default=None, help="force language (30 supported)")
    p.add_argument("--context", default=None, help="system-prompt context biasing")
    p.add_argument("--chunk-size", type=float, default=40.0, help="chunk seconds")
    p.add_argument("--memory-num", type=int, default=1, help="carried memory chunks")
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.4)
    p.add_argument("--rollback-num", type=int, default=5)
    p.add_argument("--timestamp", action="store_true",
                   help="enable forced alignment -> SRT/JSON export")
    p.add_argument("-ss", "--start-second", type=float, default=0.0)
    p.add_argument("-t", "--duration", type=float, default=0.0)
    p.add_argument("-y", "--overwrite", action="store_true",
                   help="overwrite existing outputs without asking")
    p.add_argument("--output-dir", default=None,
                   help="write outputs here instead of next to each input")
    p.add_argument("--dml", action="store_true", help=argparse.SUPPRESS)  # no-op
    p.add_argument("--vulkan", action="store_true", help=argparse.SUPPRESS)  # no-op
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="TP-shard the decoder over the torchrun ranks, e.g. 'model=2'")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p


def _resolve_llm_fn(model_dir: str, prec: str) -> str:
    """Precision -> decoder filename, with a warning and the first file that
    exists when the precision's own is missing."""
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


def parse_mesh(spec):
    """'data=2,model=4' -> {"data": 2, "model": 4} (None passes through)."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        name, _, num = part.partition("=")
        out[name.strip()] = int(num)
    return out


def _is_writer() -> bool:
    """Whether this process writes output files: rank 0 of a world, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    mesh_shape = parse_mesh(args.mesh)
    if mesh_shape:
        from ..parallel.launch import init_from_env

        init_from_env("gloo" if device.type == "cpu" else "nccl")

    model_dir = args.model_dir
    llm_fn = _resolve_llm_fn(model_dir, args.prec)
    missing = [
        f for f in (llm_fn, "qwen3_asr_encoder.safetensors") if not Path(model_dir, f).exists()
    ]
    if missing:
        print(
            f"error: missing model files in {model_dir}: {missing}\n"
            "Generate a random-weight one with:  python -c \"from "
            "qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint; "
            f"make_synthetic_checkpoint('{model_dir}', 'qwen3-asr-1.7b', quant='q4_k')\"\n"
            "(qwen3_asr_gguf_tpu_torch/export/synthetic.py; aligner=True adds the aligner)",
            file=sys.stderr,
        )
        return 2

    from ..runtime.engine import QwenASREngine
    from ..schema import AlignerConfig, ASREngineConfig
    from ..text import exporters

    precision = {"f16": "bf16"}.get(args.prec, args.prec)
    config = ASREngineConfig(
        model_dir=model_dir,
        llm_fn=llm_fn,
        precision=precision,
        n_ctx=args.n_ctx,
        chunk_size=args.chunk_size,
        memory_num=args.memory_num,
        verbose=not args.quiet and _is_writer(),
        enable_aligner=args.timestamp,
        mesh_shape=mesh_shape,
    )
    if args.timestamp:
        aligner_llm = llm_fn.replace("asr", "aligner")
        if not Path(model_dir, aligner_llm).exists():
            print(f"error: --timestamp requires {aligner_llm} in {model_dir}", file=sys.stderr)
            return 2
        config.align_config = AlignerConfig(
            model_dir=model_dir,
            llm_fn=aligner_llm,
            encoder_fn="qwen3_aligner_encoder.safetensors",
            precision=precision,
            n_ctx=args.n_ctx,
        )

    t0 = time.time()
    try:
        engine = QwenASREngine(config, device=device)
    except Exception as e:
        print(f"\nerror: engine init failed: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"--- engine ready in {time.time()-t0:.2f}s ---", file=sys.stderr)

    for f in args.files:
        path = Path(f)
        if not path.exists():
            print(f"skip (not found): {f}", file=sys.stderr)
            continue
        if args.output_dir:
            out_base = Path(args.output_dir) / path.stem
            out_base.parent.mkdir(parents=True, exist_ok=True)
        else:
            out_base = path.with_suffix("")
        out_txt = out_base.with_suffix(".txt")
        if out_txt.exists() and not args.overwrite:
            from ..parallel.collectives import broadcast_object

            # rank 0 asks; the other ranks follow its answer
            resp = input(f"{out_txt} exists; overwrite? [y/N] ") if _is_writer() else ""
            if broadcast_object(resp.strip().lower()) != "y":
                continue
        if not args.quiet:
            print(f"\n=== {f} ===")
        result = engine.transcribe(
            str(path),
            language=args.language,
            context=args.context,
            start_second=args.start_second,
            duration=args.duration,
            temperature=args.temperature,
            rollback_num=args.rollback_num,
        )
        if not _is_writer():
            continue
        exporters.export_to_txt(str(out_txt), result)
        print(f"wrote {out_txt}", file=sys.stderr)
        if args.timestamp and result.alignment:
            exporters.export_to_srt(str(out_base.with_suffix(".srt")), result)
            exporters.export_to_json(str(out_base.with_suffix(".json")), result)
            print(f"wrote {out_base.with_suffix('.srt')} {out_base.with_suffix('.json')}",
                  file=sys.stderr)

    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
