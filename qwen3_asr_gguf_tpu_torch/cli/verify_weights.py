"""One-command convert-and-verify of a Hugging Face Qwen3-ASR checkpoint on
the PyTorch port (counterpart of qwen3_asr_gguf_tpu/cli/verify_weights.py).

    python -m qwen3_asr_gguf_tpu_torch.cli.verify_weights \\
        --hf /path/to/Qwen3-ASR-1.7B --out model/ --audio test_audio.wav [--device cuda|cpu]

Stages (each prints PASS/FAIL/SKIP; nonzero exit on any FAIL):
  1. convert    - export.convert.convert_hf_checkpoint (f16 + the requested quant)
  2. load       - QwenASREngine on the converted dir (the f16 rung at f32
                  compute), which transcribes the verification clip greedily
  3. oracle     - that transcript against the reference torch modeling run
                  composed (mel -> audio tower -> masked_scatter -> greedy
                  thinker) on the same clip, with f16-rounded weights
  4. fidelity   - encoder quant cosine (>= 0.96, cli/quant_accuracy) and the
                  q4_k vs f32 perplexity delta (<= 9%) on the repo's README

The oracle stage is SKIP when the reference modeling is not in this checkout
under reference/qwen_asr/core/transformers_backend (the detail names the
missing path), when importing it raises ImportError, or
when the model does not fit in host memory (MemoryError); any other failure
of any stage is FAIL.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import types
from pathlib import Path

import numpy as np

from .device import cli_device

_REPO = Path(__file__).resolve().parents[2]
REPO_README = _REPO / "README.md"
# the reference's torch modeling, looked for only inside this checkout (the
# upstream Qwen3-ASR sources committed under reference/); never outside it
REF_TB = str(_REPO / "reference" / "qwen_asr" / "core" / "transformers_backend")


class _Report:
    def __init__(self) -> None:
        self.rows: list[tuple[str, str, str]] = []

    def add(self, stage: str, status: str, detail: str = "") -> None:
        self.rows.append((stage, status, detail))
        print(f"[{status:>4}] {stage}: {detail}", flush=True)

    @property
    def failed(self) -> bool:
        return any(s == "FAIL" for _, s, _ in self.rows)


def _load_ref_modeling():
    """Import the reference torch modeling without executing its package's
    __init__ (which imports packages the comparison does not need)."""
    if "ref_tb" not in sys.modules:
        pkg = types.ModuleType("ref_tb")
        pkg.__path__ = [REF_TB]
        sys.modules["ref_tb"] = pkg
    return importlib.import_module("ref_tb.modeling_qwen3_asr")


def _oracle_transcript(engine, hf_dir: str, audio: np.ndarray,
                       language: str, max_new: int) -> str:
    """Greedy transcript from the reference torch model on the CPU, composed
    as its engine composes it (full recompute per token; fine for a short
    clip)."""
    import torch

    from ..audio.mel import log_mel_np

    modeling = _load_ref_modeling()
    model = modeling.Qwen3ASRThinkerForConditionalGeneration.from_pretrained(
        hf_dir, torch_dtype=torch.float32, low_cpu_mem_usage=True,
    )
    model.eval()
    # score with f16-rounded weights: the engine decodes the f16 GGUF rung,
    # and near-margin greedy tokens must not flip on storage noise
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.float16).to(torch.float32))

    audio_token_id = int(getattr(model.config, "audio_token_id", 151675))
    mel = log_mel_np(audio, engine.encoder.frontend.filters)
    n_audio = engine.encoder.valid_tokens(len(audio))
    ids_np, mask = engine._build_prompt_ids(n_audio, "", "", language)
    ids_np = ids_np.astype(np.int64)
    ids_np[mask] = audio_token_id

    feats = torch.tensor(mel[None], dtype=torch.float32)
    fam = torch.ones(1, feats.shape[2], dtype=torch.long)
    eos = set(int(t) for t in engine.thinker.eos_token_ids)
    ids = ids_np.tolist()
    out_tokens: list[int] = []
    with torch.no_grad():
        for _ in range(max_new):
            t_ids = torch.tensor([ids], dtype=torch.long)
            out = model(input_ids=t_ids, input_features=feats,
                        feature_attention_mask=fam,
                        attention_mask=torch.ones_like(t_ids))
            tok = int(out.logits[0, -1].argmax())
            if tok in eos:
                break
            ids.append(tok)
            out_tokens.append(tok)
    return engine.model.decode(out_tokens)


def _ppl_delta(out_dir: str, device) -> tuple[bool, str]:
    """(within the bar, detail): q4_k (at int4) against f32 perplexity of
    the converted decoder on the first 512 tokens of the repo's README."""
    from ..formats import GGUFReader
    from ..text.tokenizer import BPETokenizer
    from .perplexity import compute_ppl

    llm = str(Path(out_dir) / "qwen3_asr_llm.q4_k.gguf")
    text = (REPO_README.read_text(encoding="utf-8") if REPO_README.exists()
            else "speech recognition converts audio to text. " * 200)
    tok = BPETokenizer.from_gguf_kv(GGUFReader(llm).kv)
    ids = np.asarray(tok.encode(text)[:512], dtype=np.int32)
    p_q = compute_ppl(llm, ids, precision="int4", window=256, device=device)
    p_f = compute_ppl(llm, ids, precision="f32", window=256, device=device)
    delta = 100.0 * (p_q - p_f) / p_f
    return delta <= 9.0, f"q4_k {p_q:.3f} vs f32 {p_f:.3f}: {delta:+.2f}% (bar +9%)"


def verify(hf_dir: str, out_dir: str, *, quant: str = "q4_k",
           audio_path: str | None = None, seconds: float = 4.0,
           language: str = "Chinese", max_new: int = 32,
           skip_oracle: bool = False, skip_fidelity: bool = False,
           device="cuda") -> _Report:
    rep = _Report()
    device = cli_device(str(device), "verify_weights")

    # 1. convert: the f16 rung (oracle parity) + the requested serving quant
    from ..export.convert import convert_hf_checkpoint

    t0 = time.time()
    try:
        convert_hf_checkpoint(hf_dir, out_dir, quant="f16")
        if quant not in ("f16", None):
            convert_hf_checkpoint(hf_dir, out_dir, quant=quant)
        rep.add("convert", "PASS", f"f16 + {quant} in {time.time()-t0:.1f}s -> {out_dir}")
    except Exception as e:
        rep.add("convert", "FAIL", repr(e))
        return rep

    if audio_path:
        from ..audio.io import load_audio

        audio = load_audio(audio_path)[: int(seconds * 16_000)]
    else:
        t = np.arange(int(16_000 * seconds)) / 16_000
        audio = (0.3 * np.sin(2 * np.pi * 220 * t)
                 * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))).astype(np.float32)

    # 2. engine load (f32 compute over the f16 rung) and its transcript
    from ..runtime.engine import QwenASREngine
    from ..schema import ASREngineConfig

    try:
        engine = QwenASREngine(ASREngineConfig(
            model_dir=out_dir, llm_fn="qwen3_asr_llm.f16.gguf",
            precision="f32", n_ctx=1024, verbose=False,
            max_new_tokens=max_new, enable_aligner=False,
        ), device=device)
        res = engine.asr(audio, context="", language=language, temperature=0.0)
        rep.add("load", "PASS", f"engine up on converted dir (f16 rung, f32 compute, {device}): "
                                f"{res.text!r}")
    except Exception as e:
        rep.add("load", "FAIL", repr(e))
        return rep

    # 3. composed torch-oracle transcript parity
    if skip_oracle:
        rep.add("oracle", "SKIP", "--skip-oracle")
    elif not Path(REF_TB).is_dir():
        rep.add("oracle", "SKIP", f"reference modeling not found: {REF_TB}")
    else:
        try:
            expected = _oracle_transcript(engine, hf_dir, audio, language, max_new)
            rep.add("oracle", "PASS" if res.text == expected else "FAIL",
                    f"engine={res.text!r} oracle={expected!r}")
        except ImportError as e:
            rep.add("oracle", "SKIP", f"reference modeling does not import ({e!r})")
        except MemoryError as e:
            rep.add("oracle", "SKIP", f"torch model exceeds host RAM ({e!r})")
        except Exception as e:
            rep.add("oracle", "FAIL", repr(e))
    engine.shutdown()
    del engine

    # 4. fidelity bars on the converted artifacts
    if skip_fidelity:
        rep.add("fidelity", "SKIP", "--skip-fidelity")
        return rep
    try:
        from .quant_accuracy import main as qa_main

        rc = qa_main(["--model-dir", out_dir, "--device", str(device)])
        rep.add("fidelity/quant-cosine", "PASS" if not rc else "FAIL",
                "encoder int4/int8 + decoder q4_k cosine vs f32 (bar >= 0.96)")
    except Exception as e:
        rep.add("fidelity/quant-cosine", "FAIL", repr(e))
    if quant == "q4_k":
        try:
            ok, detail = _ppl_delta(out_dir, device)
            rep.add("fidelity/ppl-delta", "PASS" if ok else "FAIL", detail)
        except Exception as e:
            rep.add("fidelity/ppl-delta", "FAIL", repr(e))
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hf", required=True, help="HF checkpoint directory")
    ap.add_argument("--out", required=True, help="converted model dir")
    ap.add_argument("--quant", default="q4_k")
    ap.add_argument("--audio", default=None,
                    help="verification clip (default: synthetic tone)")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--language", default="Chinese")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--skip-fidelity", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = ap.parse_args(argv)
    rep = verify(args.hf, args.out, quant=args.quant, audio_path=args.audio,
                 seconds=args.seconds, language=args.language,
                 max_new=args.max_new, skip_oracle=args.skip_oracle,
                 skip_fidelity=args.skip_fidelity, device=args.device)
    print("== " + ("FAIL" if rep.failed else "OK") + " ==", flush=True)
    return 1 if rep.failed else 0


if __name__ == "__main__":
    sys.exit(main())
