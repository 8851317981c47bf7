"""A random-weight checkpoint in the Hugging Face Qwen3-ASR layout, the input
of `export.convert.convert_hf_checkpoint`, written with numpy from a seed
(no public weights are at hand; the converter's tests and `chip_smoke.py`
need such a directory):

    <hf_dir>/config.json          {"thinker_config": {"audio_config", "text_config", ...}}
                                  (or the thinker config itself without a prefix)
    <hf_dir>/model.safetensors    [thinker.]audio_tower.*, [thinker.]model.*,
                                  [thinker.]lm_head.weight

Values are N(0, 0.02), norm scales 1 + N(0, 0.02), drawn in sorted tensor
name order; stored as BF16 (what published checkpoints hold) or F32.

    python -m qwen3_asr_gguf_tpu_torch.devtools.hf_checkpoint OUT_DIR [PRESET] [--f32]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from ..export.convert import _DEC_LAYER_HF, _ENC_LAYER_HF, _ENC_TOP_HF
from ..models import decoder as dec_model
from ..models import encoder as enc_model
from ..models import safetensors_np
from ..models.configs import preset

_AUDIO_KEYS = ("num_mel_bins", "d_model", "encoder_layers", "encoder_attention_heads",
               "encoder_ffn_dim", "downsample_hidden_size", "output_dim", "n_window_infer",
               "conv_chunksize", "max_source_positions")


def hf_config(thinker) -> dict:
    """The thinker config as HF writes it (n_window is half the conv chunk)."""
    a, t = thinker.audio, thinker.text
    return {
        "audio_config": {**{k: getattr(a, k) for k in _AUDIO_KEYS}, "n_window": a.n_window // 2},
        "text_config": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads, "head_dim": t.head_dim,
            "intermediate_size": t.intermediate_size, "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
        },
        "audio_token_id": thinker.audio_token_id,
        "audio_start_token_id": thinker.audio_start_token_id,
    }


def _hf_shapes(thinker) -> dict[str, tuple]:
    """HF tensor name (no prefix) -> shape."""
    enc = enc_model.init_shapes(thinker.audio)
    dec = dec_model.init_shapes(thinker.text)
    shapes = {f"audio_tower.{hf}": enc[mine] for mine, hf in _ENC_TOP_HF.items()}
    for mine, hf in _ENC_LAYER_HF.items():
        for i in range(thinker.audio.encoder_layers):
            shapes[f"audio_tower.layers.{i}.{hf}"] = enc["layers"][mine][1:]
    for mine, hf in _DEC_LAYER_HF.items():
        for i in range(thinker.text.num_layers):
            shapes[f"model.layers.{i}.{hf}"] = dec["layers"][mine][1:]
    shapes["model.embed_tokens.weight"] = dec["embed"]
    shapes["model.norm.weight"] = dec["final_norm"]
    shapes["lm_head.weight"] = dec["lm_head"]
    return shapes


def write_hf_checkpoint(hf_dir: str, preset_name: str, *, seed: int = 0, bf16: bool = True,
                        prefix: str = "thinker.") -> Path:
    """Write the directory; `prefix` "thinker." gives the full model's
    layout (config under "thinker_config"), "" the raw thinker's. A preset
    with `classify_num` (the forced aligner) gets a head of that many rows."""
    thinker = preset(preset_name)
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape in sorted(_hf_shapes(thinker).items()):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if ("norm" in name or "ln_post" in name) and name.endswith("weight"):
            w += np.float32(1.0)
        tensors[prefix + name] = safetensors_np.bf16_bits(w) if bf16 else w
    d = Path(hf_dir)
    d.mkdir(parents=True, exist_ok=True)
    cfg = hf_config(thinker)
    (d / "config.json").write_text(json.dumps({"thinker_config": cfg} if prefix else cfg))
    safetensors_np.save_file(tensors, str(d / "model.safetensors"),
                             bf16=set(tensors) if bf16 else set())
    return d


if __name__ == "__main__":
    out = sys.argv[1]
    names = [a for a in sys.argv[2:] if not a.startswith("--")]
    write_hf_checkpoint(out, names[0] if names else "tiny", bf16="--f32" not in sys.argv)
    print(out)
