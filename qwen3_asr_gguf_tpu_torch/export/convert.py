"""Hugging Face checkpoint conversion, without JAX (counterpart of
qwen3_asr_gguf_tpu/export/convert.py).

`convert_hf_checkpoint` turns an HF Qwen3-ASR checkpoint directory (or the
forced aligner's) into the model directory the engine reads; for the same
directory and quant its files are byte-identical to the JAX package's:

    <model_dir>/
      qwen3_asr_encoder.safetensors      (f32 master; int4 applied at load)
      qwen3_asr_llm.<quant>.gguf         (decoder + vocab)
      config.json                        (thinker config + special ids)
      mel_filters.npy

`convert_text_llm` turns a plain `Qwen3ForCausalLM` checkpoint into one
decoder GGUF. Unlike the JAX package's, it reads the shape-defining keys of
`config.json` strictly: a missing one raises KeyError instead of taking a
1.7B default. The safetensors files are read with the port's own codec
(`models/safetensors_np.py`, BF16 included). Random-weight checkpoints:
`export/synthetic.py` (`make_synthetic_checkpoint`, imported here too).
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..audio.mel import mel_filterbank
from ..models import encoder as enc_model
from ..models import params as P
from ..models import safetensors_np
from ..models.configs import AudioEncoderConfig, TextDecoderConfig, ThinkerConfig
from ..text.tokenizer import BPETokenizer, build_synthetic_tokenizer
from .synthetic import (  # noqa: F401  (make_synthetic_checkpoint: the CLI's import path)
    ALIGNER_ENCODER_FN,
    ASR_ENCODER_FN,
    _thinker_ids_from_tokenizer,
    make_synthetic_checkpoint,
)

_DEC_LAYER_HF = {
    "attn_norm": "input_layernorm.weight",
    "q_proj": "self_attn.q_proj.weight",
    "k_proj": "self_attn.k_proj.weight",
    "v_proj": "self_attn.v_proj.weight",
    "o_proj": "self_attn.o_proj.weight",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
    "gate_proj": "mlp.gate_proj.weight",
    "up_proj": "mlp.up_proj.weight",
    "down_proj": "mlp.down_proj.weight",
}

_ENC_TOP_HF = {
    "conv1_w": "conv2d1.weight", "conv1_b": "conv2d1.bias",
    "conv2_w": "conv2d2.weight", "conv2_b": "conv2d2.bias",
    "conv3_w": "conv2d3.weight", "conv3_b": "conv2d3.bias",
    "conv_out": "conv_out.weight",
    "ln_post_w": "ln_post.weight", "ln_post_b": "ln_post.bias",
    "proj1_w": "proj1.weight", "proj1_b": "proj1.bias",
    "proj2_w": "proj2.weight", "proj2_b": "proj2.bias",
}

_ENC_LAYER_HF = {
    "ln1_w": "self_attn_layer_norm.weight", "ln1_b": "self_attn_layer_norm.bias",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.out_proj.weight", "o_b": "self_attn.out_proj.bias",
    "ln2_w": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
    "fc1_w": "fc1.weight", "fc1_b": "fc1.bias",
    "fc2_w": "fc2.weight", "fc2_b": "fc2.bias",
}

# config.json keys that fix a text decoder's shapes: no default stands in
_TEXT_KEYS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
    "num_kv_heads": "num_key_value_heads", "intermediate_size": "intermediate_size",
    "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta",
}


def _tokenizer(hf_dir: str, vocab_size: int) -> BPETokenizer:
    tok_json = Path(hf_dir) / "tokenizer.json"
    if tok_json.exists():
        return BPETokenizer.from_hf_tokenizer_json(str(tok_json))
    return build_synthetic_tokenizer(vocab_size)


def convert_text_llm(hf_dir: str, out_path: str, *, quant: str = "q4_k") -> TextDecoderConfig:
    """Plain Qwen3-family text-LLM HF checkpoint dir -> one decoder GGUF
    (`out_path`, or `qwen3_llm.<quant>.gguf` inside it when it does not end
    in .gguf). Tied checkpoints, which ship no lm_head tensor, take the
    embedding as the head. Any other architecture is refused: its forward
    pass would not be the decoder's. Raises KeyError naming a missing
    shape key of config.json; only `head_dim`, which HF itself may omit,
    defaults (to 128, as `transformers.Qwen3Config` does)."""
    with open(Path(hf_dir) / "config.json", encoding="utf-8") as f:
        hf_cfg = json.load(f)
    archs = hf_cfg.get("architectures", [])
    if "Qwen3ForCausalLM" not in archs:
        raise ValueError(
            f"unsupported text-LLM architecture {archs}: this converter "
            "emits checkpoints for the Qwen3 decoder this framework "
            "executes (q/k-norm attention, bias-free projections); "
            "Qwen2-style models (qkv biases, no q/k norm) would load but "
            "compute the wrong function"
        )
    missing = [k for k in _TEXT_KEYS.values() if k not in hf_cfg]
    if missing:
        raise KeyError(f"config.json lacks {', '.join(missing)}: "
                       "a text checkpoint's shapes are not guessed")
    text_cfg = TextDecoderConfig(
        **{mine: hf_cfg[key] for mine, key in _TEXT_KEYS.items()},
        head_dim=hf_cfg.get("head_dim", 128),
    )
    state = _load_hf_state_dict(hf_dir)

    def g(name):
        return state[name].astype(np.float32)

    embed = g("model.embed_tokens.weight")
    # small Qwen3 checkpoints tie the head; HF then omits lm_head.weight
    lm_head = g("lm_head.weight") if "lm_head.weight" in state else embed
    dec_params = {
        "embed": embed,
        "layers": {
            mine: np.stack(
                [g(f"model.layers.{i}.{suffix}") for i in range(text_cfg.num_layers)]
            )
            for mine, suffix in _DEC_LAYER_HF.items()
        },
        "final_norm": g("model.norm.weight"),
        "lm_head": lm_head,
    }
    tok = _tokenizer(hf_dir, text_cfg.vocab_size)

    out = Path(out_path)
    if out.suffix != ".gguf":  # treat as a directory
        out.mkdir(parents=True, exist_ok=True)
        out = out / f"qwen3_llm.{quant}.gguf"
    out.parent.mkdir(parents=True, exist_ok=True)
    P.save_decoder_gguf(str(out), text_cfg, dec_params, tok, quant=quant, arch="qwen3")
    return text_cfg


def _load_hf_state_dict(hf_dir: str) -> dict[str, np.ndarray]:
    files = sorted(Path(hf_dir).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {hf_dir}")
    state: dict[str, np.ndarray] = {}
    for f in files:
        state.update(safetensors_np.load_file(str(f))[0])
    return state


def convert_hf_checkpoint(
    hf_dir: str,
    model_dir: str,
    *,
    quant: str = "q4_k",
    aligner: bool = False,
) -> ThinkerConfig:
    """HF Qwen3-ASR checkpoint dir -> engine model dir.

    Takes both the raw-thinker layout and the full model's (`thinker.`
    prefix) and splits the audio tower from the text model, as the JAX
    package does."""
    state = _load_hf_state_dict(hf_dir)
    prefix = "thinker." if any(k.startswith("thinker.") for k in state) else ""

    with open(Path(hf_dir) / "config.json", encoding="utf-8") as f:
        hf_cfg = json.load(f)
    tcfg_raw = hf_cfg.get("thinker_config", hf_cfg)
    audio_raw = tcfg_raw.get("audio_config", {})
    text_raw = tcfg_raw.get("text_config", {})

    audio_cfg = AudioEncoderConfig(
        num_mel_bins=audio_raw.get("num_mel_bins", 128),
        d_model=audio_raw.get("d_model", 1024),
        encoder_layers=audio_raw.get("encoder_layers", 24),
        encoder_attention_heads=audio_raw.get("encoder_attention_heads", 16),
        encoder_ffn_dim=audio_raw.get("encoder_ffn_dim", 4096),
        downsample_hidden_size=audio_raw.get("downsample_hidden_size", 480),
        output_dim=audio_raw.get("output_dim", 2048),
        # HF's n_window=50 means 2*n_window-frame conv chunks; the encoder's
        # n_window IS the chunk length, so the import doubles it, and only
        # 100-frame chunks match the architecture's token-length formula
        n_window=2 * audio_raw.get("n_window", 50),
        n_window_infer=audio_raw.get("n_window_infer", 400),
        conv_chunksize=audio_raw.get("conv_chunksize", 500),
        max_source_positions=audio_raw.get("max_source_positions", 1500),
    )
    if audio_cfg.n_window != 100:
        raise ValueError(
            f"unsupported audio n_window={audio_raw.get('n_window')} in HF "
            "config: the Qwen3-ASR conv frontend and its hard-coded "
            "100-frame token-length formula (modeling get_feat_extract_"
            "output_lengths) require n_window=50 (100-frame conv chunks); "
            "refusing to convert a checkpoint this architecture mishandles"
        )
    text_cfg = TextDecoderConfig(
        vocab_size=text_raw.get("vocab_size", 151936),
        hidden_size=text_raw.get("hidden_size", 2048),
        num_layers=text_raw.get("num_hidden_layers", 28),
        num_heads=text_raw.get("num_attention_heads", 16),
        num_kv_heads=text_raw.get("num_key_value_heads", 8),
        head_dim=text_raw.get("head_dim", 128),
        intermediate_size=text_raw.get("intermediate_size", 6144),
        rms_norm_eps=text_raw.get("rms_norm_eps", 1e-6),
        rope_theta=text_raw.get("rope_theta", 5e6),
    )

    def g(name):
        return state[prefix + name].astype(np.float32)

    lm_head = g("lm_head.weight")
    if lm_head.shape[0] != text_cfg.vocab_size and lm_head.shape[0] < 20_000:
        text_cfg = replace(text_cfg, classify_num=int(lm_head.shape[0]))  # the aligner's head
    dec_params = {
        "embed": g("model.embed_tokens.weight"),
        "layers": {
            mine: np.stack([g(f"model.layers.{i}.{suffix}") for i in range(text_cfg.num_layers)])
            for mine, suffix in _DEC_LAYER_HF.items()
        },
        "final_norm": g("model.norm.weight"),
        "lm_head": lm_head,
    }

    ap = prefix + "audio_tower."
    enc_params = {mine: state[ap + suffix].astype(np.float32)
                  for mine, suffix in _ENC_TOP_HF.items()}
    enc_params["pos_embed"] = enc_model.sinusoid_positions(
        audio_cfg.max_source_positions, audio_cfg.d_model)
    enc_params["layers"] = {
        mine: np.stack([state[f"{ap}layers.{i}.{suffix}"].astype(np.float32)
                        for i in range(audio_cfg.encoder_layers)])
        for mine, suffix in _ENC_LAYER_HF.items()
    }

    tok = _tokenizer(hf_dir, text_cfg.vocab_size)
    thinker = ThinkerConfig(
        audio=audio_cfg,
        text=text_cfg,
        audio_token_id=tcfg_raw.get("audio_token_id", 151646),
        audio_start_token_id=tcfg_raw.get("audio_start_token_id", 151647),
    )
    thinker = _thinker_ids_from_tokenizer(thinker, tok)

    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    enc_fn = ALIGNER_ENCODER_FN if aligner else ASR_ENCODER_FN
    llm_fn = f"qwen3_{'aligner' if aligner else 'asr'}_llm.{quant}.gguf"
    P.save_encoder_safetensors(str(d / enc_fn), audio_cfg, enc_params)
    P.save_decoder_gguf(str(d / llm_fn), text_cfg, dec_params, tok, quant=quant)
    P.save_thinker_config(str(d), thinker)
    np.save(d / "mel_filters.npy", mel_filterbank())
    return thinker
