"""Random-weight checkpoints at real architecture shapes, without JAX
(counterpart of `make_synthetic_checkpoint` in
qwen3_asr_gguf_tpu/export/convert.py). For the same preset, seed and quant
the files are byte-identical to the JAX package's:

    <model_dir>/
      qwen3_asr_encoder.safetensors   (f32; int4 applied at load)
      qwen3_asr_llm.<quant>.gguf      (decoder + vocab)
      config.json                     (thinker config + special ids)
      mel_filters.npy

The JAX package fills its init shape trees in the order `jax.tree_util`
flattens a dict, which is SORTED key order; the draws here walk the port's
shape trees in that same order, so both consume one numpy stream alike.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np

from ..audio.mel import mel_filterbank
from ..models import decoder as dec_model
from ..models import encoder as enc_model
from ..models import params as P
from ..models.configs import ThinkerConfig, preset
from ..models.mla_config import is_mla
from ..text.tokenizer import BPETokenizer, build_synthetic_tokenizer

ASR_ENCODER_FN = "qwen3_asr_encoder.safetensors"
ALIGNER_ENCODER_FN = "qwen3_aligner_encoder.safetensors"


def _thinker_ids_from_tokenizer(thinker: ThinkerConfig, tok: BPETokenizer) -> ThinkerConfig:
    def tid(s, default):
        try:
            return tok.token_to_id(s)
        except KeyError:
            return default

    im_end = tid("<|im_end|>", thinker.im_end_token_id)
    eot = tid("<|endoftext|>", im_end)
    return replace(
        thinker,
        im_start_token_id=tid("<|im_start|>", thinker.im_start_token_id),
        im_end_token_id=im_end,
        audio_start_token_id=tid("<|audio_start|>", thinker.audio_start_token_id),
        audio_end_token_id=tid("<|audio_end|>", thinker.audio_end_token_id),
        asr_text_token_id=tid("<asr_text>", thinker.asr_text_token_id),
        timestamp_token_id=tid("<timestamp>", thinker.timestamp_token_id),
        eos_token_ids=(im_end, eot),
    )


def np_init_like(shapes: dict, seed: int) -> dict:
    """Fill a shape tree with numpy weights in sorted-key order:
    *norm* / ln*_w -> 1.0, biases -> 0.0, everything else N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def fill(name: str, shape: tuple):
        if "norm" in name or name.endswith(("ln1_w", "ln2_w", "ln_post_w")):
            return np.ones(shape, np.float32)
        if name.endswith("_b") or "bias" in name:
            return np.zeros(shape, np.float32)
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def walk(tree: dict, prefix: str) -> dict:
        return {
            k: walk(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict) else fill(prefix + k, tree[k])
            for k in sorted(tree)
        }

    return walk(shapes, "")


def cjk_word_token_ids(tok) -> np.ndarray:
    """Vocab ids that decode to exactly one CJK character and round-trip
    through encode()."""
    from ..text.align_text import is_cjk_char

    ids = []
    for tid in range(tok.n_vocab):
        try:
            s = tok.token_to_bytes(tid).decode("utf-8")
        except (UnicodeDecodeError, KeyError):
            continue
        if len(s) == 1 and is_cjk_char(s) and tok.encode(s, allow_special=False) == [tid]:
            ids.append(tid)
    return np.asarray(ids, dtype=np.int64)


def _bias_lm_head_cjk(dec_params: dict, tok) -> None:
    """Shrink non-CJK lm_head rows so a random decoder samples a plausible
    Chinese transcript of single-character tokens (same shapes and cost)."""
    head = dec_params.get("lm_head")
    if head is None or head.ndim != 2:
        return
    word_ids = cjk_word_token_ids(tok)
    if len(word_ids) < 100:
        return
    scale = np.full(head.shape[0], 0.3, dtype=head.dtype)
    scale[word_ids] = 1.0
    head *= scale[:, None]


def make_synthetic_checkpoint(
    model_dir: str,
    preset_name: str = "tiny",
    *,
    seed: int = 0,
    quant: str = "q4_k",
    aligner: bool = False,
) -> ThinkerConfig:
    """Random-weight checkpoint of a preset's architecture."""
    thinker = preset(preset_name)
    if aligner and thinker.text.classify_num is None:
        thinker = replace(thinker, text=replace(thinker.text, classify_num=5000))

    tok = build_synthetic_tokenizer(thinker.text.vocab_size)
    thinker = _thinker_ids_from_tokenizer(thinker, tok)
    if is_mla(thinker.text):
        return _mla_moe_checkpoint(Path(model_dir), thinker, tok, seed)

    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    enc_params = np_init_like(enc_model.init_shapes(thinker.audio), seed)
    enc_params["pos_embed"] = enc_model.sinusoid_positions(
        thinker.audio.max_source_positions, thinker.audio.d_model)
    dec_params = np_init_like(dec_model.init_shapes(thinker.text), seed + 1)
    if not aligner:
        _bias_lm_head_cjk(dec_params, tok)

    enc_fn = ALIGNER_ENCODER_FN if aligner else ASR_ENCODER_FN
    llm_fn = f"qwen3_{'aligner' if aligner else 'asr'}_llm.{quant}.gguf"
    P.save_encoder_safetensors(str(d / enc_fn), thinker.audio, enc_params)
    P.save_decoder_gguf(str(d / llm_fn), thinker.text, dec_params, tok, quant=quant)
    P.save_thinker_config(str(d), thinker)
    np.save(d / "mel_filters.npy", mel_filterbank())
    return thinker


ROUTER_BIAS_STD = 0.05  # `e_score_correction_bias` ~ N(0, 0.05): it moves some choices


def _mla_moe_checkpoint(d: Path, thinker: ThinkerConfig, tok, seed: int) -> ThinkerConfig:
    """The latent-attention sparse-expert decoder's checkpoint: the encoder
    as for Qwen3, the decoder as a deepseek2 GGUF (`models.params.
    save_mla_moe_gguf`: q4_k where rows are whole superblocks, q4_0
    experts) drawn in sorted-key order, the router's correction bias drawn
    after the rest, the head biased to CJK rows."""
    d.mkdir(parents=True, exist_ok=True)
    enc_params = np_init_like(enc_model.init_shapes(thinker.audio), seed)
    enc_params["pos_embed"] = enc_model.sinusoid_positions(
        thinker.audio.max_source_positions, thinker.audio.d_model)
    dec_params = np_init_like(P.mla_moe_shapes(thinker.text), seed + 1)
    bias = dec_params["moe_layers"]["router_bias"]
    bias[:] = np.random.default_rng(seed + 2).standard_normal(bias.shape) * ROUTER_BIAS_STD
    _bias_lm_head_cjk(dec_params, tok)
    P.save_encoder_safetensors(str(d / ASR_ENCODER_FN), thinker.audio, enc_params)
    P.save_mla_moe_gguf(str(d / "qwen3_asr_llm.q4_k.gguf"), thinker.text, dec_params, tok)
    P.save_thinker_config(str(d), thinker)
    np.save(d / "mel_filters.npy", mel_filterbank())
    return thinker
