"""Random-weight checkpoints at a configuration's published widths: the
benchmark's frozen copy of the port's synthetic writer (its q4_k path, with
the CJK-biased head), drawn on the device from the configuration's fixed
`weights_seed` in one call per stacked tensor and encoded there.

    <dir>/qwen3_asr_encoder.safetensors   BF16, the config in its metadata
    <dir>/qwen3_asr_llm.q4_k.gguf          q4_k matrices, q6_k embed and head
    <dir>/config.json, mel_filters.npy

Weights: norms 1, biases 0, everything else N(0, 0.02), the encoder's
positions the sinusoid table. The LM head's rows that are not single CJK
characters are scaled by 0.3, so a random decoder writes a plausible
Chinese transcript of one-character tokens (same shapes and cost).

`ensure` writes a directory once per checkout; a later run finds its
`ready.json` and reads the files as they are.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import torch

from . import gguf, quant
from .tokenizer import build_synthetic_tokenizer

WRITER_VERSION = 1
LAYER_GGUF = {
    "attn_norm": "attn_norm.weight", "q_proj": "attn_q.weight", "k_proj": "attn_k.weight",
    "v_proj": "attn_v.weight", "o_proj": "attn_output.weight", "q_norm": "attn_q_norm.weight",
    "k_norm": "attn_k_norm.weight", "mlp_norm": "ffn_norm.weight",
    "gate_proj": "ffn_gate.weight", "up_proj": "ffn_up.weight", "down_proj": "ffn_down.weight",
}
NORMS = ("attn_norm", "q_norm", "k_norm", "mlp_norm")
SPECIALS = {"im_start_token_id": "<|im_start|>", "im_end_token_id": "<|im_end|>",
            "audio_start_token_id": "<|audio_start|>", "audio_end_token_id": "<|audio_end|>",
            "asr_text_token_id": "<asr_text>", "timestamp_token_id": "<timestamp>"}
ENCODER_FN = "qwen3_asr_encoder.safetensors"


# -- shapes -------------------------------------------------------------------


def conv_feat_dim(audio: dict) -> int:
    f = audio["num_mel_bins"]
    for _ in range(3):
        f = (f + 1) // 2
    return f * audio["downsample_hidden_size"]


def encoder_shapes(a: dict) -> dict:
    c, d, n, f = a["downsample_hidden_size"], a["d_model"], a["encoder_layers"], a["encoder_ffn_dim"]
    return {
        "conv1_w": (c, 1, 3, 3), "conv1_b": (c,), "conv2_w": (c, c, 3, 3), "conv2_b": (c,),
        "conv3_w": (c, c, 3, 3), "conv3_b": (c,), "conv_out": (d, conv_feat_dim(a)),
        "layers.ln1_w": (n, d), "layers.ln1_b": (n, d),
        "layers.q_w": (n, d, d), "layers.q_b": (n, d), "layers.k_w": (n, d, d),
        "layers.k_b": (n, d), "layers.v_w": (n, d, d), "layers.v_b": (n, d),
        "layers.o_w": (n, d, d), "layers.o_b": (n, d), "layers.ln2_w": (n, d),
        "layers.ln2_b": (n, d), "layers.fc1_w": (n, f, d), "layers.fc1_b": (n, f),
        "layers.fc2_w": (n, d, f), "layers.fc2_b": (n, d),
        "ln_post_w": (d,), "ln_post_b": (d,), "proj1_w": (d, d), "proj1_b": (d,),
        "proj2_w": (a["output_dim"], d), "proj2_b": (a["output_dim"],),
    }


def decoder_shapes(t: dict) -> dict:
    d, n, m = t["hidden_size"], t["num_layers"], t["intermediate_size"]
    hq, hkv, hd = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    head = t.get("classify_num") or t["vocab_size"]
    return {
        "embed": (t["vocab_size"], d), "final_norm": (d,), "lm_head": (head, d),
        "attn_norm": (n, d), "q_proj": (n, hq * hd, d), "k_proj": (n, hkv * hd, d),
        "v_proj": (n, hkv * hd, d), "o_proj": (n, d, hq * hd), "q_norm": (n, hd),
        "k_norm": (n, hd), "mlp_norm": (n, d), "gate_proj": (n, m, d), "up_proj": (n, m, d),
        "down_proj": (n, d, m),
    }


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    inc = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    scaled = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def mel_filterbank(sr: int = 16_000, n_fft: int = 400, n_mels: int = 128,
                   f_max: float = 8_000.0) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank [n_freqs, n_mels]."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep, min_log_mel = np.log(6.4) / 27.0, 1000.0 / (200.0 / 3)

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        m * f_sp)

    all_freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    fb = np.maximum(0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


# -- drawing ------------------------------------------------------------------


def _fill(name: str, shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in leaf or leaf in ("ln1_w", "ln2_w", "ln_post_w"):
        return torch.ones(shape, device=device)
    if leaf.endswith("_b"):
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=gen, device=device) * 0.02


def cjk_token_ids(tok) -> list[int]:
    """Vocab ids that decode to exactly one CJK character and round-trip
    through encode()."""
    ids = []
    for tid in range(tok.n_vocab):
        try:
            s = tok.token_to_bytes(tid).decode("utf-8")
        except (UnicodeDecodeError, KeyError):
            continue
        if len(s) == 1 and _is_cjk(s) and tok.encode(s, allow_special=False) == [tid]:
            ids.append(tid)
    return ids


def _is_cjk(ch: str) -> bool:
    c = ord(ch)
    return (0x4E00 <= c <= 0x9FFF or 0x3400 <= c <= 0x4DBF or 0x20000 <= c <= 0x2A6DF
            or 0x2A700 <= c <= 0x2B73F or 0x2B740 <= c <= 0x2B81F or 0x2B820 <= c <= 0x2CEAF
            or 0xF900 <= c <= 0xFAFF)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().cpu().numpy()


def _encode(w: torch.Tensor, kind: int) -> tuple[int, np.ndarray]:
    """(ggml type, bytes) of a 2-D weight: `kind` where its rows are whole
    256-blocks, f16 otherwise."""
    if w.shape[-1] % quant.QK:
        return gguf.F16, _host(w.to(torch.float16)).view(np.uint8)
    enc = quant.encode_q4_k if kind == gguf.Q4_K else quant.encode_q6_k
    return kind, _host(enc(w))


def write_decoder(path: Path, t: dict, tok, gen, device, cjk_ids) -> None:
    arch = "qwen3vl"
    w = gguf.Writer(arch)
    for key, val in (("block_count", t["num_layers"]), ("embedding_length", t["hidden_size"]),
                     ("attention.head_count", t["num_heads"]),
                     ("attention.head_count_kv", t["num_kv_heads"]),
                     ("attention.key_length", t["head_dim"]),
                     ("attention.value_length", t["head_dim"]),
                     ("feed_forward_length", t["intermediate_size"])):
        w.add(f"{arch}.{key}", gguf.T_U32, int(val))
    w.add(f"{arch}.attention.layer_norm_rms_epsilon", gguf.T_F32, float(t["rms_norm_eps"]))
    w.add(f"{arch}.rope.freq_base", gguf.T_F32, float(t["rope_theta"]))
    w.add("tokenizer.ggml.model", gguf.T_STR, "gpt2")
    w.add("tokenizer.ggml.pre", gguf.T_STR, "qwen2")
    w.add("tokenizer.ggml.tokens", gguf.T_ARR, (gguf.T_STR, tok.tokens))
    merges = [f"{a} {b}" for (a, b), _ in sorted(tok.merge_ranks.items(), key=lambda kv: kv[1])]
    w.add("tokenizer.ggml.merges", gguf.T_ARR, (gguf.T_STR, merges))
    w.add("tokenizer.ggml.token_type", gguf.T_ARR,
          (gguf.T_I32, [3 if s in tok.special_tokens else 1 for s in tok.tokens]))
    w.add("tokenizer.ggml.eos_token_id", gguf.T_U32, tok.eos_token_id)

    shapes = decoder_shapes(t)
    for name in sorted(shapes):  # one draw per stacked tensor, in sorted-key order
        x = _fill(name, shapes[name], gen, device)
        if name == "lm_head" and cjk_ids is not None and len(cjk_ids) >= 100:
            scale = torch.full((x.shape[0],), 0.3, device=device)
            scale[torch.as_tensor(cjk_ids, device=device)] = 1.0
            x *= scale[:, None]
        if name in ("embed", "lm_head"):
            typ, data = _encode(x, gguf.Q6_K)
            w.add_tensor("token_embd.weight" if name == "embed" else "output.weight",
                         tuple(x.shape), typ, data)
        elif name == "final_norm":
            w.add_tensor("output_norm.weight", tuple(x.shape), gguf.F32, _host(x))
        else:
            for i in range(x.shape[0]):
                gname = f"blk.{i}.{LAYER_GGUF[name]}"
                if name in NORMS:
                    w.add_tensor(gname, tuple(x.shape[1:]), gguf.F32, _host(x[i]))
                else:
                    typ, data = _encode(x[i], gguf.Q4_K)
                    w.add_tensor(gname, tuple(x.shape[1:]), typ, data)
        del x
    w.write(str(path))


def write_encoder(path: Path, a: dict, gen, device) -> None:
    """BF16 safetensors (the port's reader widens them to f32 exactly)."""
    shapes = encoder_shapes(a)
    tensors = {}
    for name in sorted(shapes):
        x = _fill(name, shapes[name], gen, device)
        tensors[name] = _host(x.to(torch.bfloat16).view(torch.int16)).view(np.uint16)
        del x
    pos = torch.from_numpy(sinusoid_positions(a["max_source_positions"], a["d_model"]))
    tensors["pos_embed"] = _host(pos.to(torch.bfloat16).view(torch.int16)).view(np.uint16)
    order = sorted(tensors)
    header, offset = {"__metadata__": {"config": json.dumps(a)}}, 0
    for name in order:
        n = tensors[name].nbytes
        header[name] = {"dtype": "BF16", "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-len(blob)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for name in order:
            f.write(tensors[name].tobytes())


def thinker_json(model: dict, tok) -> dict:
    ids = {k: tok.token_to_id(v) for k, v in SPECIALS.items()}
    eot = tok.token_to_id("<|endoftext|>")
    return {"audio_config": model["audio"], "text_config": model["text"],
            "audio_token_id": tok.token_to_id("<|audio_pad|>"), **ids,
            "eos_token_ids": [ids["im_end_token_id"], eot], "timestamp_segment_ms": 80.0}


def write_model(d: Path, model: dict, seed: int, device) -> None:
    """One model directory: encoder, decoder, config.json, mel filters."""
    d.mkdir(parents=True, exist_ok=True)
    tok = build_synthetic_tokenizer(model["text"]["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    write_encoder(d / ENCODER_FN, model["audio"], gen, device)
    write_decoder(d / "qwen3_asr_llm.q4_k.gguf", model["text"], tok, gen, device,
                  cjk_token_ids(tok))
    (d / "config.json").write_text(json.dumps(thinker_json(model, tok), indent=1))
    np.save(d / "mel_filters.npy", mel_filterbank())


def fingerprint(cfg: dict, keys: tuple = ("model", "weights_seed")) -> str:
    body = {k: cfg.get(k) for k in keys}
    body["writer"] = WRITER_VERSION
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


def ensure(cfg: dict, cache_root: Path, device, write=None,
           keys: tuple = ("model", "weights_seed")) -> tuple[Path, bool]:
    """(directory, written now) of `cfg`'s checkpoint under `cache_root`:
    `write(directory)` fills it (by default `write_model` with the
    configuration's model and weights seed), once for each value of the
    configuration's `keys`."""
    d = cache_root / cfg["name"]
    ready = d / "ready.json"
    fp = fingerprint(cfg, keys)
    if ready.exists() and json.loads(ready.read_text()).get("fingerprint") == fp:
        return d, False
    if d.exists():
        shutil.rmtree(d)
    tmp = cache_root / f"{cfg['name']}.partial"
    if tmp.exists():
        shutil.rmtree(tmp)
    if write is None:
        write_model(tmp, cfg["model"], int(cfg["weights_seed"]), device)
    else:
        write(tmp)
    (tmp / "ready.json").write_text(json.dumps({"fingerprint": fp}))
    os.replace(tmp, d)
    return d, True
