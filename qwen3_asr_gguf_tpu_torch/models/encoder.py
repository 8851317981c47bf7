"""Qwen3-ASR audio encoder in PyTorch (counterpart of
`qwen3_asr_gguf_tpu/models/encoder.py`).

frontend : mel [128, T] -> 100-frame chunks -> 3x (conv2d k3 s2 p1 + exact
           GELU) -> flatten -> conv_out linear -> + cyclic sinusoid
           positions [0..12] -> [T_out, d_model]
backend  : pre-LN transformer (LayerNorm, biased QKV/out, GELU FFN) ->
           ln_post -> proj1 -> GELU -> proj2 -> [T_out, output_dim]

Conv weights are OIHW; matmul weights [out, in] (dense or `Q4Weight`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.qtensor import matmul
from .configs import AudioEncoderConfig

Params = dict[str, Any]
MASKED = -1e30


def sinusoid_positions(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Whisper-style sin/cos table."""
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    scaled = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def get_feat_extract_output_lengths(input_length: int, n_window: int = 100) -> int:
    """Valid encoder tokens for a mel length."""
    leave = input_length % n_window
    feat = (leave - 1) // 2 + 1
    out = ((feat - 1) // 2 + 1 - 1) // 2 + 1
    full = input_length // n_window
    per_win = n_window
    for _ in range(3):
        per_win = (per_win - 1) // 2 + 1
    return out + full * per_win


def init_shapes(cfg: AudioEncoderConfig) -> dict:
    """Parameter shape tree with stacked layers (the JAX `init_params`
    layout, used for checkpoint writing)."""
    c, d, l, f = cfg.downsample_hidden_size, cfg.d_model, cfg.encoder_layers, cfg.encoder_ffn_dim
    return {
        "conv1_w": (c, 1, 3, 3), "conv1_b": (c,),
        "conv2_w": (c, c, 3, 3), "conv2_b": (c,),
        "conv3_w": (c, c, 3, 3), "conv3_b": (c,),
        "conv_out": (d, cfg.conv_feat_dim),
        "pos_embed": (cfg.max_source_positions, d),
        "layers": {
            "ln1_w": (l, d), "ln1_b": (l, d),
            "q_w": (l, d, d), "q_b": (l, d),
            "k_w": (l, d, d), "k_b": (l, d),
            "v_w": (l, d, d), "v_b": (l, d),
            "o_w": (l, d, d), "o_b": (l, d),
            "ln2_w": (l, d), "ln2_b": (l, d),
            "fc1_w": (l, f, d), "fc1_b": (l, f),
            "fc2_w": (l, d, f), "fc2_b": (l, d),
        },
        "ln_post_w": (d,), "ln_post_b": (d,),
        "proj1_w": (d, d), "proj1_b": (d,),
        "proj2_w": (cfg.output_dim, d), "proj2_b": (cfg.output_dim,),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def conv_frontend(params: Params, cfg: AudioEncoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [..., n_mels, T] (T % n_window == 0) -> [..., T//n_window * 13,
    d_model]; every 1-second chunk (of every signal of a leading batch axis)
    convolves in one batch and gets positions 0..12."""
    lead = mel.shape[:-2]
    n_mels, t = mel.shape[-2:]
    n_chunks = t // cfg.n_window
    x = mel.reshape(-1, n_mels, n_chunks, cfg.n_window).permute(0, 2, 1, 3)
    x = x.reshape(-1, 1, n_mels, cfg.n_window)  # [B*N, 1, mels, win]
    for i in (1, 2, 3):
        w = params[f"conv{i}_w"]
        b = params[f"conv{i}_b"]
        x = F.conv2d(x, w.to(x.dtype), stride=2, padding=1)
        x = _gelu(x + b[None, :, None, None])
    n, c, f, tw = x.shape  # [N, C, mels/8, win/8]
    x = x.permute(0, 3, 1, 2).reshape(n, tw, c * f)
    x = matmul(x, params["conv_out"])  # [N, tw, d_model]
    x = x + params["pos_embed"][None, :tw, :].to(x.dtype)
    return x.reshape(*lead, n_chunks * tw, -1)


def _mha(layer: Params, cfg: AudioEncoderConfig, x: torch.Tensor, key_mask=None) -> torch.Tensor:
    """x [B, T, D] bidirectional attention within each row; `key_mask`
    [T] or [B, T] bool excludes keys."""
    b, t, d = x.shape
    h = cfg.encoder_attention_heads
    hd = d // h
    q = (matmul(x, layer["q_w"]) + layer["q_b"]).reshape(b, t, h, hd)
    k = (matmul(x, layer["k_w"]) + layer["k_b"]).reshape(b, t, h, hd)
    v = (matmul(x, layer["v_w"]) + layer["v_b"]).reshape(b, t, h, hd)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (hd ** -0.5)
    if key_mask is not None:
        km = key_mask[None, None, None, :] if key_mask.ndim == 1 else key_mask[:, None, None, :]
        scores = scores.masked_fill(~km, MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float()).to(x.dtype)
    return matmul(out.reshape(b, t, d), layer["o_w"]) + layer["o_b"]


def backend_transformer(params: Params, cfg: AudioEncoderConfig, hidden: torch.Tensor,
                        valid_tokens=None) -> torch.Tensor:
    """hidden [..., T, d_model] -> [..., T, output_dim]; a leading batch
    axis holds same-length inputs. `valid_tokens` (an int, or one per input)
    masks later keys in full mode so a bucket-padded call equals the
    unpadded one on the valid prefix."""
    lead = hidden.shape[:-2]
    t, d_model = hidden.shape[-2:]
    hidden = hidden.reshape(-1, t, d_model)
    n_in = hidden.shape[0]
    key_mask = None
    if cfg.attention_mode == "windowed":
        # our n_window (conv-chunk frames, 100) equals the reference
        # checkpoints' 2*n_window (they ship n_window=50): a window is
        # n_window_infer frames = 13 * (n_window_infer // n_window) tokens
        win = cfg.tokens_per_window * (cfg.n_window_infer // cfg.n_window)
        pad = (-t) % win
        x = F.pad(hidden, (0, 0, 0, pad)).reshape(-1, win, d_model)
        if pad:  # the remainder window must not attend to its zero tail
            key_mask = (torch.arange(t + pad, device=hidden.device) < t).reshape(-1, win)
            key_mask = key_mask.repeat(n_in, 1)
    else:
        x = hidden
        if valid_tokens is not None:
            vt = torch.as_tensor(valid_tokens, device=hidden.device).reshape(-1, 1)
            key_mask = torch.arange(t, device=hidden.device)[None, :] < vt

    for layer in params["layers"]:
        # f32 biases promote the residual branch; cast back to the stream dtype
        attn = _mha(layer, cfg, _layer_norm(x, layer["ln1_w"], layer["ln1_b"]), key_mask)
        x = x + attn.to(x.dtype)
        y = _layer_norm(x, layer["ln2_w"], layer["ln2_b"])
        y = _gelu(matmul(y, layer["fc1_w"]) + layer["fc1_b"])
        y = matmul(y, layer["fc2_w"]) + layer["fc2_b"]
        x = x + y.to(x.dtype)
    x = x.reshape(n_in, -1, d_model)[:, :t].reshape(*lead, t, d_model)

    x = _layer_norm(x, params["ln_post_w"], params["ln_post_b"])
    x = _gelu(matmul(x, params["proj1_w"]) + params["proj1_b"])
    return matmul(x, params["proj2_w"]) + params["proj2_b"]


def encode(params: Params, cfg: AudioEncoderConfig, mel: torch.Tensor,
           valid_mel_len: int | None = None) -> torch.Tensor:
    """mel [n_mels, T] (T padded to n_window) -> embeddings [t_out, output_dim]."""
    t = mel.shape[1]
    if t % cfg.n_window:
        raise ValueError(f"mel length {t} not padded to n_window={cfg.n_window}")
    hidden = conv_frontend(params, cfg, mel)
    t_out = get_feat_extract_output_lengths(t if valid_mel_len is None else valid_mel_len,
                                            cfg.n_window)
    return backend_transformer(params, cfg, hidden[:t_out])
