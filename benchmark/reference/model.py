"""The plain reference of Qwen3-ASR in PyTorch, float32, one sequence at a
time, no cache and no kernels: the log-mel frontend, the audio encoder and
the Qwen3 text decoder as the published architecture describes them
(Qwen3-ASR technical report; Whisper's log-mel; Qwen3's decoder).

The control (`Precision(mode)`) is this reference one step below the
precisions that the configurations state, in one of two forms:

- "fp8": the step below bf16. Every activation that enters a product, and
  every key and value, is rounded to float8 (e4m3, one scale per tensor, as
  `torch._scaled_mm` takes them);
- "int4dec": the step below each stated precision where the port's decode
  products run int4 weights on int8 activations (kernels 1-3 quantize each
  activation row, 32 values to a scale): the rows of generated tokens enter
  every product as int4 (32 values to a scale, symmetric), the prompt's
  rows, the encoder's activations and the cache float8 as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_FFT, HOP = 400, 160


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _int4(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:  # no generated row (a job that served one token)
        return x
    g = x.reshape(*x.shape[:-1], -1, 32)
    s = g.abs().amax(-1, keepdim=True).clamp(min=1e-12) / 7.0
    return (torch.clamp(torch.round(g / s), -8, 7) * s).reshape(x.shape)


class Precision:
    """Full float32 (`mode` None), or the control in `mode`;
    `decode_from` is the first row of a decoder input that is a generated
    token."""

    def __init__(self, mode: str | None = None):
        assert mode in (None, "fp8", "int4dec"), mode
        self.mode = mode
        self.decode_from: int | None = None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return x
        if self.mode == "fp8" or self.decode_from is None or x.shape[-1] % 32:
            return _fp8(x)
        k = self.decode_from
        return torch.cat([_fp8(x[:k]), _int4(x[k:])])

    def cache(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mode is None else _fp8(x)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w.t()


def log_mel(audio: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """audio [n] f32 -> [n_mels, n // 160]: reflect-padded 400-point frames
    at hop 160, periodic Hann, power spectrum, mel bank, log10, clamp to
    (max - 8), (x + 4) / 4."""
    y = F.pad(audio.float()[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = y.unfold(0, N_FFT, HOP)
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.log10(torch.clamp(power @ filters, min=1e-10))[: audio.shape[0] // HOP]
    mel = torch.maximum(mel, mel.max() - 8.0)
    return ((mel + 4.0) / 4.0).t()


def encoder_tokens(frames: int, n_window: int = 100) -> int:
    """Encoder outputs for `frames` mel frames: 13 per whole window, and the
    three stride-2 convolutions' count for the remainder."""
    per = n_window
    for _ in range(3):
        per = (per - 1) // 2 + 1
    rest = frames % n_window
    out = (((rest - 1) // 2 + 1 - 1) // 2 + 1 - 1) // 2 + 1
    return out + frames // n_window * per


def _layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-5)


def encode(p: dict, a: dict, mel: torch.Tensor, prec: Precision) -> torch.Tensor:
    """mel [n_mels, T] -> [encoder_tokens(T), output_dim]: the frames
    zero-padded to whole 100-frame windows, each window through three 3x3
    stride-2 convolutions with GELU, flattened, projected, plus positions
    0..12; the rows of the T valid frames then through pre-LN transformer
    layers with full bidirectional attention among them, LayerNorm, GELU
    projection."""
    nw = a["n_window"]
    n_mels, t = mel.shape
    mel = F.pad(mel, (0, (-t) % nw))
    x = mel.reshape(n_mels, -1, nw).permute(1, 0, 2)[:, None]  # [W, 1, mels, win]
    for i in (1, 2, 3):
        x = F.gelu(F.conv2d(prec.act(x), p[f"conv{i}_w"], p[f"conv{i}_b"], stride=2, padding=1))
    w_, c, f, tw = x.shape
    x = prec.mm(x.permute(0, 3, 1, 2).reshape(w_, tw, c * f), p["conv_out"])
    x = (x + p["pos_embed"][None, :tw]).reshape(w_ * tw, -1)[: encoder_tokens(t, nw)]
    h = a["encoder_attention_heads"]
    hd = a["d_model"] // h
    for i in range(a["encoder_layers"]):
        y = _layer_norm(x, p["ln1_w"][i], p["ln1_b"][i])
        q = (prec.mm(y, p["q_w"][i]) + p["q_b"][i]).reshape(-1, h, hd).transpose(0, 1)
        k = (prec.mm(y, p["k_w"][i]) + p["k_b"][i]).reshape(-1, h, hd).transpose(0, 1)
        v = (prec.mm(y, p["v_w"][i]) + p["v_b"][i]).reshape(-1, h, hd).transpose(0, 1)
        k, v = prec.cache(k), prec.cache(v)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1) @ v
        x = x + prec.mm(att.transpose(0, 1).reshape(-1, a["d_model"]), p["o_w"][i]) + p["o_b"][i]
        y = _layer_norm(x, p["ln2_w"][i], p["ln2_b"][i])
        y = F.gelu(prec.mm(y, p["fc1_w"][i]) + p["fc1_b"][i])
        x = x + prec.mm(y, p["fc2_w"][i]) + p["fc2_b"][i]
    x = _layer_norm(x, p["ln_post_w"], p["ln_post_b"])
    x = F.gelu(prec.mm(x, p["proj1_w"]) + p["proj1_b"])
    return prec.mm(x, p["proj2_w"]) + p["proj2_b"]


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x [T, H, d], rotate-half RoPE at integer positions `pos` [T]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def decode_logits(p: dict, t: dict, emb: torch.Tensor, at: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """Input embeddings [T, D] at positions 0..T-1 -> head logits [len(at), V]
    at rows `at`: causal GQA with per-head RMSNorm on q and k, rotate-half
    RoPE, SwiGLU, final RMSNorm."""
    eps, n = t["rms_norm_eps"], emb.shape[0]
    hq, hkv, hd = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    pos = torch.arange(n, device=emb.device)
    mask = torch.ones(n, n, dtype=torch.bool, device=emb.device).tril()
    x = emb
    for i in range(t["num_layers"]):
        y = _rms(x, p["attn_norm"][i], eps)
        q = _rms(prec.mm(y, p["q_proj"][i]).reshape(n, hq, hd), p["q_norm"][i], eps)
        k = _rms(prec.mm(y, p["k_proj"][i]).reshape(n, hkv, hd), p["k_norm"][i], eps)
        v = prec.mm(y, p["v_proj"][i]).reshape(n, hkv, hd)
        q, k = _rope(q, pos, t["rope_theta"]), _rope(k, pos, t["rope_theta"])
        k, v = prec.cache(k), prec.cache(v)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        s = (q.transpose(0, 1) @ k.permute(1, 2, 0)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        o = (torch.softmax(s, -1) @ v.transpose(0, 1)).transpose(0, 1).reshape(n, hq * hd)
        x = x + prec.mm(o, p["o_proj"][i])
        y = _rms(x, p["mlp_norm"][i], eps)
        y = F.silu(prec.mm(y, p["gate_proj"][i])) * prec.mm(y, p["up_proj"][i])
        x = x + prec.mm(y, p["down_proj"][i])
    x = _rms(x[at], p["final_norm"], eps)
    k = prec.decode_from  # the head's rows: `at`, renumbered from 0
    prec.decode_from = None if k is None else max(0, k - int(at[0]))
    out = prec.mm(x, p["lm_head"])
    prec.decode_from = k
    return out
