"""The least time the card could take for the work a window completed:
each piece is bound by the larger of its operations over the peak rate and
its bytes over the memory rate (the arithmetic of the port's kernel table:
bytes read and written over 3.35 TB/s, or operations over their peak).

Pieces, from a configuration's widths:

- `decode_step(t, ctx)`: one token of one sequence at context `ctx`: every
  decoder weight once (q4_k, 144 bytes per 256), the KV cache read once,
  the activations and norms;
- `rows_step(t, ctxs)`: one batched step of len(ctxs) rows: the weights
  once, each row's KV once;
- `prefill(t, new, start)`: `new` prompt tokens after `start` cached ones,
  and the head at the last one;
- `encode(a, tokens, windows)`: the conv frontend over `windows` 1-second
  windows and the transformer over `tokens` with full attention;
- `classify_prefill(t, new, slots)`: the forced aligner's one prefill,
  `new` prompt tokens through the layers, and its class head at the
  `slots` rows alone.

Weights are counted at the stated precision's bytes (q4_k unless a piece
says otherwise), operations at the peak of the products' stated precision.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 1,979 TOP/s
int8, 3.35 TB/s HBM3, at the full 700 W power limit.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12}
Q4K_BYTES_PER_WEIGHT = 144 / 256
ACT_BYTES = 2  # bf16 activations and cache


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0
    peak: str = "bf16"

    def seconds(self) -> tuple[float, str]:
        by_ops, by_bytes = self.flops / PEAK[self.peak], self.bytes / HBM_BYTES_PER_S
        return max(by_ops, by_bytes), "operations" if by_ops > by_bytes else "bytes"


def decoder_params(t: dict) -> tuple[int, int]:
    """(weights of the layers, weights of the head)."""
    d, m = t["hidden_size"], t["intermediate_size"]
    q, kv = t["num_heads"] * t["head_dim"], t["num_kv_heads"] * t["head_dim"]
    per_layer = d * (q + 2 * kv) + q * d + 3 * d * m
    return t["num_layers"] * per_layer, (t.get("classify_num") or t["vocab_size"]) * d


def _kv_bytes(t: dict, ctx: int) -> float:
    return 2.0 * ctx * t["num_kv_heads"] * t["head_dim"] * ACT_BYTES * t["num_layers"]


def _attn_flops(t: dict, q_tokens: float, ctx: float) -> float:
    return 4.0 * q_tokens * ctx * t["num_heads"] * t["head_dim"] * t["num_layers"]


def _act_bytes_per_token(t: dict) -> float:
    """Activations in and out of each product and the norms' f32 weights."""
    d, m = t["hidden_size"], t["intermediate_size"]
    q, kv = t["num_heads"] * t["head_dim"], t["num_kv_heads"] * t["head_dim"]
    per_layer = ACT_BYTES * (d + (q + 2 * kv) + 2 * q + d + d + 2 * m + m + d) + 4 * (2 * d)
    return t["num_layers"] * per_layer + ACT_BYTES * d + 4 * (t.get("classify_num")
                                                              or t["vocab_size"])


def decode_step(t: dict, ctx: int) -> Work:
    return rows_step(t, [ctx])


def rows_step(t: dict, ctxs: list) -> Work:
    layers, head = decoder_params(t)
    rows = len(ctxs)
    flops = 2.0 * (layers + head) * rows + sum(_attn_flops(t, 1, c) for c in ctxs)
    nbytes = ((layers + head) * Q4K_BYTES_PER_WEIGHT + sum(_kv_bytes(t, c) for c in ctxs)
              + rows * _act_bytes_per_token(t))
    return Work(flops, nbytes, "int8" if rows > 1 else "bf16")


def prefill(t: dict, new: int, start: int = 0) -> Work:
    """`new` tokens after `start` cached ones; the head at the last token."""
    layers, head = decoder_params(t)
    flops = 2.0 * layers * new + 2.0 * head + _attn_flops(t, new, start + (new + 1) / 2)
    nbytes = ((layers + head) * Q4K_BYTES_PER_WEIGHT + _kv_bytes(t, start + new)
              + new * _act_bytes_per_token(t))
    return Work(flops, nbytes)


def classify_prefill(t: dict, new: int, slots: int,
                     weight_bytes: float = Q4K_BYTES_PER_WEIGHT) -> Work:
    """`new` tokens from position 0 through the layers, the head at `slots`
    rows: every weight once, the KV written once, the activations of each
    token, and the head's logits at the slots alone."""
    layers, head = decoder_params(t)
    rows = t.get("classify_num") or t["vocab_size"]
    flops = 2.0 * layers * new + 2.0 * head * slots + _attn_flops(t, new, (new + 1) / 2)
    nbytes = ((layers + head) * weight_bytes + _kv_bytes(t, new)
              + new * (_act_bytes_per_token(t) - 4 * rows) + slots * 4 * rows)
    return Work(flops, nbytes)


def encode(a: dict, tokens: int, windows: int, weight_bytes: float = Q4K_BYTES_PER_WEIGHT,
           peak: str = "bf16") -> Work:
    d, f, c = a["d_model"], a["encoder_ffn_dim"], a["downsample_hidden_size"]
    mels, win = a["num_mel_bins"], a["n_window"]
    conv = 0.0
    h, w, cin = mels, win, 1
    for _ in range(3):
        h, w = (h + 1) // 2, (w + 1) // 2
        conv += 2.0 * c * cin * 9 * h * w
        cin = c
    feat = h * c
    per_token = d * feat + a["encoder_layers"] * (4 * d * d + 2 * d * f) + d * d + d * a[
        "output_dim"]
    flops = windows * conv + 2.0 * per_token * tokens + 4.0 * tokens * tokens * d * a[
        "encoder_layers"]
    weights = per_token + 2 * c * c * 9 + c * 9
    nbytes = weights * weight_bytes + ACT_BYTES * (windows * mels * win
                                                   + tokens * a["output_dim"])
    return Work(flops, nbytes, peak)


def least_seconds(works: list) -> tuple[float, dict]:
    """(sum of the pieces' least times, seconds by what bounds them)."""
    total, split = 0.0, {"operations": 0.0, "bytes": 0.0}
    for w in works:
        s, by = w.seconds()
        total += s
        split[by] += s
    return total, split
