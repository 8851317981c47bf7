"""What the probes share: the repository root on `sys.path` (for
`chip_smoke`), a fresh kernel build, and random weights on the card."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def setup():
    """(torch, chip_smoke, device, generator, 1.7B config) after building the
    kernels; prints the card's name and power limit."""
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from qwen3_asr_gguf_tpu_torch import preset
    from qwen3_asr_gguf_tpu_torch.ops import _build

    print(cs.nvidia_smi_line(), flush=True)
    _build.build(force=True)
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return torch, cs, dev, g, preset(cs.PRESET)


def q4_weights(torch, dev, g, n: int, k: int, copies: int | None = None) -> list:
    """Random planar `Q4Weight`s on the card, enough copies to stay cold in
    the 50 MB L2 (any bytes are a valid weight)."""
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as qt

    nbytes = n * k // 2 + 8 * n * (k // 32)
    count = copies or max(2, -(-(128 << 20) // nbytes))
    return [qt.Q4Weight(
        packed=torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
        scale=torch.rand((n, k // 32), generator=g, device=dev) * 1e-2 + 1e-3,
        minv=torch.rand((n, k // 32), generator=g, device=dev) * 8e-2) for _ in range(count)]


def qmm_cases(cfg) -> list[tuple[str, int, int]]:
    """(name, N, K) of kernel 6's timed shapes: the 1.7B decode products, the
    256-row-padded LM head, and the encoder's fc1, fc2 and q_w."""
    text, audio = cfg.text, cfg.audio
    d, m = text.hidden_size, text.intermediate_size
    return [("o_proj", d, text.num_heads * text.head_dim), ("down_proj", d, m),
            ("qkv_proj", (text.num_heads + 2 * text.num_kv_heads) * text.head_dim, d),
            ("gateup_proj", 2 * m, d), ("lm_head", -(-text.vocab_size // 256) * 256, d),
            ("enc_fc1", audio.encoder_ffn_dim, audio.d_model),
            ("enc_fc2", audio.d_model, audio.encoder_ffn_dim),
            ("enc_q_w", audio.d_model, audio.d_model)]
