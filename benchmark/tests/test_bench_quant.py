"""The benchmark's codecs against the port's: the bytes the checkpoint
writer encodes decode to the same values in the port's numpy decoders and
in the reference's; the int4 semantics the reference works out again equal
the port's packed weights."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import quant


def _weights(n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, k, generator=g) * 0.02


def test_q4_k_matches_port_decoder():
    from qwen3_asr_gguf_tpu_torch.formats import quants as q

    w = _weights(64, 512)
    b = quant.encode_q4_k(w)
    mine = quant.decode_q4_k(b, 512).numpy()
    port = q.dequantize_q4_k(b.numpy(), (64, 512))
    assert np.array_equal(mine, port)
    assert np.abs(mine - w.numpy()).max() < 0.01


def test_q6_k_matches_port_decoder():
    from qwen3_asr_gguf_tpu_torch.formats import quants as q

    w = _weights(32, 512, 1)
    b = quant.encode_q6_k(w)
    mine = quant.decode_q6_k(b, 512).numpy()
    port = q.dequantize_q6_k(b.numpy(), (32, 512))
    assert np.array_equal(mine, port)
    assert np.abs(mine - w.numpy()).max() < 0.003


def test_int4_group32_matches_port_encoder_weight():
    from qwen3_asr_gguf_tpu_torch.formats import quants as q
    from qwen3_asr_gguf_tpu_torch.ops.qtensor import Q4Weight, dequant_q4

    w = _weights(48, 256, 2)
    port = dequant_q4(Q4Weight.from_packed(q.pack_q4_direct(w.numpy())), torch.float32)
    assert torch.allclose(quant.int4_group32(w), port, rtol=0, atol=1e-7)


def test_int4_factored_matches_port_head():
    from qwen3_asr_gguf_tpu_torch.formats import quants as q
    from qwen3_asr_gguf_tpu_torch.ops.q4k import pack_q4k_mxu

    w = _weights(16, 512, 3)
    rows, sub_t, min_t, dd = pack_q4k_mxu(q.pack_q4_direct(w.numpy()))
    # the matvec layout: signed nibbles (q - 8) of channel pairs, 6-bit sub
    # scales and mins per 32, (d, dmin) per 256
    lo = (rows & 0x0F).astype(np.int8)
    hi = (rows >> 4).astype(np.int8)
    nib = np.empty((16, 512), np.int8)
    nib[0::2], nib[1::2] = np.where(lo > 7, lo - 16, lo), np.where(hi > 7, hi - 16, hi)
    qv = nib.astype(np.float32) + 8
    s = dd.shape[0] // 2
    d = dd.reshape(s, 2, 16)[:, 0].T.repeat(8, axis=1)
    dmin = dd.reshape(s, 2, 16)[:, 1].T.repeat(8, axis=1)
    sc, mn = sub_t.T.astype(np.float32), min_t.T.astype(np.float32)
    port = (qv.reshape(16, -1, 32) * (d * sc)[..., None] - (dmin * mn)[..., None]).reshape(16, 512)
    assert np.allclose(quant.int4_factored(w).numpy(), port, rtol=0, atol=1e-6)
