"""Port parity: q4_k packing, dequant, activation quantization and the plain
matvec of qwen3_asr_gguf_tpu_torch/ops/q4k.py against the JAX package
(Pallas kernels in interpret mode on the CPU). The CUDA kernels themselves
are held against the plain versions in the `cuda`-marked tests, which skip
without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats import quants as q
from qwen3_asr_gguf_tpu.models.decoder import rms_norm as jax_rms_norm
from qwen3_asr_gguf_tpu.ops import pallas_q4k as pq
from qwen3_asr_gguf_tpu.ops import qtensor as jq
from qwen3_asr_gguf_tpu_torch.models.decoder import rms_norm
from qwen3_asr_gguf_tpu_torch.ops import q4k, qtensor


def _packed(n, k, seed, native_q4k=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    if native_q4k:
        return q.repack_q4_k(q.quantize_q4_k(w), (n, k))
    return q.pack_q4_direct(w)


def _jax_w(p):
    return pq.from_packed_q4(p)


def _torch_w(p):
    return q4k.from_packed_q4(p)


@pytest.mark.parametrize("native_q4k", [False, True])
def test_pack_layout_bit_equal(native_q4k):
    p = _packed(96, 512, seed=3, native_q4k=native_q4k)
    want = pq.pad_rows(*pq.pack_q4k_mxu(p))
    got = q4k.pad_rows(*q4k.pack_q4k_mxu(p))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native_q4k", [False, True])
def test_dequant_mxu_bit_equal(native_q4k):
    p = _packed(64, 1024, seed=5, native_q4k=native_q4k)
    want = np.asarray(pq.dequant_mxu(_jax_w(p), dtype=jnp.float32))
    got = q4k.dequant_mxu(_torch_w(p), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_dequant_q4_planar_bit_equal():
    p = _packed(48, 512, seed=9)
    want = np.asarray(jq.dequant_q4(jq.Q4Weight.from_packed(p), dtype=jnp.float32))
    got = qtensor.dequant_q4(qtensor.Q4Weight.from_packed(p), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_dequant_q6k_bit_equal():
    rng = np.random.default_rng(2)
    blob = q.quantize_q6_k((rng.standard_normal((8, 512)) * 0.1).astype(np.float32))
    want = np.asarray(jq.dequant_q6k_device(blob, (8, 512), dtype=jnp.float32))
    got = qtensor.dequant_q6k(blob, (8, 512), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_act_quant(x: np.ndarray):
    """The TPU kernel's in-kernel activation quantization (pallas_q4k.py
    `_kernel`: group-masked rows, x * reciprocal(sx), round, clip)."""
    k = x.shape[-1]
    sub = k // 32
    xj = jnp.asarray(x.reshape(1, k))
    lane_group = jax.lax.broadcasted_iota(jnp.int32, (sub, k), 1) // 32
    row = jax.lax.broadcasted_iota(jnp.int32, (sub, k), 0)
    xm = jnp.where(lane_group == row, jnp.broadcast_to(xj, (sub, k)), 0.0)
    amax = jnp.max(jnp.abs(xm), axis=1, keepdims=True)
    sx = jnp.maximum(amax, 1e-10) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xm * (1.0 / sx)), -127, 127).astype(jnp.int8)
    return (np.asarray(xq).sum(axis=0).astype(np.int8), np.asarray(sx)[:, 0],
            np.asarray(jnp.sum(xm, axis=1)))


def test_activation_int8_bit_equal():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(2048) * rng.uniform(0.01, 3.0, 2048)).astype(np.float32)
    x[:32] = 0.0  # an all-zero group takes the 1e-10 floor
    x[32] = 12.7  # group 1: sx ~ 0.1, and x * (1/sx) lands near .5 ties
    x[33:64] = np.arange(1, 32, dtype=np.float32) * 0.05
    want_q, want_sx, want_sum = _jax_act_quant(x)
    got_q, got_sx, got_sum = q4k.quantize_act_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_sx.numpy(), want_sx)
    np.testing.assert_allclose(got_sum.numpy(), want_sum, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [512, 1024, 2048])
def test_matvec_plain_vs_jax_interpret(k):
    """Exact integer group dots on both sides: the only difference is the
    f32 summation order of the per-group contributions (bound rtol 1e-5,
    atol 1e-6 of the output's max)."""
    n = 512
    p = _packed(n, k, seed=k)
    x = (np.random.default_rng(k + 1).standard_normal((1, k)) * 0.1).astype(np.float32)
    want = np.asarray(pq.q4k_matvec(jnp.asarray(x), _jax_w(p)))
    got = q4k.q4k_matvec_ref(torch.from_numpy(x), _torch_w(p)).numpy()
    assert got.shape == want.shape == (1, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_matvec_normed_plain_vs_jax_interpret():
    k, n = 2048, 512
    rng = np.random.default_rng(23)
    p = _packed(n, k, seed=29)
    x = rng.standard_normal((1, k)).astype(np.float32)
    nw = np.abs(rng.standard_normal(k)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pq.q4k_matvec_normed(xb, _jax_w(p), jnp.asarray(nw), 1e-6), np.float32)
    got = q4k.q4k_matvec_normed_ref(
        torch.from_numpy(x).to(torch.bfloat16), _torch_w(p), torch.from_numpy(nw), 1e-6
    ).float().numpy()
    # bf16 outputs: at most one bf16 ulp apart where the f32 sums round apart
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6 * np.abs(want).max())


def test_matvec_normed_plain_bit_parity():
    """The norm-fused plain matvec equals rms_norm -> plain matvec exactly
    (it replays the bf16 round-trip of the unfused path)."""
    rng = np.random.default_rng(0)
    k, n = 2048, 512
    w = _torch_w(q.pack_q4_direct(rng.standard_normal((n, k)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32)).to(torch.bfloat16)
    nw = torch.from_numpy(np.abs(rng.standard_normal(k)).astype(np.float32))
    assert q4k.supported_normed(tuple(x.shape), w)
    a = q4k.q4k_matvec_ref(rms_norm(x, nw, 1e-6), w)
    b = q4k.q4k_matvec_normed_ref(x, w, nw, 1e-6)
    assert torch.equal(a, b)
    # and the JAX unfused path agrees on the normed activation itself
    want = np.asarray(jax_rms_norm(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                   jnp.asarray(nw.numpy()), 1e-6), np.float32)
    np.testing.assert_array_equal(rms_norm(x, nw, 1e-6).float().numpy(), want)


def test_supported_conditions_match_jax():
    for n, k in [(512, 512), (1024, 2048), (512, 6144), (256, 512), (512, 256), (1536, 1024)]:
        p = _packed(n, k, seed=1)
        jw, tw = pq.from_packed_q4(p, pad=False), q4k.from_packed_q4(p, pad=False)
        for xs in [(1, k), (k,), (2, k)]:
            assert q4k.supported(xs, tw) == pq.supported(xs, jw), (n, k, xs)
            assert q4k.supported_normed(xs, tw) == pq.supported_normed(xs, jw), (n, k, xs)


def test_cpu_wrappers_run_plain_and_count_nothing():
    p = _packed(512, 512, seed=4)
    w = _torch_w(p)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 512)).astype(np.float32))
    nw = torch.ones(512)
    before = (q4k.q4k_matvec.launches, q4k.q4k_matvec_normed.launches)
    assert torch.equal(q4k.q4k_matvec(x, w), q4k.q4k_matvec_ref(x, w))
    assert torch.equal(q4k.q4k_matvec_normed(x, w, nw, 1e-6),
                       q4k.q4k_matvec_normed_ref(x, w, nw, 1e-6))
    assert (q4k.q4k_matvec.launches, q4k.q4k_matvec_normed.launches) == before


def test_matmul_dispatch_dense_fallback_matches_jax():
    """Rows that no kernel takes (prefill) dequantize and multiply with an
    f32 accumulate, as qtensor.matmul does in the JAX package."""
    p = _packed(512, 512, seed=8)
    x = (np.random.default_rng(9).standard_normal((4, 512)) * 0.1).astype(np.float32)
    want = np.asarray(jq.matmul(jnp.asarray(x), _jax_w(p)))
    got = qtensor.matmul(torch.from_numpy(x), _torch_w(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
