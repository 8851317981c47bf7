"""The kernel-order plain versions of the two tensor-core kernels on the CPU.

`q4k_matmul_rows_kernel_order` and `q4_matmul_kernel_order` repeat, with
tensor ops, the arithmetic of `csrc/q4k_matmul_rows.cu` and
`csrc/q4_matmul.cu` step by step (the tiling rule, the K slices, the group
order, the fma's, the bf16 planes of an f32 x), so the designs' numerics are
held here against the plain versions and against the JAX functions, run as
the JAX package's own tests run them (Pallas in interpret mode), before any
card sees them. Inputs come from a numpy seed.

Bounds: kernel 3's integer dots are exact in any order, only the f32 sums
over the groups differ: rtol/atol 1e-5 against `q4k_matmul_rows_ref` and the
JAX kernel. Kernel 6 factors the group and takes an f32 x as two bf16 planes
(2^-17 of each x value dropped, a random-signed 4e-6 of each product):
max|difference| <= 1e-5 * max|plain| against `q4_matmul_ref`, the JAX kernel
and the dense oracle (a tenth of the kernel's bound on the card, 1e-4; seen
2.8e-6); a bf16 x within one bf16 rounding (1e-2). The repacked `Q4Weight` dequantizes bit for bit to the
reference's values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats import quants as jquants
from qwen3_asr_gguf_tpu.ops import pallas_q4k as pq
from qwen3_asr_gguf_tpu.ops import pallas_qmm
from qwen3_asr_gguf_tpu.ops import qtensor as jq
from qwen3_asr_gguf_tpu_torch.ops import q4k, qmm
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX q4_matmul kernel in Pallas interpret mode on the CPU."""
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _close(got, want, bound=1e-5):
    """max|got - want| <= bound * max|want|, the form of the kernels' bounds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def _packed(n, k, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jquants.pack_q4_direct((rng.standard_normal((n, k)) * scale).astype(np.float32)), rng


@pytest.mark.parametrize("n,k,expected", [(512, 512, (8, 1)), (2048, 2048, (16, 2)),
                                          (2048, 6144, (16, 2)), (4096, 2048, (32, 2)),
                                          (12288, 2048, (64, 1)), (152576, 2048, (64, 1))])
def test_rows_tiling_widens_blocks_and_splits_k(n, k, expected):
    """The 1.7B decode shapes: o_proj and down_proj split K over two blocks,
    the LM head takes the widest block and no split."""
    ct, ks = q4k.rows_tiling(n, k)
    assert (ct, ks) == expected
    assert (n // 2) % ct == 0 and (k // 512) % ks == 0
    # every K slice of a block has a group of each chunk to take
    assert q4k.ROWS_CHUNK_GROUPS % (q4k.ROWS_WARPS // (ct // 8)) == 0


@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("n,k", [(512, 2048), (1024, 512)])
def test_rows_kernel_order_vs_plain_and_jax_kernel(t, n, k):
    p, rng = _packed(n, k, 100 * t + n)
    jw, tw = pq.from_packed_q4(p), q4k.from_packed_q4(p)
    x = (rng.standard_normal((t, k)) * 0.15).astype(np.float32)
    got = q4k.q4k_matmul_rows_kernel_order(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (t, n)
    plain = q4k.q4k_matmul_rows_ref(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(pq.q4k_matmul_rows(jnp.asarray(x), jw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rows_kernel_order_quantizes_as_the_plain_version():
    """Pass A's int8 values and sx are the plain version's bit for bit; only
    the group sum is taken in another order (a last-bit difference)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 1024)).astype(np.float32))
    xq, sx, xsum = q4k.quantize_act_ref(x)
    kq, ksx, ksum = q4k.quantize_act_kernel_order(x)
    assert torch.equal(xq, kq) and torch.equal(sx, ksx)
    np.testing.assert_allclose(ksum.numpy(), xsum.numpy(), rtol=0, atol=1e-5)


def test_rows_kernel_order_zero_row_and_clipped_row():
    """A row of zeros (sx at its 1e-10 floor) gives exact zeros; a row of
    +-1e4 sits at the +-127 clip in every group."""
    p, rng = _packed(512, 512, 7)
    tw = q4k.from_packed_q4(p)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    x[2] = 0.0
    x[5] = np.where(x[5] > 0, 1e4, -1e4)
    got = q4k.q4k_matmul_rows_kernel_order(torch.from_numpy(x), tw)
    plain = q4k.q4k_matmul_rows_ref(torch.from_numpy(x), tw)
    assert torch.equal(got[2], torch.zeros(512))
    assert bool(torch.isfinite(got).all())
    for row in (0, 5):
        np.testing.assert_allclose(got[row].numpy(), plain[row].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(plain[row].abs().max()))


@pytest.mark.parametrize("t,n,k,expected", [
    (1, 2048, 2048, (2, 8, 2)), (1, 12288, 2048, (4, 8, 1)), (1, 152064, 2048, (4, 8, 1)),
    (8, 4096, 2048, (4, 8, 2)), (26, 1024, 1024, (1, 8, 2)), (52, 1024, 4096, (8, 4, 8)),
    (64, 152064, 2048, (8, 4, 1)), (3, 40, 64, (1, 8, 1)), (64, 8, 128, (2, 4, 1))])
def test_qmm_tiling(t, n, k, expected):
    pw, gcm, ks = qmm.tiling(t, n, k)
    assert (pw, gcm, ks) == expected
    assert qmm.WARPS // pw <= gcm  # every K slice of a block has a group pair to take
    assert 1 <= ks <= min(8, -(-(k // 64) // gcm))
    # two planes (an f32 x): chunks of 4 pairs above 16 rows, and more than 32
    # rows do not fit the widest block's stage
    pw2, gcm2, ks2 = qmm.tiling(t, n, k, planes=2)
    assert gcm2 == (8 if t <= 16 else 4) and qmm.WARPS // pw2 <= gcm2
    assert pw2 <= (4 if t > 32 else 8) and 1 <= ks2 <= min(8, -(-(k // 64) // gcm2))


@pytest.mark.parametrize("t", [1, 8, 26, 52, 64])
@pytest.mark.parametrize("n,k", [(512, 1024), (256, 512)])
def test_qmm_kernel_order_vs_plain_and_jax_kernel(interpret_mode, t, n, k):
    p, rng = _packed(n, k, 1000 * t + n, scale=1.0)
    jw, tw = jq.Q4Weight.from_packed(p), tq.Q4Weight.from_packed(p)
    x = rng.standard_normal((t, k)).astype(np.float32)
    got = qmm.q4_matmul_kernel_order(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (t, n)
    plain = qmm.q4_matmul_ref(torch.from_numpy(x), tw)
    _close(got.numpy(), plain.numpy())
    _close(got.numpy(), np.asarray(pallas_qmm.q4_matmul(jnp.asarray(x), jw)))
    _close(got.numpy(), x.astype(np.float64) @ jquants.unpack_q4(p).astype(np.float64).T)


@pytest.mark.parametrize("t", [1, 8, 52])
def test_qmm_kernel_order_bf16_rows_are_one_exact_plane(interpret_mode, t):
    """A bf16 x is exact in one plane: the factored sums differ from the
    plain version by f32 rounding only, far inside the result's own bf16
    rounding (1e-2)."""
    p, rng = _packed(512, 1024, 7 + t, scale=1.0)
    jw, tw = jq.Q4Weight.from_packed(p), tq.Q4Weight.from_packed(p)
    x = torch.from_numpy(rng.standard_normal((t, 1024)).astype(np.float32)).to(torch.bfloat16)
    assert len(qmm.split_planes(x)) == 1 and torch.equal(qmm.split_planes(x)[0], x.float())
    got = qmm.q4_matmul_kernel_order(x, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), qmm.q4_matmul_ref(x, tw).float().numpy(),
                               rtol=1e-2, atol=1e-2)
    want = pallas_qmm.q4_matmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_qmm_f32_rows_split_into_two_bf16_planes():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32))
    hi, lo = qmm.split_planes(x)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    rel = ((hi + lo - x).abs() / x.abs().clamp(min=1e-30)).max().item()
    assert rel <= 2.0 ** -16  # two 8-bit mantissas cover 16 bits of x


@pytest.mark.parametrize("n,k", [(8, 64), (24, 320), (40, 896), (48, 2048)])
def test_qmm_kernel_order_partial_chunks_and_small_shapes(n, k):
    """K = 64, 320 and 896 are 1, 5 and 14 group pairs: a last chunk of fewer
    than 8 (or 4) pairs, and K slices with no pair to take."""
    p, rng = _packed(n, k, n + k, scale=1.0)
    tw = tq.Q4Weight.from_packed(p)
    for t in (3, 20):
        x = rng.standard_normal((t, k)).astype(np.float32)
        got = qmm.q4_matmul_kernel_order(torch.from_numpy(x), tw)
        _close(got.numpy(), x.astype(np.float64) @ jquants.unpack_q4(p).astype(np.float64).T)


@pytest.mark.parametrize("n,k,group", [(48, 512, 32), (16, 64, 32), (8, 2048, 32), (8, 128, 64),
                                       (8, 96, 32)])
def test_repacked_weight_dequantizes_bit_for_bit(n, k, group):
    """The port undoes the reference's rank-major column permutation when it
    builds a `Q4Weight`; scales and offsets stay f32 and untouched, and the
    dense values are the reference's bit for bit. Groups of 64 and K = 96
    (no whole groups per half) are not rank-major and pass through."""
    p, _ = _packed(n, k, n + k + group) if group == 32 else (
        jquants.pack_q4_direct(np.random.default_rng(n).standard_normal((n, k)).astype(np.float32),
                               group=group), None)
    jw, tw = jq.Q4Weight.from_packed(p), tq.Q4Weight.from_packed(p)
    want = np.asarray(jq.dequant_q4(jw, dtype=jnp.float32))
    got = tq.dequant_q4(tw, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jquants.unpack_q4(p))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(tw.minv.numpy(), np.asarray(jw.minv))
    assert tw.scale.dtype == torch.float32 and tw.minv.dtype == torch.float32
    if jquants.is_rank_major(p):
        inv = jquants.rank_major_inverse(k // 2)
        np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(p.packed)[:, inv])
    else:
        np.testing.assert_array_equal(tw.packed.numpy(), np.asarray(p.packed))


def test_from_jax_params_repacks_like_from_packed():
    """A JAX `Q4Weight` leaf (stacked over layers) carried across by
    `from_jax_params` is the same port weight as `from_packed` builds."""
    from qwen3_asr_gguf_tpu_torch.models import params as tP

    packs = [_packed(32, 256, s)[0] for s in (1, 2)]
    stacked = jq.Q4Weight(packed=np.stack([p.packed for p in packs]),
                          scale=np.stack([p.scale for p in packs]),
                          minv=np.stack([p.minv for p in packs]))
    tree = tP.from_jax_params({"layers": {"o_proj": stacked}})
    for layer, p in zip(tree["layers"], packs):
        want = tq.Q4Weight.from_packed(p)
        for f in ("packed", "scale", "minv"):
            assert torch.equal(getattr(layer["o_proj"], f), getattr(want, f))
