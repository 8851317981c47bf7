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


# -- the one-launch matvec (the Hopper design) ------------------------------------


def _lane_order_xsum(x: np.ndarray) -> np.ndarray:
    """The prologue's group sums, written out with numpy f32 scalars: eight
    lanes of four values, ((v0+v1)+v2)+v3 in each, then butterflies over the
    lanes at distance 1, 2 and 4."""
    out = []
    for grp in x.astype(np.float32).reshape(-1, 32):
        lanes = [((grp[4 * i] + grp[4 * i + 1]) + grp[4 * i + 2]) + grp[4 * i + 3]
                 for i in range(8)]
        for o in (1, 2, 4):
            lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(8)]
        out.append(lanes[0])
    return np.array(out, np.float32)


def _special_row(kind: str, k: int) -> np.ndarray:
    rng = np.random.default_rng(len(kind) + k)
    x = (rng.standard_normal(k) * rng.uniform(0.01, 3.0, k)).astype(np.float32)
    if kind == "zeros":
        x[: k // 2] = 0.0  # whole groups of zeros take the 1e-10 floor
    elif kind == "large":
        x = np.where(x > 0, 1e4, -1e4).astype(np.float32)  # every value at the +-127 clip
        x[5::7] *= 0.5
    elif kind == "halves":
        # group g: amax 12.7 so 1/sx is ~10, and values k + 0.05 land on .5 ties
        x = np.tile(np.arange(32, dtype=np.float32) * 0.05 + 0.05, k // 32)
        x[::32] = 12.7
        x[1::32] = -12.7
    return x


@pytest.mark.parametrize("kind", ["random", "zeros", "large", "halves"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prologue_quantization_bit_equal_to_pass_a(kind, dtype):
    """The matvec kernel's prologue quantization (mirrored by
    `quantize_act_kernel_order`): its int8s and sx bit-equal to pass A's
    plain version (`quantize_act_ref`) and to the TPU kernel's, and xsum
    bit-equal to the lane-order sums written out in numpy."""
    k = 2048
    x = torch.from_numpy(_special_row(kind, k)).to(dtype).float()
    got_q, got_sx, got_sum = q4k.quantize_act_kernel_order(x.reshape(1, k))
    ref_q, ref_sx, _ = q4k.quantize_act_ref(x.reshape(1, k))
    assert torch.equal(got_q, ref_q) and torch.equal(got_sx, ref_sx)
    want_q, want_sx, _ = _jax_act_quant(x.numpy())
    np.testing.assert_array_equal(got_q.numpy()[0], want_q)
    np.testing.assert_array_equal(got_sx.numpy()[0], want_sx)
    np.testing.assert_array_equal(got_sum.numpy()[0], _lane_order_xsum(x.numpy()))


@pytest.mark.parametrize("n,k", [(512, 2048), (512, 6144), (1024, 2048), (512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_kernel_order_vs_plain_and_jax(n, k, dtype):
    """`q4k_matvec_kernel_order` (lanes over groups, a butterfly over the
    lanes) at o_proj-, down_proj- and head-like K against the plain version
    and the JAX kernel in interpret mode: the same exact group dots and
    scales, f32 sums in another order (f32: 1e-5 of max; bf16 output: one
    rounding, 1e-2 of max). K = 512 leaves half the lanes without a group."""
    p = _packed(n, k, seed=n + k)
    x = torch.from_numpy((np.random.default_rng(k).standard_normal((1, k)) * 0.1)
                         .astype(np.float32)).to(dtype)
    got = q4k.q4k_matvec_kernel_order(x, _torch_w(p))
    assert got.shape == (1, n) and got.dtype == dtype
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    want = q4k.q4k_matvec_ref(x, _torch_w(p)).float()
    assert (got.float() - want).abs().max() <= bound * want.abs().max()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                               else jnp.float32)
    jwant = np.asarray(pq.q4k_matvec(jx, _jax_w(p)), np.float32)
    assert np.abs(got.float().numpy() - jwant).max() <= bound * np.abs(jwant).max()


# -- the one-launch fused-norm matvec (the Hopper design) -------------------------


def _lane_order_normed_row(x: np.ndarray, nw: np.ndarray, eps: float) -> np.ndarray:
    """The fused-norm prologue written out with numpy f32 scalars: lane l of
    warp w squares and adds, in order, the values 4l .. 4l + 3 of the
    128-value pieces w, w + 8, ...; butterflies over the lanes (xor 16 .. 1);
    the warps added in order; rstd = 1 / sqrt(ss / K + eps); bf16(x * rstd * w)."""
    f32 = np.float32
    k = x.size
    x = x.astype(f32)
    warp_ss = []
    for w in range(8):
        lanes = []
        for lane in range(32):
            ss = f32(0.0)
            for base in range(w * 128, k, 8 * 128):
                for e in range(4):
                    v = x[base + 4 * lane + e]
                    ss = f32(ss + f32(v * v))
            lanes.append(ss)
        for o in (16, 8, 4, 2, 1):
            lanes = [f32(lanes[i] + lanes[i ^ o]) for i in range(32)]
        warp_ss.append(lanes[0])
    total = warp_ss[0]
    for s in warp_ss[1:]:
        total = f32(total + s)
    rstd = f32(f32(1.0) / f32(np.sqrt(f32(f32(total / f32(k)) + f32(eps)))))
    xn = ((x * rstd).astype(f32) * nw.astype(f32)).astype(f32)
    return torch.from_numpy(xn).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("k", [512, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normed_row_kernel_order_bit_equal_to_lane_order(k, dtype):
    """`normed_row_kernel_order` (the fused-norm kernel's prologue) equals the
    lane-order sums written out in numpy bit for bit, and the port's
    rms_norm within one bf16 step (the sum of squares in another order can
    move rstd by an ulp)."""
    rng = np.random.default_rng(k + 7)
    x = torch.from_numpy((rng.standard_normal((1, k)) * rng.uniform(0.1, 4.0, (1, k)))
                         .astype(np.float32)).to(dtype)
    nw = torch.from_numpy(np.abs(rng.standard_normal(k)).astype(np.float32) + 0.1)
    got = q4k.normed_row_kernel_order(x, nw, 1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = _lane_order_normed_row(x.float().numpy()[0], nw.numpy(), 1e-6)
    np.testing.assert_array_equal(got.float().numpy()[0], want)
    plain = rms_norm(x, nw, 1e-6).float()
    np.testing.assert_allclose(got.float().numpy(), plain.numpy(), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("n,k", [(512, 2048), (1024, 1024), (512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_normed_kernel_order_vs_plain_and_jax(n, k, dtype):
    """`q4k_matvec_normed_kernel_order` (the prologue's normed row, then
    kernel 1's lane sums) against the plain version and the JAX kernel in
    interpret mode: f32 outputs within 1e-5 of max (f32 sum orders), bf16
    outputs at most one bf16 step apart (rtol 2^-7) where the sums round
    apart. The JAX kernel takes the row in bf16, as the decode step has it."""
    p = _packed(n, k, seed=n + 5 * k)
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32)).to(torch.bfloat16)
    nw = torch.from_numpy(np.abs(rng.standard_normal(k)).astype(np.float32) + 0.1)
    xd = x.to(dtype)
    got = q4k.q4k_matvec_normed_kernel_order(xd, _torch_w(p), nw, 1e-6)
    assert got.shape == (1, n) and got.dtype == dtype
    want = q4k.q4k_matvec_normed_ref(xd, _torch_w(p), nw, 1e-6).float()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    else:
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2 ** -7,
                                   atol=1e-6 * want.abs().max().item())
    jwant = np.asarray(pq.q4k_matvec_normed(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                            _jax_w(p), jnp.asarray(nw.numpy()), 1e-6), np.float32)
    np.testing.assert_allclose(got.float().numpy(), jwant, rtol=2 ** -7,
                               atol=1e-6 * np.abs(jwant).max())


def test_normed_wrapper_takes_one_launch_without_scratch():
    """The fused-norm kernel's C entry point is kernel 1's with norm_w and
    eps added: no scratch pointers (one launch, no per-call allocation)."""
    from qwen3_asr_gguf_tpu_torch.ops import _build

    sig = _build._SIGNATURES["q4k_matvec_normed_launch"]
    assert sig == _build._SIGNATURES["q4k_matvec_launch"][:2] + [_build._P, _build._F] \
        + _build._SIGNATURES["q4k_matvec_launch"][2:]
    assert q4k.NORMED_MAX_K == 2048 and not hasattr(q4k, "_scratch")
