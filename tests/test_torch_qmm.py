"""Port parity for the fused int4 dequant + matmul (`ops/qmm.py`): its plain
version against the JAX Pallas kernel run in interpret mode, as the JAX
package's own test runs it (`pl.pallas_call` patched with `interpret=True`;
nothing in the JAX package changes), against the dense oracle, and the
dispatch rule of `ops.qtensor.matmul`.

Bounds: the plain version and the interpreted kernel dequantize to the same
f32 weights and differ only in the order of the f32 sums: rtol/atol 1e-4 on
values of magnitude ~30 (K = 1024 products of unit normals).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats.quants import pack_q4_direct, unpack_q4
from qwen3_asr_gguf_tpu.ops import pallas_qmm
from qwen3_asr_gguf_tpu.ops import qtensor as jq
from qwen3_asr_gguf_tpu_torch.ops import qmm
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """The JAX kernel in Pallas interpret mode on the CPU."""
    if jax.default_backend() != "tpu":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _weights(n, k, seed):
    rng = np.random.default_rng(seed)
    p = pack_q4_direct(rng.standard_normal((n, k)).astype(np.float32))
    return jq.Q4Weight.from_packed(p), tq.Q4Weight.from_packed(p), unpack_q4(p), rng


@pytest.mark.parametrize("n,k", [(512, 1024), (256, 512)])
@pytest.mark.parametrize("t", [1, 4, 26, 52, 64])
def test_plain_version_vs_jax_interpret_kernel(t, n, k):
    jw, tw, dense, rng = _weights(n, k, 1000 * t + n)
    x = rng.standard_normal((t, k)).astype(np.float32)
    assert pallas_qmm.supported(x.shape, jw) and qmm.supported(x.shape, tw)
    want = np.asarray(pallas_qmm.q4_matmul(jnp.asarray(x), jw))
    got = qmm.q4_matmul_ref(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (t, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # and against the dense oracle x @ unpack_q4(p).T
    np.testing.assert_allclose(got.numpy(), x @ dense.T, rtol=1e-4, atol=1e-4)
    # on the CPU the wrapper is its plain version
    assert torch.equal(qmm.q4_matmul(torch.from_numpy(x), tw), got)


def test_bf16_rows_take_f32_weights_and_sums():
    """x in bf16: cast to f32 inside, f32 weights and sums, one rounding of
    the result to bf16 (the JAX wrapper's `astype(x.dtype)`): within one bf16
    step (rtol 1e-2) of the interpreted kernel."""
    jw, tw, _, rng = _weights(512, 1024, 7)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    want = pallas_qmm.q4_matmul(jnp.asarray(x).astype(jnp.bfloat16), jw)
    got = qmm.q4_matmul_ref(torch.from_numpy(x).to(torch.bfloat16), tw)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_leading_dims_flattened():
    jw, tw, dense, rng = _weights(256, 512, 3)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    got = qmm.q4_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 256)
    want = np.asarray(pallas_qmm.q4_matmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy().reshape(6, 256), x.reshape(6, 512) @ dense.T,
                               rtol=1e-4, atol=1e-4)
    one = qmm.q4_matmul(torch.from_numpy(x[0, 0]), tw)  # a bare [K] row, as lm_logits passes
    assert one.shape == (256,)
    np.testing.assert_allclose(one.numpy(), got[0, 0].numpy(), rtol=1e-5, atol=1e-5)


def _count_wrapper_calls(monkeypatch):
    calls = []
    inner = qmm.q4_matmul

    def counting(x, w):
        calls.append(tuple(x.shape))
        return inner(x, w)

    monkeypatch.setattr(qmm, "q4_matmul", counting)
    return calls


@pytest.mark.parametrize("t,n,k", [(65, 512, 1024), (3, 64, 96)])
def test_more_rows_or_an_unsupported_shape_take_dequant_then_dense(monkeypatch, t, n, k):
    """T = 65 and K = 96 (no whole groups per half) stay off the kernel in
    both packages and agree: the same dequantized weight, one f32 product."""
    jw, tw, dense, rng = _weights(n, k, t)
    x = rng.standard_normal((t, k)).astype(np.float32)
    monkeypatch.setattr(tq, "_q4_kernel_route", lambda x: True)
    calls = _count_wrapper_calls(monkeypatch)
    got = tq.matmul(torch.from_numpy(x), tw)
    assert calls == []
    assert qmm.supported(x.shape, tw) == (k % 64 == 0)
    want = np.asarray(pallas_qmm.q4_matmul(jnp.asarray(x), jw))  # the JAX fallback
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ dense.T, rtol=1e-4, atol=1e-4)
    if k % 64:
        with pytest.raises(ValueError):
            qmm.q4_matmul(torch.from_numpy(x), tw)


@pytest.mark.parametrize("t", [1, 8, 64, 65, 130])
def test_matmul_dispatch_counts_the_wrapper(monkeypatch, t):
    """With the kernel route on, at most 64 rows go through the wrapper once
    and more rows never do; with the route off (a CPU tensor) none does and
    the result is dequant + dense, which the goldens come from."""
    jw, tw, dense, rng = _weights(256, 512, 11 + t)
    x = torch.from_numpy(rng.standard_normal((t, 512)).astype(np.float32))
    calls = _count_wrapper_calls(monkeypatch)
    off = tq.matmul(x, tw)
    assert calls == [] and not tq._q4_kernel_route(x)
    assert torch.equal(off, tq.dense_matmul(x, tq.dequant_q4(tw, dtype=x.dtype)))
    monkeypatch.setattr(tq, "_q4_kernel_route", lambda x: True)
    on = tq.matmul(x, tw)
    assert calls == ([(t, 512)] if t <= 64 else [])
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-4, atol=1e-4)
    want = np.asarray(jq.matmul(jnp.asarray(x.numpy()), jw, use_pallas=True))
    np.testing.assert_allclose(on.numpy(), want, rtol=1e-4, atol=1e-4)


def test_supported_is_the_ports_own_rule():
    """Group of 32 and K a multiple of 64; neither the TPU kernel's
    N % 256 nor its 512-byte K step limit (`pick_bkh`) is carried over."""
    rng = np.random.default_rng(5)
    for n, k, tpu in ((896, 1024, False), (256, 7680, False), (512, 1024, True), (8, 64, False)):
        p = pack_q4_direct(rng.standard_normal((n, k)).astype(np.float32))
        jw, tw = jq.Q4Weight.from_packed(p), tq.Q4Weight.from_packed(p)
        assert qmm.supported((4, k), tw)
        assert pallas_qmm.supported((4, k), jw) == tpu
        x = rng.standard_normal((4, k)).astype(np.float32)
        np.testing.assert_allclose(qmm.q4_matmul_ref(torch.from_numpy(x), tw).numpy(),
                                   x @ unpack_q4(p).T, rtol=1e-4, atol=2e-4)
    p = pack_q4_direct(rng.standard_normal((8, 128)).astype(np.float32), group=64)
    assert not qmm.supported((1, 128), tq.Q4Weight.from_packed(p))  # groups of 64


def test_strided_rows_reach_the_kernel_as_dense_rows(monkeypatch):
    """On the card q4_matmul takes dense rows only (it raises on a strided
    x); the encoder's conv features are a strided view (`conv_frontend`'s
    permute and reshape), so the dispatch copies x first. Here the wrapper
    stands in the dispatch behind a check that every x it gets is
    contiguous: a strided 26-row x (a 2 s chunk's conv_out product) gives
    the result of its dense copy."""
    _, tw, _, rng = _weights(64, 512, 3)
    base = torch.from_numpy(rng.standard_normal((2, 32, 16, 13)).astype(np.float32))
    x = base.permute(0, 3, 1, 2).reshape(2, 13, 512)  # [N, C, F, T] -> [N, T, C*F], a view
    assert not x.is_contiguous()
    seen, inner = [], qmm.q4_matmul
    monkeypatch.setattr(tq, "_q4_kernel_route", lambda x: True)
    monkeypatch.setattr(qmm, "q4_matmul",
                        lambda a, w: seen.append(a.is_contiguous()) or inner(a, w))
    got = tq.matmul(x, tw)
    assert seen == [True]
    assert torch.equal(got, inner(x.contiguous(), tw))
