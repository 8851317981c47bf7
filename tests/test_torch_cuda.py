"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`; every test skips without a CUDA device. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bound: max|kernel - plain| <= 1e-2 * max|plain| for bf16 outputs (one bf16
rounding of differently ordered f32 sums, and at most a one-step flip of an
int8 activation where the fused norm's rsqrt rounds differently), and
1e-4 * max|plain| for f32 outputs of the unfused kernel (f32 sum order only).
The multi-row matmul is held to the matvec kernel row by row (the same
per-row math, f32 sums in another order): 1e-4 * max|matvec| on f32 outputs.
The decode attention: 1e-2 * max|plain| over a bf16 cache (bf16 rounding of
the probabilities and the output), 1e-4 * max|plain| over an f32 cache (the
online softmax's f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu_torch.formats import quants as q
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.ops import attn, q4k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _weight(n, k, seed, device):
    rng = np.random.default_rng(seed)
    p = q.pack_q4_direct((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    return q4k.from_packed_q4(p, device=device)


def _x(k, dtype, device, seed=1):
    return torch.randn(1, k, generator=torch.Generator().manual_seed(seed)).to(device, dtype)


def _rel_err(got, want):
    torch.cuda.synchronize()
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 2048), (2048, 6144), (4096, 512), (152576, 2048)])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_matvec_vs_plain(cuda, n, k, dtype, bound):
    w = _weight(n, k, n + k, cuda)
    x = _x(k, dtype, cuda)
    before = q4k.q4k_matvec.launches
    got = q4k.q4k_matvec(x, w)
    assert q4k.q4k_matvec.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, n)
    assert _rel_err(got, q4k.q4k_matvec_ref(x, w)) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4096, 2048), (12288, 2048), (1024, 512), (512, 1024)])
def test_matvec_normed_vs_plain(cuda, n, k):
    w = _weight(n, k, n + 2 * k, cuda)
    x = _x(k, torch.bfloat16, cuda, seed=2)
    nw = torch.rand(k, generator=torch.Generator().manual_seed(3)).to(cuda) + 0.5
    before = q4k.q4k_matvec_normed.launches
    got = q4k.q4k_matvec_normed(x, w, nw, 1e-6)
    assert q4k.q4k_matvec_normed.launches == before + 1
    assert _rel_err(got, q4k.q4k_matvec_normed_ref(x, w, nw, 1e-6)) <= 1e-2


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    w = _weight(512, 1024, 5, cuda)
    x = _x(2048, torch.bfloat16, cuda)[:, ::2]  # right size, not contiguous
    with pytest.raises(ValueError):
        q4k.q4k_matvec(x, w)
    with pytest.raises(ValueError):
        q4k.q4k_matvec(_x(1024, torch.bfloat16, cuda), w.to("cpu"))
    with pytest.raises(TypeError):
        q4k.q4k_matvec(_x(1024, torch.float16, cuda), w)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("n,k", [(2048, 2048), (2048, 6144), (4096, 512)])
def test_matmul_rows_each_row_equals_matvec(cuda, t, n, k):
    w = _weight(n, k, n + k + t, cuda)
    x = torch.randn(t, k, generator=torch.Generator().manual_seed(t)).to(cuda)
    before = q4k.q4k_matmul_rows.launches
    got = q4k.q4k_matmul_rows(x, w)
    assert q4k.q4k_matmul_rows.launches == before + 1
    assert got.shape == (t, n) and got.dtype == torch.float32
    rows = torch.cat([q4k.q4k_matvec(x[i:i + 1], w) for i in range(t)])
    assert _rel_err(got, rows) <= 1e-4
    assert _rel_err(q4k.q4k_matmul_rows(x.bfloat16(), w), q4k.q4k_matmul_rows_ref(
        x.bfloat16(), w)) <= 1e-2


def _q8_cache(b, s, hkv, d, seed, device):
    rng = np.random.default_rng(seed)
    k, ks = dec._quant_kv(torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)))
    v, vs = dec._quant_kv(torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)))
    return [t.to(device) for t in (k, ks, v, vs)]


@pytest.mark.cuda
@pytest.mark.parametrize("win", [256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_q8_attention_vs_plain(cuda, win, dtype):
    b, hq, hkv, d, s = 4, 16, 8, 128, 1024
    k, ks, v, vs = _q8_cache(b, s, hkv, d, win, cuda)
    q = (torch.randn(b, hq, d, generator=torch.Generator().manual_seed(win)) * 0.5).to(cuda, dtype)
    # a row inside tile 0, one at a tile edge, one at win - 1, one mid-window
    poss = torch.tensor([5, 255, win - 1, win // 2 + 3], device=cuda)
    before = attn.gqa_rows_q8_attention.launches
    got = attn.gqa_rows_q8_attention(q, k, ks, v, vs, poss, d ** -0.5, win)
    assert attn.gqa_rows_q8_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = attn.gqa_rows_q8_attention_ref(q, k, ks, v, vs, poss, d ** -0.5, win)
    assert _rel_err(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_rows_wrappers_raise_instead_of_falling_back(cuda):
    w = _weight(512, 1024, 7, cuda)
    with pytest.raises(ValueError):  # T = 12 is not a multiple of 8
        q4k.q4k_matmul_rows(torch.randn(12, 1024, device=cuda), w)
    with pytest.raises(ValueError):  # CPU weight, CUDA activations
        q4k.q4k_matmul_rows(torch.randn(8, 1024, device=cuda), w.to("cpu"))
    k, ks, v, vs = _q8_cache(2, 512, 4, 128, 1, cuda)
    q = torch.randn(2, 8, 128, device=cuda, dtype=torch.bfloat16)
    poss = torch.tensor([3, 100], device=cuda)
    with pytest.raises(ValueError):  # window not a multiple of 256
        attn.gqa_rows_q8_attention(q, k, ks, v, vs, poss, 0.1, 384)
    k64, ks64, v64, vs64 = _q8_cache(2, 512, 4, 64, 1, cuda)
    with pytest.raises(ValueError):  # head_dim 64
        attn.gqa_rows_q8_attention(q[..., :64].contiguous(), k64, ks64, v64, vs64, poss,
                                   0.1, 256)
    with pytest.raises(ValueError):  # a cache on the CPU
        attn.gqa_rows_q8_attention(q, k.cpu(), ks, v, vs, poss, 0.1, 256)


def _int8_rows_step(device, win):
    """One int8-KV rows step (B = 8) of a 2-layer decoder at kernel shapes."""
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models.configs import TextDecoderConfig
    from qwen3_asr_gguf_tpu_torch.models import params as P

    cfg = TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=128, intermediate_size=1024)
    params = P.fuse_layer_weights(
        P.from_jax_params(np_init_like(dec.init_shapes(cfg), 0), device=device))
    b = 8
    caches = dec.init_cache(cfg, 512, torch.int8, device=device, rows=b)
    embd = torch.randn(b, cfg.hidden_size, generator=torch.Generator().manual_seed(9)).to(device)
    poss = torch.arange(b, device=device) * 40
    h, _ = dec.forward_step_rows(params["layers"], params["final_norm"], cfg, embd, caches,
                                 poss, attn_window=win)
    return cfg, h


@pytest.mark.cuda
def test_int8_rows_step_launches_the_kernel_or_raises(cuda):
    """On the card an int8-KV rows step attends through the rows kernel at
    every layer, and raises on a window the kernel does not take (384 is not
    whole 256-slot tiles) instead of running the plain attention."""
    before = attn.gqa_rows_q8_attention.launches
    cfg, h = _int8_rows_step(cuda, 512)
    assert attn.gqa_rows_q8_attention.launches == before + cfg.num_layers
    assert bool(torch.isfinite(h).all())
    with pytest.raises(ValueError):
        _int8_rows_step(cuda, 384)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,q_dtype,bound", [
    (torch.bfloat16, torch.bfloat16, 1e-2), (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 1e-2), (torch.float32, torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (4, 2, 32), (8, 1, 64)])
def test_decode_attention_vs_plain(cuda, kv_dtype, q_dtype, bound, hq, hkv, d):
    s = 2048
    g = torch.Generator().manual_seed(hq + d)
    k = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    v = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    for win in (256, 1024, 2048):
        # tile 0, a tile edge, the next tile's first slot, mid-tile, win - 1
        for pos in sorted({0, 255, min(256, win - 1), win // 2 + 3, win - 1}):
            q = (torch.randn(1, hq, d, generator=g) * 0.5).to(cuda, q_dtype)
            before = attn.gqa_decode_attention.launches
            got = attn.gqa_decode_attention(q, k, v, pos, d ** -0.5, win)
            assert attn.gqa_decode_attention.launches == before + 1
            assert got.shape == q.shape and got.dtype == q_dtype
            assert bool(torch.isfinite(got).all())
            want = attn.gqa_decode_attention_ref(q, k, v, pos, d ** -0.5, win)
            assert _rel_err(got, want) <= bound, (win, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_decode_attention_past_eight_tiles(cuda, kv_dtype, bound):
    """More live tiles than a cluster has blocks (8): each block walks
    several tiles with its own online softmax before the cluster merges."""
    s, hq, hkv, d = 4096, 16, 8, 128
    g = torch.Generator().manual_seed(11)
    k = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    v = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    q = (torch.randn(1, hq, d, generator=g) * 0.5).to(cuda, kv_dtype)
    for win, pos in ((4096, 4095), (4096, 2300), (2304, 2303), (3072, 100)):
        got = attn.gqa_decode_attention(q, k, v, pos, d ** -0.5, win)
        want = attn.gqa_decode_attention_ref(q, k, v, pos, d ** -0.5, win)
        assert _rel_err(got, want) <= bound, (win, pos)


@pytest.mark.cuda
def test_decode_attention_ignores_slots_past_pos(cuda):
    """Slots after `pos` hold anything (stale tokens, NaN): the kernel never
    reads them into the result."""
    k = torch.randn(512, 8, 128, device=cuda).to(torch.bfloat16)
    v = torch.randn(512, 8, 128, device=cuda).to(torch.bfloat16)
    q = torch.randn(1, 16, 128, device=cuda).to(torch.bfloat16)
    want = attn.gqa_decode_attention(q, k, v, 300, 0.088, 512)
    k[301:], v[301:] = float("nan"), float("nan")
    got = attn.gqa_decode_attention(q, k, v, 300, 0.088, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_decode_attention_raises_instead_of_falling_back(cuda):
    k = torch.zeros(512, 8, 128, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(1, 16, 128, device=cuda, dtype=torch.bfloat16)
    before = attn.gqa_decode_attention.launches
    with pytest.raises(ValueError):  # window not a multiple of 256
        attn.gqa_decode_attention(q, k, k, 3, 0.1, 384)
    with pytest.raises(ValueError):  # window past the cache
        attn.gqa_decode_attention(q, k, k, 3, 0.1, 768)
    with pytest.raises(ValueError):  # a cache on the CPU
        attn.gqa_decode_attention(q, k.cpu(), k.cpu(), 3, 0.1, 256)
    with pytest.raises(ValueError):  # a strided cache
        attn.gqa_decode_attention(q[..., :64].contiguous(), k[:, :, :64], k[:, :, :64], 3, 0.1,
                                  256)
    with pytest.raises(TypeError):  # an int8 cache
        attn.gqa_decode_attention(q, k.to(torch.int8), k.to(torch.int8), 3, 0.1, 256)
    assert attn.gqa_decode_attention.launches == before


@pytest.mark.cuda
def test_decode_step_launches_the_attention_kernel_or_raises(cuda):
    """On the card a bf16-KV decode step attends through kernel 4 at every
    layer, and raises on a window that is not whole 256-slot tiles."""
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.models.configs import TextDecoderConfig

    cfg = TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=128, intermediate_size=1024)
    params = P.fuse_layer_weights(
        P.from_jax_params(np_init_like(dec.init_shapes(cfg), 0), device=cuda))
    cache = dec.init_cache(cfg, 512, torch.bfloat16, device=cuda)
    embd = torch.randn(cfg.hidden_size, generator=torch.Generator().manual_seed(9)).to(cuda)
    before = attn.gqa_decode_attention.launches
    h, _ = dec.forward_step_layers(params["layers"], params["final_norm"], cfg, embd, cache, 7,
                                   attn_window=256)
    assert attn.gqa_decode_attention.launches == before + cfg.num_layers
    assert bool(torch.isfinite(h).all())
    with pytest.raises(ValueError):
        dec.forward_step_layers(params["layers"], params["final_norm"], cfg, embd, cache, 8,
                                attn_window=300)
