"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`; every test skips without a CUDA device. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bound: max|kernel - plain| <= 1e-2 * max|plain| for bf16 outputs (one bf16
rounding of differently ordered f32 sums, and at most a one-step flip of an
int8 activation where the fused norm's rsqrt rounds differently), and
1e-4 * max|plain| for f32 outputs of the unfused kernel (f32 sum order only).
The multi-row matmul is held to the matvec kernel row by row (the same
per-row math, f32 sums in another order): 1e-4 * max|matvec| on f32 outputs;
its kernel-order plain version repeats those sums, and the kernel is held to
it at 1e-5.
The decode attention: 1e-2 * max|plain| over a bf16 cache (bf16 rounding of
the probabilities and the output), 1e-4 * max|plain| over an f32 cache (the
online softmax's f32 sums in another order); against its kernel-order plain
version, which repeats its split and merges, 1e-5 over an f32 cache (the q.k
dots summed in another order). The one-launch matvec against its
kernel-order plain version: 1e-5 on f32 outputs (an fma's double rounding
at most).
The fused int4 dequant + matmul (`q4_matmul`): the group factored, x in bf16
planes on the tensor cores (an f32 x as hi + lo, dropping 2^-17 of x) and f32
sums in another order: 1e-4 * max|plain| on f32 outputs, 1e-2 on bf16 ones.
The fused int8 MLP: its integer dots are exact, so it differs from the plain
version by the ulp of expf in the logistic, which can move an act value
across a .5 boundary of the per-tile requantization: a flipped int8 changes
an output by about 1e-3 of max|plain|, so the bound is 1e-2 * max|plain| and
the number of flipped values is bounded beside it (at most 4 of M).
"""

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu_torch.formats import quants as q
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.ops import attn, mlp, q4k, qmm
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq


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
@pytest.mark.parametrize("t", [8, 16, 24, 40, 64])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 2048), (4096, 1024), (152576, 2048)])
def test_matmul_rows_every_block_width(cuda, n, k):
    """Blocks of 16, 32 and 64 channel pairs, with and without a split of K
    (`rows_tiling`): against the plain version and against the kernel-order
    plain version, which repeats the kernel's f32 sums (1e-5: the fma's
    double rounding at most)."""
    assert q4k.rows_tiling(n, k) == {2048: (16, 2), 4096: (32, 2), 152576: (64, 1)}[n]
    w = _weight(n, k, n + k, cuda)
    x = torch.randn(16, k, generator=torch.Generator().manual_seed(n)).to(cuda)
    got = q4k.q4k_matmul_rows(x, w)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, q4k.q4k_matmul_rows_ref(x, w)) <= 1e-4
    if n <= 4096:
        cpu_w = w.to("cpu")
        assert _rel_err(got.cpu(), q4k.q4k_matmul_rows_kernel_order(x.cpu(), cpu_w)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_matmul_rows_zero_row_and_large_row(cuda, dtype, bound):
    """A row of zeros (sx takes its 1e-10 floor, every int8 is 0) and a row
    of +-1e4 (every value at the +-127 clip) beside ordinary rows."""
    n, k = 2048, 2048
    w = _weight(n, k, 77, cuda)
    x = torch.randn(8, k, generator=torch.Generator().manual_seed(5))
    x[2] = 0.0
    x[5] = torch.where(x[5] > 0, 1e4, -1e4)
    x = x.to(cuda, dtype)
    got = q4k.q4k_matmul_rows(x, w)
    want = q4k.q4k_matmul_rows_ref(x, w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    for row in (0, 5):  # each row against its own scale
        assert _rel_err(got[row], want[row]) <= bound
    rows = torch.cat([q4k.q4k_matvec(x[i:i + 1], w) for i in range(8)])
    assert _rel_err(got[5], rows[5]) <= bound


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


def _q4_weight(n, k, seed, device):
    rng = np.random.default_rng(seed)
    p = q.pack_q4_direct((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    return tq.Q4Weight.from_packed(p, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k", [
    (1, 4096, 2048), (1, 2048, 2048), (1, 12288, 2048), (1, 2048, 6144), (1, 152064, 2048),
    (26, 4096, 1024), (52, 1024, 4096), (26, 1024, 1024), (13, 1024, 7680), (52, 896, 896 * 4),
    (8, 2048, 2048), (64, 2048, 6144), (3, 40, 64), (5, 24, 320), (64, 8, 128)])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_q4_matmul_vs_plain(cuda, t, n, k, dtype, bound):
    """Decode shapes of the 1.7B decoder (T = 1, the padded LM head too), the
    encoder's products at 13 to 52 rows (conv_out's K = 7680 and the 0.6B
    encoder's N = 896 included), the serving batch, and small odd shapes
    (K = 64, 320: no float4 scale loads; N below one block)."""
    w = _q4_weight(n, k, n + k + t, cuda)
    x = torch.randn(t, k, generator=torch.Generator().manual_seed(t)).to(cuda, dtype)
    before = qmm.q4_matmul.launches
    got = qmm.q4_matmul(x, w)
    assert qmm.q4_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (t, n)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, qmm.q4_matmul_ref(x, w)) <= bound
    if t == 1:  # a bare [K] row, as lm_logits passes it
        assert torch.equal(qmm.q4_matmul(x[0], w), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k", [(1, 2048, 2048), (8, 4096, 2048), (26, 1024, 1024),
                                   (52, 4096, 1024), (64, 512, 896), (5, 24, 320)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q4_matmul_vs_kernel_order_plain(cuda, t, n, k, dtype):
    """The kernel against the plain function that repeats its arithmetic
    (bf16 planes, factored groups, K slices): only the sums inside a group
    differ, so f32 outputs agree to 1e-5 of max|plain| (bf16 ones to one
    rounding, 1e-2). K = 896 and 320 end in a partial chunk."""
    w = _q4_weight(n, k, n + k + t, cuda)
    x = torch.randn(t, k, generator=torch.Generator().manual_seed(t)).to(cuda, dtype)
    got = qmm.q4_matmul(x, w)
    cpu_w = tq.Q4Weight(w.packed.cpu(), w.scale.cpu(), w.minv.cpu())
    want = qmm.q4_matmul_kernel_order(x.cpu(), cpu_w)
    assert _rel_err(got.cpu(), want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_q4_matmul_dispatch_on_the_card(cuda):
    """`matmul` sends at most 64 rows to the kernel and more rows, or a
    shape the kernel does not take, to dequant + dense."""
    w = _q4_weight(512, 1024, 3, cuda)
    for t, launches in ((1, 1), (64, 1), (65, 0)):
        x = torch.randn(t, 1024, device=cuda)
        before = qmm.q4_matmul.launches
        got = tq.matmul(x, w)
        assert qmm.q4_matmul.launches == before + launches
        assert _rel_err(got, x @ tq.dequant_q4(w, dtype=torch.float32).T) <= 1e-4
    odd = _q4_weight(64, 96, 4, cuda)
    before = qmm.q4_matmul.launches
    tq.matmul(torch.randn(3, 96, device=cuda), odd)
    assert qmm.q4_matmul.launches == before


@pytest.mark.cuda
def test_q4_matmul_raises_instead_of_falling_back(cuda):
    w = _q4_weight(512, 1024, 5, cuda)
    before = qmm.q4_matmul.launches
    with pytest.raises(ValueError):  # 65 rows
        qmm.q4_matmul(torch.randn(65, 1024, device=cuda), w)
    with pytest.raises(ValueError):  # not contiguous
        qmm.q4_matmul(torch.randn(4, 2048, device=cuda)[:, ::2], w)
    with pytest.raises(TypeError):
        qmm.q4_matmul(torch.randn(4, 1024, device=cuda, dtype=torch.float16), w)
    with pytest.raises(ValueError):  # weight on the CPU
        qmm.q4_matmul(torch.randn(4, 1024, device=cuda), _q4_weight(512, 1024, 5, "cpu"))
    with pytest.raises(ValueError):  # K = 96: no whole groups per half
        qmm.q4_matmul(torch.randn(4, 96, device=cuda), _q4_weight(64, 96, 5, cuda))
    assert qmm.q4_matmul.launches == before


def _mlp_args(m, d, seed, device):
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((m, d), (m, d), (d, m)):
        iw = tq.to_int8(torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32)))
        out += [iw.q.to(device), iw.scale.to(device)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,tile", [(2048, 6144, 512), (1024, 3072, 512), (512, 1024, 512),
                                      (256, 512, 256), (128, 1024, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_vs_plain(cuda, d, m, tile, dtype):
    args = _mlp_args(m, d, d + m, cuda)
    x = torch.randn(1, d, generator=torch.Generator().manual_seed(d)).to(cuda, dtype)
    before = mlp.fused_mlp_matvec.launches
    got = mlp.fused_mlp_matvec(x, *args, tile_m=tile)
    assert mlp.fused_mlp_matvec.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, d)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, mlp.fused_mlp_matvec_ref(x, *args, tile_m=tile)) <= 1e-2
    # the kernel's act values, requantized as the plain version does
    _, act = mlp._launch(x, *args, tile)
    kq, _ = mlp.quantize_act_tiles(act[None, :], tile)
    pq, _ = mlp.quantize_act_tiles(mlp.mlp_act_ref(x, *args[:4]), tile)
    torch.cuda.synchronize()
    assert int((kq != pq).sum()) <= 4
    assert int((kq.int() - pq.int()).abs().max()) <= 1


@pytest.mark.cuda
def test_fused_mlp_raises_instead_of_falling_back(cuda):
    args = _mlp_args(1024, 512, 1, cuda)
    x = torch.randn(1, 512, device=cuda)
    before = mlp.fused_mlp_matvec.launches
    with pytest.raises(ValueError):  # two rows
        mlp.fused_mlp_matvec(torch.randn(2, 512, device=cuda), *args)
    with pytest.raises(ValueError):  # M is no multiple of the tile
        mlp.fused_mlp_matvec(x, *args, tile_m=768)
    with pytest.raises(TypeError):
        mlp.fused_mlp_matvec(x.half(), *args)
    with pytest.raises(ValueError):  # a weight on the CPU
        mlp.fused_mlp_matvec(x, args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):  # a strided weight
        mlp.fused_mlp_matvec(x, args[0].T.contiguous().T, *args[1:])
    assert mlp.fused_mlp_matvec.launches == before


def _counters_are_zero(device) -> bool:
    torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for (dev, _), c in mlp._counters.items()
               if dev == device.index)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_calls_are_bit_identical_back_to_back(cuda, dtype):
    """Two calls on one input are bit-identical, and calls queued back to
    back with no synchronize between them (two inputs in turn) each give the
    eager result: every launch finds its counters at zero."""
    d, m = 2048, 6144
    args = _mlp_args(m, d, 5, cuda)
    xs = [torch.randn(1, d, generator=torch.Generator().manual_seed(s)).to(cuda, dtype)
          for s in (6, 7)]
    eager = []
    for x in xs:
        eager.append(mlp.fused_mlp_matvec(x, *args))
        torch.cuda.synchronize()
    assert torch.equal(mlp.fused_mlp_matvec(xs[0], *args), eager[0])
    queued = [mlp.fused_mlp_matvec(xs[i % 2], *args) for i in range(8)]
    torch.cuda.synchronize()
    for i, got in enumerate(queued):
        assert torch.equal(got, eager[i % 2]), i
    assert not torch.equal(eager[0], eager[1])
    assert _counters_are_zero(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2048, 6144), (1024, 3072)])
def test_fused_mlp_graph_replays_at_other_x(cuda, d, m):
    """One CUDA graph of two calls, captured once and replayed after x is
    overwritten with two other rows, gives the eager calls' outputs bit for
    bit (the counters are reset inside each launch)."""
    args = _mlp_args(m, d, 8, cuda)
    xs = [torch.randn(1, d, generator=torch.Generator().manual_seed(s)).to(cuda, torch.bfloat16)
          for s in (9, 10, 11)]
    x = xs[0].clone()
    mlp.fused_mlp_matvec(x, *args)  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = mlp.fused_mlp_matvec.launches
    with torch.cuda.graph(graph):
        out = mlp.fused_mlp_matvec(mlp.fused_mlp_matvec(x, *args), *args)
    assert mlp.fused_mlp_matvec.launches == before + 2  # the capture
    for new in xs[1:]:
        x.copy_(new)  # on the stream the graph replays on: ordered before it
        graph.replay()
        torch.cuda.synchronize()
        want = mlp.fused_mlp_matvec(mlp.fused_mlp_matvec(new, *args), *args)
        assert torch.equal(out, want)
    assert _counters_are_zero(cuda)


@pytest.mark.cuda
def test_fused_mlp_refuses_what_does_not_fit(cuda):
    """A shape whose Wd slab and staging exceed the shared memory of a block,
    or whose D is beyond the kernel's registers, raises before any launch;
    a grid larger than the card holds at once is refused by the cooperative
    launch and raises through `_build.check`."""
    from qwen3_asr_gguf_tpu_torch.ops import _build

    before = mlp.fused_mlp_matvec.launches
    for d, m in ((2048, 16384), (4096, 512)):
        w = torch.zeros(m, d, dtype=torch.int8, device=cuda)
        s = torch.ones(m, device=cuda)
        x = torch.randn(1, d, device=cuda)
        with pytest.raises(ValueError):
            mlp.fused_mlp_matvec(x, w, s, w, s, w.reshape(d, m), torch.ones(d, device=cuda))
    assert mlp.fused_mlp_matvec.launches == before
    d, m = 1024, 3072
    args = _mlp_args(m, d, 12, cuda)
    x = torch.randn(1, d, device=cuda)
    blocks = 16 * torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = mlp.fused_mlp_plan(m, d, mlp.TILE_M, blocks)
    act, out = torch.empty(m, device=cuda), torch.empty_like(x)
    ctr = torch.zeros(mlp.COUNTERS, dtype=torch.int32, device=cuda)
    rc = _build.lib().fused_mlp_launch(
        x.data_ptr(), 0, *(a.data_ptr() for a in args), act.data_ptr(), ctr.data_ptr(),
        out.data_ptr(), m, d, mlp.TILE_M, plan.blocks, plan.slab_rows, plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    with pytest.raises(RuntimeError):
        _build.check(rc, "fused_mlp_matvec")
    torch.cuda.synchronize()
    assert int(ctr.abs().sum()) == 0  # nothing ran


@pytest.mark.cuda
def test_int8_step_launches_the_fused_mlp_or_raises(cuda):
    """On the card an int8 decode step with `fused_mlp` runs kernel 7 once
    per layer, and raises on layers it cannot take (a fused gate|up weight)
    instead of running the unfused MLP."""
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.models.configs import TextDecoderConfig
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    cfg = TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=128, intermediate_size=1024)
    params = P.from_jax_params(np_init_like(dec.init_shapes(cfg), 0), device=cuda)
    params["layers"] = [{k: (tq.to_int8(v) if v.ndim == 2 else v) for k, v in layer.items()}
                        for layer in params["layers"]]
    params = P.fuse_layer_weights(params)
    gen = Generator(params, cfg, n_ctx=256, cache_dtype=torch.bfloat16, device=cuda)
    assert gen.fused_mlp  # None: on for CUDA weights
    cache = gen.new_cache()
    embd = torch.randn(cfg.hidden_size, generator=torch.Generator().manual_seed(9)).to(
        cuda, torch.bfloat16)
    before = mlp.fused_mlp_matvec.launches
    h, _ = dec.forward_step_layers(gen.layers_list, params["final_norm"], cfg, embd, cache, 7,
                                   attn_window=256, fused_mlp=True)
    assert mlp.fused_mlp_matvec.launches == before + cfg.num_layers
    twin = gen.new_cache()
    h_plain, _ = dec.forward_step_layers(params["layers"], params["final_norm"], cfg, embd,
                                         twin, 7, attn_window=256)
    assert mlp.fused_mlp_matvec.launches == before + cfg.num_layers
    assert _rel_err(h, h_plain) <= 5e-2  # per-tile against per-row requantization, bf16
    with pytest.raises(ValueError):
        dec.forward_step_layers(params["layers"], params["final_norm"], cfg, embd, cache, 8,
                                attn_window=256, fused_mlp=True)


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["q4_k", "int8"])
def test_rows_step_of_the_other_precisions(cuda, container):
    """The batcher's rows step (B = 8) on the `q4_k` and `int8` decoders: a
    `Q4Weight` product of 8 rows launches q4_matmul (qkv, o, gate_up and down
    of each layer), an `Int8Weight` one is `int8_matmul` (no fused MLP on
    rows); both agree with the same step on the dequantized weights."""
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.models.configs import TextDecoderConfig

    cfg = TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=128, intermediate_size=1024)
    params = P.from_jax_params(np_init_like(dec.init_shapes(cfg), 0), device=cuda)

    def quantized(v):
        if container == "int8":
            return tq.to_int8(v)
        return tq.Q4Weight.from_packed(q.pack_q4_direct(v.float().cpu().numpy()), device=cuda)

    def dense(v):
        if isinstance(v, tq.Int8Weight):
            return tq.dequant_int8(v, dtype=torch.float32)
        return tq.dequant_q4(v, dtype=torch.float32) if isinstance(v, tq.Q4Weight) else v

    layers = [{k: (quantized(v) if v.ndim == 2 else v) for k, v in layer.items()}
              for layer in params["layers"]]
    twin_layers = [{k: dense(v) for k, v in layer.items()} for layer in layers]
    fused = P.fuse_layer_weights({**params, "layers": layers})["layers"]
    twin_fused = P.fuse_layer_weights({**params, "layers": twin_layers})["layers"]
    b = 8
    embd = torch.randn(b, cfg.hidden_size, generator=torch.Generator().manual_seed(9)).to(cuda)
    poss = torch.arange(b, device=cuda) * 40
    before = (qmm.q4_matmul.launches, mlp.fused_mlp_matvec.launches)
    h, _ = dec.forward_step_rows(fused, params["final_norm"], cfg, embd,
                                 dec.init_cache(cfg, 512, torch.float32, device=cuda, rows=b),
                                 poss, attn_window=512)
    assert qmm.q4_matmul.launches == before[0] + (4 * cfg.num_layers if container == "q4_k" else 0)
    assert mlp.fused_mlp_matvec.launches == before[1]
    want, _ = dec.forward_step_rows(twin_fused, params["final_norm"], cfg, embd,
                                    dec.init_cache(cfg, 512, torch.float32, device=cuda, rows=b),
                                    poss, attn_window=512)
    assert h.shape == (b, cfg.hidden_size) and bool(torch.isfinite(h).all())
    # q4_k: f32 sums in another order; int8: the activations' int8 rounding
    assert _rel_err(h, want) <= (1e-4 if container == "q4_k" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,k", [(1, 4096, 2048), (1, 151936, 2048), (1, 2048, 6144),
                                   (520, 1024, 4096), (5, 48, 1024), (1, 50, 1024)])
def test_int8_dot_on_the_card_equals_the_f64_route(cuda, t, n, k):
    """`torch._int_mm` on zero-padded rows gives the exact integer sums, bit
    for bit the f64 route's (N = 50 is no multiple of 8 and keeps f64)."""
    g = torch.Generator().manual_seed(n + t)
    xq = torch.randint(-127, 128, (t, k), generator=g, dtype=torch.int8).to(cuda)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda)
    wq[0], xq[0] = 127, 127  # the largest sum K can give
    got = tq.int8_dot(xq, wq)
    want = torch.matmul(xq.double(), wq.double().T).float()
    torch.cuda.synchronize()
    assert got.shape == (t, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(tq.int8_dot(xq[0], wq), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (8, 1, 64), (16, 2, 128), (4, 4, 128)])
def test_decode_attention_vs_kernel_order(cuda, hq, hkv, d):
    """Over an f32 cache the kernel equals the plain version that repeats its
    split (blocks, warps, 8-slot sub-tiles) and its ordered merges to 1e-5,
    with `pos` as a device tensor at sub-tile and block edges, mid-window and
    win - 1; the int form of `pos` gives the same bits."""
    s = 2048
    g = torch.Generator().manual_seed(hq * d + hkv)
    k = torch.randn(s, hkv, d, generator=g).to(cuda)
    v = torch.randn(s, hkv, d, generator=g).to(cuda)
    q = (torch.randn(1, hq, d, generator=g) * 0.5).to(cuda)
    for win in (256, 1024, 2048):
        for pos in sorted({0, 7, 8, 15, 16, 255, 256, win // 2 + 37, win - 1}):
            pos_t = torch.tensor([pos], dtype=torch.int32, device=cuda)
            got = attn.gqa_decode_attention(q, k, v, pos_t, d ** -0.5, win)
            assert torch.equal(got, attn.gqa_decode_attention(q, k, v, pos, d ** -0.5, win))
            want = attn.gqa_decode_attention_kernel_order(q.cpu(), k.cpu(), v.cpu(), pos,
                                                          d ** -0.5, win)
            assert _rel_err(got.cpu(), want) <= 1e-5, (win, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_decode_attention_graph_replays_at_other_positions(cuda, kv_dtype, bound):
    """One CUDA graph of kernel 4, captured once inside a window, replayed
    after the device `pos` is written to three other positions of that
    window: each replay equals the plain version at its position (the grid
    depends on the window alone; the kernel reads `pos` on the device)."""
    s, hq, hkv, d, win = 2048, 16, 8, 128, 1024
    g = torch.Generator().manual_seed(21)
    k = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    v = torch.randn(s, hkv, d, generator=g).to(cuda, kv_dtype)
    q = (torch.randn(1, hq, d, generator=g) * 0.5).to(cuda, kv_dtype)
    pos_t = torch.tensor([700], dtype=torch.int32, device=cuda)
    attn.gqa_decode_attention(q, k, v, pos_t, d ** -0.5, win)  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = attn.gqa_decode_attention.launches
    with torch.cuda.graph(graph):
        out = attn.gqa_decode_attention(q, k, v, pos_t, d ** -0.5, win)
    assert attn.gqa_decode_attention.launches == before + 1  # the capture
    for pos in (700, 3, 256, win - 1):
        pos_t.fill_(pos)  # on the stream the graph replays on: ordered before it
        graph.replay()
        want = attn.gqa_decode_attention_ref(q, k, v, pos, d ** -0.5, win)
        assert _rel_err(out, want) <= bound, pos


@pytest.mark.cuda
def test_decode_attention_refuses_a_bad_pos_tensor(cuda):
    k = torch.zeros(512, 8, 128, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(1, 16, 128, device=cuda, dtype=torch.bfloat16)
    before = attn.gqa_decode_attention.launches
    for pos in (torch.tensor([3], device=cuda), torch.tensor([3], dtype=torch.int32),
                torch.tensor([3, 4], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            attn.gqa_decode_attention(q, k, k, pos, 0.1, 256)
    assert attn.gqa_decode_attention.launches == before


@pytest.mark.cuda
def test_matvec_is_one_device_launch(cuda):
    """q4k_matvec is one kernel on the device per call (the quantization is
    in its prologue), and allocates nothing but its output."""
    from torch.profiler import ProfilerActivity, profile

    w = _weight(2048, 6144, 3, cuda)
    x = _x(6144, torch.bfloat16, cuda)
    q4k.q4k_matvec(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        q4k.q4k_matvec(x, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "q4k_matvec_one_kernel" in kernels[0], kernels
    allocs = [e.name for e in prof.events() if e.name in ("aten::empty", "aten::empty_strided")]
    assert len(allocs) == 1, allocs


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 2048), (2048, 6144), (152576, 2048), (1024, 512),
                                 (4096, 12288)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_vs_kernel_order(cuda, n, k, dtype):
    """The one-launch matvec against the plain version that repeats its
    quantization and sums (1e-5 of max on f32 outputs; one bf16 rounding),
    with one tile per block (the layer shapes) and several (the LM head,
    K = 12288)."""
    w = _weight(n, k, n + k + 1, cuda)
    x = _x(k, dtype, cuda, seed=4)
    got = q4k.q4k_matvec(x, w)
    want = q4k.q4k_matvec_kernel_order(x.cpu(), w.to("cpu"))
    assert _rel_err(got.cpu(), want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_matvec_zero_row_and_large_row(cuda, dtype, bound):
    """A row of zeros (sx takes its 1e-10 floor, every int8 is 0: the output
    is exactly 0) and a row of +-1e4 (every value at the +-127 clip)."""
    n, k = 2048, 2048
    w = _weight(n, k, 78, cuda)
    zero = torch.zeros(1, k, device=cuda, dtype=dtype)
    got = q4k.q4k_matvec(zero, w)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    x = torch.randn(1, k, generator=torch.Generator().manual_seed(6))
    large = torch.where(x > 0, 1e4, -1e4).to(cuda, dtype)
    got = q4k.q4k_matvec(large, w)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, q4k.q4k_matvec_ref(large, w)) <= bound


def _kernel_engine_28(tmp_path, device, precision="int4"):
    """An engine of 28 kernel-shaped layers (the 1.7B decoder's depth: 4 x 28
    + 1 = 113 q4_k products per step) on a synthetic q4_k checkpoint."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
    from qwen3_asr_gguf_tpu_torch.models import configs as TC

    TC.PRESETS.setdefault("kernel-512-28", TC.ThinkerConfig(
        audio=TC.AudioEncoderConfig(num_mel_bins=128, d_model=64, encoder_layers=1,
                                    encoder_attention_heads=4, encoder_ffn_dim=128,
                                    downsample_hidden_size=32, output_dim=512),
        text=TC.TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=28, num_heads=4,
                                  num_kv_heads=2, head_dim=128, intermediate_size=1024)))
    make_synthetic_checkpoint(str(tmp_path), "kernel-512-28", quant="q4_k", seed=0)
    return QwenASREngine(ASREngineConfig(
        model_dir=str(tmp_path), llm_fn="qwen3_asr_llm.q4_k.gguf", precision=precision,
        chunk_size=2.0, n_ctx=512, verbose=False, max_new_tokens=12, decode_block=4),
        device=device)


@pytest.mark.cuda
def test_batcher_rounds_its_rows_to_the_rows_kernel(cuda, tmp_path):
    """`--max-batch 4` on the card: the batcher runs 8 rows, so every product
    of a batched step is the multi-row kernel (113 launches per step at 28
    layers), and it refuses more than 64 rows at construction."""
    from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher

    engine = _kernel_engine_28(tmp_path, cuda)
    with pytest.raises(ValueError, match="64"):
        ContinuousBatcher(engine, max_batch=72)
    cb = ContinuousBatcher(engine, max_batch=4, block=4)
    try:
        assert cb.b == 8 and len(cb.rows) == 4
        t = np.arange(24_000) / 16_000
        audio = (np.sin(2 * np.pi * 440 * t) * 0.3).astype(np.float32)
        before = q4k.q4k_matmul_rows.launches
        res = cb.submit(audio, language="English")
        torch.cuda.synchronize()
        launches = q4k.q4k_matmul_rows.launches - before
        steps = cb.stats["n_blocks"] * cb.block
    finally:
        cb.close()
    assert isinstance(res.text, str) and steps > 0
    assert launches == 113 * steps


_NORMED_ONE_LAUNCH_SCRIPT = """
import json, sys
sys.path.insert(0, "tests")
import torch
from torch.profiler import ProfilerActivity, profile
from qwen3_asr_gguf_tpu_torch.ops import q4k
from test_torch_cuda import _weight, _x

dev = torch.device("cuda")
w = _weight(4096, 2048, 4, dev)
x = _x(2048, torch.bfloat16, dev)
nw = torch.rand(2048, generator=torch.Generator().manual_seed(8)).to(dev) + 0.5
q4k.q4k_matvec_normed(x, w, nw, 1e-6)  # build
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI comes up; thrown away
    torch.zeros(1, device=dev).add_(1.0)
    torch.cuda.synchronize()
sessions = []
for _ in range(4):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        q4k.q4k_matvec_normed(x, w, nw, 1e-6)
        torch.cuda.synchronize()
    sessions.append({
        "kernels": [e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA],
        "allocs": [e.name for e in prof.events()
                   if e.name in ("aten::empty", "aten::empty_strided")]})
print(json.dumps(sessions))
"""


@pytest.mark.cuda
def test_matvec_normed_is_one_device_launch(cuda):
    """q4k_matvec_normed is one kernel on the device per call (the rms_norm
    and the quantization are in its prologue), and allocates nothing but its
    output. In a process of its own, one call per profiler session, as the
    fused-MLP check runs: on an H100 a session of four calls recorded 2 and 3
    of its kernels, and a one-call session late in this file's process
    none."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    w = _weight(4096, 2048, 4, cuda)
    x = _x(2048, torch.bfloat16, cuda)
    nw = torch.rand(2048, generator=torch.Generator().manual_seed(8)).to(cuda) + 0.5
    before = q4k.q4k_matvec_normed.launches
    q4k.q4k_matvec_normed(x, w, nw, 1e-6)
    assert q4k.q4k_matvec_normed.launches == before + 1
    repo = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _NORMED_ONE_LAUNCH_SCRIPT], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    sessions = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(sessions) == 4
    for session in sessions:
        kernels, allocs = session["kernels"], session["allocs"]
        assert len(kernels) == 1 and "q4k_matvec_one_kernel" in kernels[0], kernels
        assert len(allocs) == 1, allocs


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4096, 2048), (12288, 2048), (1024, 512), (512, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matvec_normed_equals_matvec_on_its_normed_row(cuda, n, k, dtype):
    """The fused-norm kernel builds the normed bf16 row in its prologue as
    `normed_row_kernel_order` does, then runs kernel 1's weight stream: its
    output equals q4k_matvec on that row bit for bit, at qkv and gate_up (and
    at K = 512, where half the warps hold no piece of the row), and the
    kernel-order plain version within 1e-5 of max on f32 outputs."""
    w = _weight(n, k, n + 3 * k, cuda)
    x = (_x(k, torch.float32, cuda, seed=k) * 3).to(dtype)
    nw = torch.rand(k, generator=torch.Generator().manual_seed(n)).to(cuda) + 0.5
    got = q4k.q4k_matvec_normed(x, w, nw, 1e-6)
    row = q4k.normed_row_kernel_order(x.cpu(), nw.cpu(), 1e-6).to(cuda, dtype)
    assert torch.equal(got, q4k.q4k_matvec(row, w))
    if dtype == torch.float32 and n <= 4096:
        want = q4k.q4k_matvec_normed_kernel_order(x.cpu(), w.to("cpu"), nw.cpu(), 1e-6)
        assert _rel_err(got.cpu(), want) <= 1e-5


def _rows_poss(b, win, device):
    """Row positions of every class: one live slot, a share of zero live
    slots for most blocks (pos 3: one sub-tile), a tile edge, win - 1,
    mid-window, and the rest spread."""
    fixed = [0, 3, 255, win - 1, win // 2 + 37]
    spread = torch.randint(0, win, (max(0, b - len(fixed)),),
                           generator=torch.Generator().manual_seed(win)).tolist()
    return torch.tensor((fixed + spread)[:b], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (12, 4, 128), (8, 1, 256), (4, 4, 128)])
def test_rows_q8_attention_vs_kernel_order(cuda, hq, hkv, d):
    """With an f32 q the rows kernel equals the plain version that repeats
    its split (cluster blocks, warps, 8-slot sub-tiles) and its ordered
    merges to 1e-5 of max (the q.k dots summed in another order), at every
    group size class and both head dims, windows 256 / 1024 / 2048."""
    b, s = 6, 2048
    k, ks, v, vs = _q8_cache(b, s, hkv, d, hq + d, cuda)
    q = (torch.randn(b, hq, d, generator=torch.Generator().manual_seed(hq)) * 0.5).to(cuda)
    for win in (256, 1024, 2048):
        poss = _rows_poss(b, win, cuda)
        got = attn.gqa_rows_q8_attention(q, k, ks, v, vs, poss, d ** -0.5, win)
        want = attn.gqa_rows_q8_attention_kernel_order(
            q.cpu(), k.cpu(), ks.cpu(), v.cpu(), vs.cpu(), poss.cpu(), d ** -0.5, win)
        assert _rel_err(got.cpu(), want) <= 1e-5, win


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_rows_q8_attention_graph_replays_at_other_positions(cuda, dtype, bound):
    """One CUDA graph of the rows kernel, captured once, replayed after the
    device `poss` is overwritten with three other sets of positions: each
    replay equals the plain version at its positions (the grid depends on B,
    Hkv and the window alone; the kernel reads `poss` on the device)."""
    b, hq, hkv, d, s, win = 8, 16, 8, 128, 2048, 1024
    k, ks, v, vs = _q8_cache(b, s, hkv, d, 31, cuda)
    q = (torch.randn(b, hq, d, generator=torch.Generator().manual_seed(32)) * 0.5).to(cuda, dtype)
    poss = _rows_poss(b, win, cuda)
    attn.gqa_rows_q8_attention(q, k, ks, v, vs, poss, d ** -0.5, win)  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = attn.gqa_rows_q8_attention.launches
    with torch.cuda.graph(graph):
        out = attn.gqa_rows_q8_attention(q, k, ks, v, vs, poss, d ** -0.5, win)
    assert attn.gqa_rows_q8_attention.launches == before + 1  # the capture
    sets = [poss.tolist(), [win - 1] * b, [0] * b, list(range(3, 3 + 127 * b, 127))]
    for new in sets:
        poss.copy_(torch.tensor(new))  # on the stream the graph replays on: ordered before it
        graph.replay()
        want = attn.gqa_rows_q8_attention_ref(q, k, ks, v, vs, poss, d ** -0.5, win)
        assert _rel_err(out, want) <= bound, new


_ONE_LAUNCH_SCRIPT = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from qwen3_asr_gguf_tpu_torch.ops import mlp

d, m = int(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda")
g = torch.Generator(device=dev)
g.manual_seed(3)
args = [t for shape in ((m, d), (m, d), (d, m)) for t in (
    torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
    torch.rand(shape[0], generator=g, device=dev) * 4e-4 + 1e-4)]
x = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
mlp.fused_mlp_matvec(x, *args)  # build, allocate the counters
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI comes up; thrown away
    torch.zeros(1, device=dev).add_(1.0)
    torch.cuda.synchronize()
sessions = []
for _ in range(2):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mlp.fused_mlp_matvec(x, *args)
        torch.cuda.synchronize()
    sessions.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA])
counters = [int(c.abs().sum()) for c in mlp._counters.values()]
print(json.dumps({"sessions": sessions, "counters": counters}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2048, 6144), (1024, 3072)])
def test_fused_mlp_is_one_device_launch(cuda, d, m):
    """fused_mlp_matvec is one kernel on the device per call (one cooperative
    launch, no second kernel for the down product), and it leaves its
    counters at zero. In a process of its own, one call per profiler session,
    as chip_smoke.py's `device_kernels` phase does: in this file's process,
    after the other tests' profiler sessions, a session may record none or
    only some of its kernels."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _ONE_LAUNCH_SCRIPT, str(d), str(m)], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    for kernels in result["sessions"]:
        assert len(kernels) == 1 and "fused_mlp_kernel" in kernels[0], kernels
    assert result["counters"] == [0]


@pytest.mark.cuda
def test_micro_batch_runs_q4_matmul_at_its_width(cuda, tmp_path, monkeypatch):
    """A q4_k engine's micro batch on the card: 5 short requests decode as one
    5-row batch, every product of a rows step is q4_matmul at 5 rows (113
    launches per step at 28 layers) plus one LM-head launch per row's
    prefill, and a MicroBatcher wider than the kernel's 64 rows is refused."""
    from qwen3_asr_gguf_tpu_torch.runtime.batched import BatchedEngine
    from qwen3_asr_gguf_tpu_torch.runtime.microbatch import MicroBatcher

    engine = _kernel_engine_28(tmp_path, cuda, precision="q4_k")
    with pytest.raises(ValueError, match="64"):
        MicroBatcher(engine, max_batch=72)
    rows, inner = [], dec.forward_step_rows
    monkeypatch.setattr(dec, "forward_step_rows",
                        lambda *a, **kw: rows.append(a[3].shape[0]) or inner(*a, **kw))
    t = np.arange(24_000) / 16_000
    be = BatchedEngine(engine, block=8)
    inputs = be.prompts([((np.sin(2 * np.pi * f * t) * 0.3).astype(np.float32), "", "English")
                         for f in (330, 440, 550, 660, 770)])
    before = qmm.q4_matmul.launches  # after the encoder's own q4_matmul products
    tokens = be.gen.generate(*inputs, temperature=0.0, max_new_tokens=12)
    torch.cuda.synchronize()
    launches = qmm.q4_matmul.launches - before
    assert rows and set(rows) == {5} and len(tokens) == 5
    assert launches == 113 * len(rows) + 5


@pytest.mark.cuda
def test_dispatched_chunk_and_block_never_wait_for_the_card(cuda, tmp_path):
    """The engine's pipelined dispatch (prefill and one block, queued with
    no wait) and a block dispatched behind it raise nothing under
    `torch.cuda.set_sync_debug_mode("error")`, greedy and sampled: no step
    of a block reads a value back from the card. Reading the block
    (`collect_block`) waits, outside that mode."""
    engine = _kernel_engine_28(tmp_path, cuda)
    gen = engine.generator
    t = np.arange(32_000) / 16_000
    chunk = torch.from_numpy((np.sin(2 * np.pi * 440 * t) * 0.3).astype(np.float32)).to(cuda)
    n_audio = engine.encoder.valid_tokens(len(t))
    feat = engine.encoder.encode(chunk)[:n_audio]
    ids, mask = engine._build_prompt_ids(n_audio, "", "", "English")
    warm = engine._dispatch_chunk(ids, mask, feat, 0.4)  # first launches load and set up
    gen.collect_block(warm["packed"])
    torch.cuda.synchronize()
    for temperature in (0.0, 0.4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = engine._dispatch_chunk(ids, mask, feat, temperature)
            _, packed = gen.decode_block_dispatch(pend["state"], temperature)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        toks, finished, _ = gen.collect_block(pend["packed"])
        assert len(toks) == gen.block or finished
        more, _, _ = gen.collect_block(packed)
        assert finished or len(more) == gen.block
