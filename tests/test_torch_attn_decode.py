"""Port parity for the single-token decode attention (Pallas kernel 4,
`gqa_decode_attention`) and its place in the decode step.

On the CPU the port's wrapper runs its plain version; the JAX function runs
its Pallas kernel in interpret mode (it passes `interpret=` itself off the
TPU). Inputs come from a numpy seed.

Tolerances: an f32 cache within rtol 1e-5 / atol 1e-6 (the online softmax
over 256-slot tiles against one softmax over the window: f32 sums in another
order); a bf16 cache within 1e-2 of max|ref| (one bf16 rounding of the
output and of the probabilities, the bound of tests/test_pallas_attn.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.models import decoder as jdec
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.models.configs import TextDecoderConfig
from qwen3_asr_gguf_tpu.ops import pallas_attn as jattn
from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
from qwen3_asr_gguf_tpu_torch.models import decoder as tdec
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.ops import attn as tattn
from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

S, HKV, HQ, D = 1024, 2, 4, 32
SCALE = D ** -0.5
TINY = TextDecoderConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=16, intermediate_size=128)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _inputs(seed: int, dtype: str):
    """(q, k, v) as numpy f32, already rounded to `dtype`, so both packages
    get the same values."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, HQ, D), (S, HKV, D), (S, HKV, D)))
    if dtype == "bf16":
        q, k, v = (_bf16(a).float().numpy() for a in (q, k, v))
    return q, k, v


def _torch(a, dtype):
    return _bf16(a) if dtype == "bf16" else torch.from_numpy(a)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "bf16":
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("win,pos", [(256, 0), (256, 255), (512, 256), (768, 700), (1024, 1023),
                                     (1024, 5)])
def test_plain_version_vs_jax_kernel_and_decoder_attention(dtype, win, pos):
    q, k, v = _inputs(win + pos, dtype)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    before = tattn.gqa_decode_attention.launches
    got = tattn.gqa_decode_attention(tq, tk, tv, pos, SCALE, win)
    assert tattn.gqa_decode_attention.launches == before  # no launch for a CPU tensor
    assert got.shape == (1, HQ, D) and got.dtype == tq.dtype
    assert torch.equal(got, tattn.gqa_decode_attention_ref(tq, tk, tv, pos, SCALE, win))
    # the decoder's own attention on the [:win] window with the slot <= pos mask
    valid = (torch.arange(win) <= pos)[None, :]
    assert torch.equal(got, tdec._gqa_attention(tq, tk[:win], tv[:win], valid, SCALE))
    # the JAX package's kernel, in interpret mode
    assert jattn.supported((1, HQ, D), win)
    want = jattn.gqa_decode_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                                      jnp.int32(pos), SCALE, win)
    _assert_close(got.float().numpy(), want, dtype)


def test_query_is_cast_to_the_cache_dtype():
    """An f32 query over a bf16 cache is rounded to bf16 before the dot, as
    the JAX wrapper does, and the result comes back in f32."""
    q, k, v = _inputs(3, "f32")
    got = tattn.gqa_decode_attention(torch.from_numpy(q), _bf16(k), _bf16(v), 300, SCALE, 512)
    assert got.dtype == torch.float32
    want = jattn.gqa_decode_attention(jnp.asarray(q), _jax(k, "bf16"), _jax(v, "bf16"),
                                      jnp.int32(300), SCALE, 512)
    assert want.dtype == jnp.float32
    _assert_close(got.numpy(), want, "bf16")


@pytest.mark.parametrize("bad", [
    {"win": 300}, {"win": 0}, {"win": 2048}, {"pos": -1}, {"q": (2, HQ, D)}, {"q": (1, 3, D)},
    {"q": (1, HQ, D), "d": 12}, {"kdtype": torch.int8}, {"strided": True},
])
def test_cuda_argument_check_refuses(bad):
    """What the wrapper refuses on the card (the check is plain Python and
    runs here on CPU tensors): windows that are not whole 256-slot tiles or
    pass the cache, a negative position, more than one query row, heads that
    do not group, a head_dim off the 16-byte grid, an int8 cache, strides."""
    d = bad.get("d", D)
    q = torch.zeros(bad.get("q", (1, HQ, d))[:2] + (d,), dtype=torch.bfloat16)
    k = torch.zeros((S, HKV, d), dtype=bad.get("kdtype", torch.bfloat16))
    v = torch.zeros_like(k)
    if bad.get("strided"):
        k = torch.zeros((S, HKV, 2 * d), dtype=torch.bfloat16)[..., :d]
    with pytest.raises((ValueError, TypeError)):
        tattn._check_decode_args(q, k, v, bad.get("pos", 5), bad.get("win", 256))


def test_cuda_argument_check_accepts_the_decode_shapes():
    for dtype in (torch.bfloat16, torch.float32):
        k = torch.zeros((2048, 8, 128), dtype=dtype)
        for win in (256, 1024, 2048):
            tattn._check_decode_args(torch.zeros((1, 16, 128), dtype=dtype), k, k, win - 1, win)


def _numpy_params(cfg, seed):
    tree = np_init_like(tdec.init_shapes(cfg), seed)
    tree["embed"] = tree["embed"] * 50  # unit-scale activations
    return tree


@pytest.mark.parametrize("kv", ["f32", "bf16"])
def test_decode_step_through_the_wrapper_vs_jax_pallas_attn(kv, monkeypatch):
    """The port's decode step (attention through the wrapper on the full
    cache) against the JAX step with `pallas_attn=True`, from one prefilled
    cache, over a 512-slot cache and a 256-slot window. f32 KV: logits within
    atol 1e-4; bf16 KV: within 2e-2 of max|logits| (bf16 cache rounding in
    both, sums in another order)."""
    cfg, n_ctx, win = TINY, 512, 256
    tree = _numpy_params(cfg, 0)
    jp, tp = jax.tree.map(jnp.asarray, tree), tP.from_jax_params(tree)
    jp, tp = jP.fuse_layer_weights(jp), tP.fuse_layer_weights(tp)
    jdt, tdt = (jnp.float32, torch.float32) if kv == "f32" else (jnp.bfloat16, torch.bfloat16)
    jc, tc = jdec.init_cache(cfg, n_ctx, jdt), tdec.init_cache(cfg, n_ctx, tdt)
    embd = np.random.default_rng(1).standard_normal((24, cfg.hidden_size)).astype(np.float32)
    _, jc = jdec.forward_prefill(jp, cfg, jnp.asarray(embd), jc, length=20)
    _, tc = tdec.forward_prefill(tp, cfg, torch.from_numpy(embd), tc, length=20)
    jl = jdec.unstack_layers(jp["layers"], cfg.num_layers)

    calls = []
    inner = tattn.gqa_decode_attention

    def spy(q, k_full, v_full, pos, scale, w):
        calls.append((tuple(k_full.shape), pos, w))
        return inner(q, k_full, v_full, pos, scale, w)

    monkeypatch.setattr(tattn, "gqa_decode_attention", spy)
    rng = np.random.default_rng(2)
    for pos in range(20, 23):
        e = rng.standard_normal(cfg.hidden_size).astype(np.float32)
        jh, jc = jdec.forward_step_layers(jl, jp["final_norm"], cfg, jnp.asarray(e), jc,
                                          jnp.int32(pos), attn_window=win, pallas_attn=True)
        th, tc = tdec.forward_step_layers(tp["layers"], tp["final_norm"], cfg,
                                          torch.from_numpy(e), tc, pos, attn_window=win)
        want = np.asarray(jdec.lm_logits(jp, jh), np.float32)
        got = tdec.lm_logits(tp, th).numpy()
        if kv == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    # every layer of every step attended through the wrapper, on the FULL cache
    assert len(calls) == 3 * cfg.num_layers
    assert all(shape == (n_ctx, cfg.num_kv_heads, cfg.head_dim) and w == win
               for shape, _, w in calls)


def test_int8_cache_keeps_the_plain_attention(monkeypatch):
    cfg = TINY
    tp = tP.from_jax_params(_numpy_params(cfg, 0))
    cache = tdec.init_cache(cfg, 256, torch.int8)

    def boom(*a, **k):
        raise AssertionError("an int8 cache must not reach gqa_decode_attention")

    monkeypatch.setattr(tattn, "gqa_decode_attention", boom)
    e = torch.from_numpy(np.random.default_rng(0).standard_normal(cfg.hidden_size)
                         .astype(np.float32))
    h, _ = tdec.forward_step_layers(tp["layers"], tp["final_norm"], cfg, e, cache, 0,
                                    attn_window=256)
    assert torch.isfinite(h).all()


@pytest.mark.parametrize("n_ctx,slots", [(300, 512), (512, 512), (100, 256)])
def test_generator_windows_are_whole_tiles_at_any_n_ctx(n_ctx, slots, monkeypatch):
    """The Generator's cache holds round_up(n_ctx, 256) slots, and every
    decode window is whole 256-slot tiles within it, so the wrapper never
    meets a window it refuses on the card."""
    cfg = TINY
    tp = tP.fuse_layer_weights(tP.from_jax_params(_numpy_params(cfg, 0)))
    gen = Generator(tp, cfg, n_ctx=n_ctx, eos_ids=(), cache_dtype=torch.float32, block=8)
    cache = gen.new_cache()
    assert all(t.shape[0] == slots for t in cache["k"] + cache["v"])
    wins = []
    inner = tattn.gqa_decode_attention

    def spy(q, k_full, v_full, pos, scale, w):
        tattn._check_decode_args(q, k_full, v_full, pos, w)  # what the card would check
        wins.append(w)
        return inner(q, k_full, v_full, pos, scale, w)

    monkeypatch.setattr(tattn, "gqa_decode_attention", spy)
    rng = np.random.default_rng(4)
    t = n_ctx - 20
    ids, mask = np.zeros(t, np.int64), np.ones(t, bool)
    ids[-4:], mask[-4:] = [5, 6, 7, 8], False
    audio = torch.from_numpy(rng.standard_normal((t - 4, cfg.hidden_size)).astype(np.float32))
    state = gen.start_spliced(ids, mask, audio, temperature=0.0, seed=0, cache=cache)
    toks, state, finished, _ = gen.decode_block(state, 0.0)
    assert len(toks) == 8 and not finished
    toks, state, finished, _ = gen.decode_block(state, 0.0)
    assert len(toks) == 8
    toks, state, finished, _ = gen.decode_block(state, 0.0)
    assert toks == [] and finished  # pos + block > n_ctx: the context is full
    assert len(wins) == 16 * cfg.num_layers
    assert all(w % 256 == 0 and 0 < w <= slots for w in wins)
