"""Port parity: decoder prefill, suffix prefill on a reused cache and the
decode step of qwen3_asr_gguf_tpu_torch/models/decoder.py against the JAX
package, on the same weights (carried across with `from_jax_params`) and
the same inputs. f32 throughout; bound: |logits - JAX| <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats.quants import pack_q4_direct
from qwen3_asr_gguf_tpu.models import decoder as jdec
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.models.configs import TextDecoderConfig
from qwen3_asr_gguf_tpu.ops import pallas_q4k as pq
from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
from qwen3_asr_gguf_tpu_torch.models import decoder as tdec
from qwen3_asr_gguf_tpu_torch.models import params as tP

ATOL = 1e-4
N_CTX = 128

DENSE = TextDecoderConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=16, intermediate_size=128)
# every decode matvec on the q4_k kernels: K % 512 == 0, N % 512 == 0
KERNEL = TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=128, intermediate_size=1024)


def _numpy_params(cfg, seed):
    tree = np_init_like(tdec.init_shapes(cfg), seed)
    rng = np.random.default_rng(seed + 100)
    for name in ("attn_norm", "q_norm", "k_norm", "mlp_norm"):  # not all ones
        tree["layers"][name] = (tree["layers"][name]
                                * (1 + 0.1 * rng.standard_normal(tree["layers"][name].shape))
                                ).astype(np.float32)
    tree["embed"] = tree["embed"] * 50  # unit-scale activations
    return tree


def _both(tree, quantize=False):
    """(JAX params, port params) for one numpy tree; `quantize` packs every
    matrix (and the head) into the q4_k matvec layout."""
    if quantize:
        tree = dict(tree, layers=dict(tree["layers"]))
        for name in jP._QUANTIZABLE:
            parts = [pq.pack_q4k_mxu(pack_q4_direct(w)) for w in tree["layers"][name]]
            tree["layers"][name] = pq.Q4KMXUWeight(*(np.stack(p) for p in zip(*parts)))
        tree["lm_head"] = pq.Q4KMXUWeight(*pq.pad_rows(*pq.pack_q4k_mxu(
            pack_q4_direct(tree["lm_head"]))))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, tP.from_jax_params(tree)


def _cache_pair(cfg):
    return jdec.init_cache(cfg, N_CTX, jnp.float32), tdec.init_cache(cfg, N_CTX, torch.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def dense():
    return _both(_numpy_params(DENSE, 0))


def _prefill(jp, tp, cfg, t, length, seed):
    embd = np.random.default_rng(seed).standard_normal((t, cfg.hidden_size)).astype(np.float32)
    jc, tc = _cache_pair(cfg)
    jh, jc = jdec.forward_prefill(jp, cfg, jnp.asarray(embd), jc, length=length)
    th, tc = tdec.forward_prefill(tp, cfg, torch.from_numpy(embd), tc, length=length)
    return jh, jc, th, tc


def test_prefill_logits_and_cache(dense):
    jp, tp = dense
    jh, jc, th, tc = _prefill(jp, tp, DENSE, 24, 20, seed=1)
    _close(tdec.lm_logits(tp, th)[:20], jdec.lm_logits(jp, jh)[:20])
    for l in range(DENSE.num_layers):
        _close(tc["k"][l][:20], jc["k"][l][:20])
        _close(tc["v"][l][:20], jc["v"][l][:20])


def test_prefill_at_on_reused_prefix(dense):
    jp, tp = dense
    _, jc, _, tc = _prefill(jp, tp, DENSE, 24, 20, seed=2)
    embd = np.random.default_rng(3).standard_normal((8, DENSE.hidden_size)).astype(np.float32)
    jh, jc = jdec.forward_prefill_at(jp, DENSE, jnp.asarray(embd), jc, jnp.int32(20),
                                     prefix_window=64, length=6)
    th, tc = tdec.forward_prefill_at(tp, DENSE, torch.from_numpy(embd), tc, 20,
                                     prefix_window=64, length=6)
    _close(tdec.lm_logits(tp, th)[:6], jdec.lm_logits(jp, jh)[:6])
    for l in range(DENSE.num_layers):
        _close(tc["k"][l][:26], jc["k"][l][:26])


@pytest.mark.parametrize("fused", [False, True])
def test_decode_steps(dense, fused):
    jp, tp = dense
    if fused:
        jp, tp = jP.fuse_layer_weights(jp), tP.fuse_layer_weights(tp)
    _, jc, _, tc = _prefill(jp, tp, DENSE, 24, 20, seed=4)
    jl = jdec.unstack_layers(jp["layers"], DENSE.num_layers)
    rng = np.random.default_rng(5)
    for pos in range(20, 24):  # write-then-attend over stale padded slots
        e = rng.standard_normal(DENSE.hidden_size).astype(np.float32)
        jh, jc = jdec.forward_step_layers(jl, jp["final_norm"], DENSE, jnp.asarray(e), jc,
                                          jnp.int32(pos), attn_window=64)
        th, tc = tdec.forward_step_layers(tp["layers"], tp["final_norm"], DENSE,
                                          torch.from_numpy(e), tc, pos, attn_window=64)
        _close(tdec.lm_logits(tp, th), jdec.lm_logits(jp, jh))


def test_decode_steps_int4_kernels():
    """At kernel shapes every decode matvec reaches the q4_k kernels (JAX:
    Pallas interpret mode; port: their plain versions on the CPU)."""
    jp, tp = _both(_numpy_params(KERNEL, 6), quantize=True)
    jp, tp = jP.fuse_layer_weights(jp), tP.fuse_layer_weights(tp)
    assert pq.supported_normed((1, 512), jax.tree.map(lambda a: a[0], jp["layers"]["qkv_proj"]))
    jc, tc = _cache_pair(KERNEL)
    jl = jdec.unstack_layers(jp["layers"], KERNEL.num_layers)
    rng = np.random.default_rng(7)
    for pos in range(3):
        e = rng.standard_normal(KERNEL.hidden_size).astype(np.float32)
        jh, jc = jdec.forward_step_layers(jl, jp["final_norm"], KERNEL, jnp.asarray(e), jc,
                                          jnp.int32(pos), attn_window=128)
        th, tc = tdec.forward_step_layers(tp["layers"], tp["final_norm"], KERNEL,
                                          torch.from_numpy(e), tc, pos, attn_window=128)
        want = jdec.lm_logits(jp, jh, KERNEL.vocab_size)
        got = tdec.lm_logits(tp, th, KERNEL.vocab_size)
        assert got.shape == (KERNEL.vocab_size,)
        _close(got, want)


def test_splice_prompt_and_embed(dense):
    jp, tp = dense
    ids = np.array([3, 0, 0, 0, 7, 9], np.int32)
    mask = np.array([0, 1, 1, 1, 0, 0], bool)
    audio = np.random.default_rng(8).standard_normal((5, DENSE.hidden_size)).astype(np.float32)
    want = jdec.splice_prompt(jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(audio))
    got = tdec.splice_prompt(tp, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                             torch.from_numpy(audio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rope_and_norm_primitives():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.array([0, 1, 7, 300, 2047], np.int32)
    jc, js = jdec.rope_cos_sin(jnp.asarray(pos), 16, 5e6)
    tc, ts = tdec.rope_cos_sin(torch.from_numpy(pos), 16, 5e6)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    _close(tdec.apply_rope(torch.from_numpy(x), tc, ts), jdec.apply_rope(jnp.asarray(x), jc, js),
           1e-5)
    _close(tdec.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jdec.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-5)
