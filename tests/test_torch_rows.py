"""Port parity for the serving decode body: the multi-row q4_k matmul and
the int8-KV rows attention (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode, the int8 KV cache codec, the
batched decode step `forward_step_rows`, and the int8-KV engine.

Bounds: the multi-row matmul's plain version within rtol 1e-5 of the JAX
kernel (the same exact integer group dots, f32 scale sums in another
order), and bit-equal to the port's matvec row by row; the rows attention
within rtol/atol 2e-3 of the JAX kernel (the bound of the JAX package's own
kernel test: online-softmax and dot order); `_quant_kv` bit-equal; the
batched step's logits over 3 steps within 1e-4 of the JAX step on dense f32
weights, and within 1e-2 * max|logits| on q4_k weights: there an f32
activation that differs from JAX's in its last bit (another sum order
upstream) can sit on a .5 boundary of the int8 activation quantization and
move one group's int8 value by one step (seen: up to 0.3% of max|logits|).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats import quants as q
from qwen3_asr_gguf_tpu.models import decoder as jdec
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.ops import pallas_attn as jattn
from qwen3_asr_gguf_tpu.ops import pallas_q4k as pq
from qwen3_asr_gguf_tpu_torch.models import decoder as tdec
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.ops import attn as tattn
from qwen3_asr_gguf_tpu_torch.ops import q4k
from qwen3_asr_gguf_tpu_torch.ops import qtensor

from test_torch_decoder import KERNEL, _both, _numpy_params


def _packed(n, k, seed):
    rng = np.random.default_rng(seed)
    return q.pack_q4_direct((rng.standard_normal((n, k)) * 0.05).astype(np.float32))


def test_matmul_rows_plain_vs_jax_kernel():
    n, k, t = 512, 2048, 16
    p = _packed(n, k, seed=23)
    jw, tw = pq.from_packed_q4(p), q4k.from_packed_q4(p)
    x = (np.random.default_rng(29).standard_normal((t, k)) * 0.15).astype(np.float32)
    want = np.asarray(pq.q4k_matmul_rows(jnp.asarray(x), jw))
    got = q4k.q4k_matmul_rows(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i in range(t):
        row = q4k.q4k_matvec_ref(torch.from_numpy(x[i: i + 1]), tw)
        np.testing.assert_array_equal(got[i].numpy(), row[0].numpy())


@pytest.mark.parametrize("x_shape", [(8, 512), (16, 1024), (64, 512), (72, 512), (12, 512),
                                     (1, 512), (4, 512), (8, 640), (2, 8, 512), (512,)])
@pytest.mark.parametrize("n", [512, 1024, 768])
def test_supported_rows_equals_jax(x_shape, n):
    k = x_shape[-1]
    p = _packed(n, k, seed=n + k)
    jw, tw = pq.from_packed_q4(p, pad=False), q4k.from_packed_q4(p, pad=False)
    assert q4k.supported_rows(x_shape, tw) == pq.supported_rows(x_shape, jw)


def test_matmul_routes_rows_to_the_multi_row_kernel(monkeypatch):
    p = _packed(512, 512, seed=3)
    tw = q4k.from_packed_q4(p)
    calls = []
    real = q4k.q4k_matmul_rows
    monkeypatch.setattr(q4k, "q4k_matmul_rows", lambda x, w: calls.append(x.shape) or real(x, w))
    for t, via_rows in ((1, False), (8, True), (64, True), (12, False), (72, False)):
        x = torch.randn(t, 512)
        out = qtensor.matmul(x, tw)
        assert out.shape == (t, 512)
        assert bool(calls and calls[-1] == (t, 512)) == via_rows
        want = qtensor.dense_matmul(x, q4k.dequant_mxu(tw, torch.float32)) if not via_rows \
            and t != 1 else None
        if want is not None:
            torch.testing.assert_close(out, want)


@pytest.mark.parametrize("case", [((2, 8, 128), 4, 256), ((2, 8, 128), 4, 224),
                                  ((2, 8, 64), 4, 256), ((64, 16, 128), 8, 1024),
                                  ((8, 16, 128), 8, 0), ((8, 12, 128), 8, 512),
                                  ((8, 128), 8, 256), ((3, 8, 256), 4, 512)])
def test_rows_q8_supported_equals_jax(case):
    assert tattn.rows_q8_supported(*case) == jattn.rows_q8_supported(*case)


def test_quant_kv_bit_equal():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((7, 4, 128)) * rng.uniform(0.01, 3.0, (7, 4, 1))).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero head takes the 1e-8 floor
    x[1, 1, :4] = [127.5, -0.5, 1.5, 2.5]  # .5 ties round half to even
    jq, js = jdec._quant_kv(jnp.asarray(x))
    tq, ts = tdec._quant_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tdec._dequant_kv(tq, ts, dt).float().numpy()
        want = np.asarray(jdec._dequant_kv(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win_tiles", [1, 2])
def test_rows_q8_attention_plain_vs_jax_kernel(win_tiles):
    b, hq, hkv, d = 3, 8, 4, 128
    s = 2 * tattn.TS
    win = win_tiles * tattn.TS
    rng = np.random.default_rng(3)
    dense_k = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    dense_v = (rng.standard_normal((b, s, hkv, d)) * 0.3).astype(np.float32)
    qn = (rng.standard_normal((b, hq, d)) * 0.3).astype(np.float32)
    poss = np.array([5, tattn.TS - 1, win - 1])  # inside tile 0, a tile edge, the window edge
    kq, ks = jdec._quant_kv(jnp.asarray(dense_k))
    vq, vs = jdec._quant_kv(jnp.asarray(dense_v))
    want = jattn.gqa_rows_q8_attention(jnp.asarray(qn), kq, ks, vq, vs,
                                       jnp.asarray(poss, jnp.int32), d ** -0.5, win)
    t = [torch.from_numpy(np.asarray(a)) for a in (kq, ks, vq, vs)]
    got = tattn.gqa_rows_q8_attention(torch.from_numpy(qn), *t, torch.from_numpy(poss),
                                      d ** -0.5, win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def _row_caches(cfg, kv, b, s, seed):
    """The same random caches for both frameworks: JAX lists of [B, S, ...],
    port lists of torch tensors."""
    rng = np.random.default_rng(seed)
    jc = {"k": [], "v": []} if kv != "int8" else {"k": [], "v": [], "k_s": [], "v_s": []}
    for _ in range(cfg.num_layers):
        for name in ("k", "v"):
            x = (rng.standard_normal((b, s, cfg.num_kv_heads, cfg.head_dim)) * 0.5
                 ).astype(np.float32)
            if kv == "int8":
                xq, xs = jdec._quant_kv(jnp.asarray(x))
                jc[name].append(xq)
                jc[name + "_s"].append(xs)
            else:
                jc[name].append(jnp.asarray(x))
    tc = {name: [torch.from_numpy(np.array(a)) for a in arrs] for name, arrs in jc.items()}
    return jc, tc


def _as_kv(caches: dict, kv: str, framework) -> dict:
    if kv != "bf16":
        return caches
    if framework is torch:
        return {name: [a.bfloat16() for a in arrs] for name, arrs in caches.items()}
    return {name: [a.astype(jnp.bfloat16) for a in arrs] for name, arrs in caches.items()}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_step_rows_vs_jax(kv, quantize):
    """3 batched steps at kernel shapes (q4_k: every matmul on the
    multi-row kernel at B = 8; int8 KV on the rows attention at the
    256-slot window), f32 activations, from the same random caches; per-row
    positions include a row at slot 0 (an idle row) and one near the
    window's last slot."""
    jp, tp = _both(_numpy_params(KERNEL, 12), quantize=quantize)
    jp, tp = jP.fuse_layer_weights(jp), tP.fuse_layer_weights(tp)
    b, s = 8, 512
    jc, tc = _row_caches(KERNEL, "int8" if kv == "int8" else "f32", b, s, seed=13)
    jc, tc = _as_kv(jc, kv, jnp), _as_kv(tc, kv, torch)
    jl = jdec.unstack_layers(jp["layers"], KERNEL.num_layers)
    if quantize:
        assert pq.supported_rows((b, 512), jl[0]["qkv_proj"])
    poss0 = np.array([0, 5, 40, 97, 128, 200, 250, 252])
    rng = np.random.default_rng(14)
    for step in range(3):
        e = (rng.standard_normal((b, KERNEL.hidden_size)) * 0.5).astype(np.float32)
        poss = poss0 + step
        jh, jc = jdec.forward_step_rows(jl, jp["final_norm"], KERNEL, jnp.asarray(e), jc,
                                        jnp.asarray(poss, jnp.int32), attn_window=256)
        th, tc = tdec.forward_step_rows(tp["layers"], tp["final_norm"], KERNEL,
                                        torch.from_numpy(e), tc, torch.from_numpy(poss),
                                        attn_window=256)
        want = np.asarray(jdec.lm_logits(jp, jh, KERNEL.vocab_size))
        got = tdec.lm_logits(tp, th, KERNEL.vocab_size).numpy()
        atol = 1e-2 * np.abs(want).max() if quantize else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if not quantize:  # the caches the steps wrote, within one bf16 or int8 rounding step
        for l in range(KERNEL.num_layers):
            for name in tc:
                got, want = tc[name][l].float().numpy(), np.asarray(jc[name][l], np.float32)
                rtol = 2 ** -7 if kv == "bf16" else 0  # one bf16 ulp
                atol = 1 if name in ("k", "v") and kv == "int8" else 1e-5
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("win", [256, 224])
def test_int8_rows_step_always_attends_through_the_wrapper(win, monkeypatch):
    """Every layer of an int8-KV rows step calls the rows attention's
    wrapper, whatever the window: on the card it launches the kernel or
    raises, never a silent plain path. On the CPU its plain version equals
    the JAX step at the same (also unaligned) window."""
    cfg = replace(KERNEL, num_layers=2)
    jp, tp = _both(_numpy_params(cfg, 12), quantize=False)
    jp, tp = jP.fuse_layer_weights(jp), tP.fuse_layer_weights(tp)
    b = 8
    jc, tc = _row_caches(cfg, "int8", b, 256, seed=15)
    calls = []
    real = tattn.gqa_rows_q8_attention
    monkeypatch.setattr(tattn, "gqa_rows_q8_attention",
                        lambda *a: calls.append(a[-1]) or real(*a))
    e = (np.random.default_rng(16).standard_normal((b, cfg.hidden_size)) * 0.5
         ).astype(np.float32)
    poss = np.array([0, 5, 40, 97, 128, 200, 210, win - 1])
    th, _ = tdec.forward_step_rows(tp["layers"], tp["final_norm"], cfg, torch.from_numpy(e),
                                   tc, torch.from_numpy(poss), attn_window=win)
    assert calls == [win] * cfg.num_layers
    jl = jdec.unstack_layers(jp["layers"], cfg.num_layers)
    jh, _ = jdec.forward_step_rows(jl, jp["final_norm"], cfg, jnp.asarray(e), jc,
                                   jnp.asarray(poss, jnp.int32), attn_window=win)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)


def test_int8_kv_engine_greedy_tokens_equal_jax(kernel_dir):
    from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
    from qwen3_asr_gguf_tpu_torch import QwenASREngine

    from test_torch_engine import _audio, _config, _record_chunks

    cfg = _config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", "int4", kv_cache_dtype="int8")
    port = QwenASREngine(cfg, device="cpu")
    assert port.generator.new_cache()["k"][0].dtype == torch.int8
    results = []
    for engine in (JaxEngine(cfg), port):
        chunks = _record_chunks(engine)
        np.random.seed(11)
        res = engine.asr(_audio(5.5, 550.0), context="", language="English",
                         chunk_size_sec=2.0, memory_chunks=1, temperature=0.0)
        results.append((chunks, res.text, res.performance["decode_tokens"]))
    # 3 chunks: fresh prefill, 1-chunk reuse, header-only reuse, all through
    # the int8 cache (prefill writes, suffix prefill reads, decode steps)
    assert len(results[0][0]) == 3
    assert results[1] == results[0]


@pytest.fixture(scope="module")
def kernel_dir(tmp_path_factory):
    import qwen3_asr_gguf_tpu.models.configs as C
    import qwen3_asr_gguf_tpu_torch.models.configs as TC
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    from test_torch_engine import KERNEL_PRESET

    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    d = tmp_path_factory.mktemp("kernel_ckpt_rows")
    make_synthetic_checkpoint(str(d), "kernel-512", quant="q4_k", seed=0)
    return str(d)


def test_row_cache_layout():
    cfg = replace(KERNEL, num_layers=1)
    c = tdec.init_cache(cfg, 64, torch.int8, rows=3)
    assert c["k"][0].shape == (3, 64, cfg.num_kv_heads, cfg.head_dim)
    assert c["k_s"][0].shape == (3, 64, cfg.num_kv_heads) and c["k_s"][0].dtype == torch.float32
    assert set(tdec.init_cache(cfg, 64, torch.bfloat16)) == {"k", "v"}
