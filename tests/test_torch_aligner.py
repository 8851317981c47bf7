"""Port parity for the forced-aligner path: the int8 matmul and loaders,
`SparseLogitsRunner`, `QwenForcedAligner` and the engine's alignment, each
against the JAX package on the CPU, with inputs from a numpy seed.

Exact where the reference is exact (int8 values, scales, argmax classes,
alignment items on f32 checkpoints, goldens); each floating-point bound is
stated at its assertion.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.ops import qtensor as jq
from qwen3_asr_gguf_tpu.runtime.aligner import QwenForcedAligner as JaxAligner
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu.runtime.generate import SparseLogitsRunner as JaxRunner
from qwen3_asr_gguf_tpu.schema import AlignerConfig, ASREngineConfig
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.formats import quants as tquants
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq
from qwen3_asr_gguf_tpu_torch.runtime.aligner import QwenForcedAligner
from qwen3_asr_gguf_tpu_torch.runtime.generate import SparseLogitsRunner

from test_torch_engine import TINY_256, _audio

GOLDEN_DIR = Path(__file__).parent / "golden"
TEXT = "hello world again and again"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# int8 matmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1024, 2048])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_vs_jax(k, dtype):
    """Activation int8s and scales bit-equal to the JAX formula; outputs
    within rtol 1e-5 in f32 (the integer sums are exact in both; the two
    scale products round alike) and equal after the bf16 cast up to one bf16
    step (rtol 1e-2)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((5, k)).astype(np.float32) * 3
    x[1] = 0.0  # an all-zero row keeps the scale floor
    w = rng.integers(-127, 128, size=(48, k)).astype(np.int8)
    w[0], x[2] = 127, np.abs(x[2]).max()  # the largest sum K can give
    scale = (rng.random(48).astype(np.float32) + 0.5) * 1e-2
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)

    xf = jx.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-10)
    want_q = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    got_q, got_sx = tq.quantize_rows_int8(tx)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_sx.numpy(), np.asarray(sx))

    want = jq.int8_matmul(jx, jq.Int8Weight(q=jnp.asarray(w), scale=jnp.asarray(scale)))
    tw = tq.Int8Weight(q=torch.from_numpy(w), scale=torch.from_numpy(scale))
    got = tq.matmul(tx, tw)  # dispatches on the container
    assert got.dtype == tx.dtype and got.shape == (5, 48)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2 if dtype == "bf16" else 1e-5, atol=0)
    # the exact integer sum, against numpy's int64
    exact = got_q.numpy().astype(np.int64) @ w.astype(np.int64).T
    y = torch.matmul(got_q.double(), tw.q.double().T)
    np.testing.assert_array_equal(y.numpy().astype(np.int64), exact)
    assert np.abs(exact).max() > 2 ** 24 or k == 1024  # past f32's exact integers at K = 2048


def test_to_int8_and_dequant_vs_jax():
    rng = np.random.default_rng(0)
    dense = (rng.standard_normal((16, 256)) * 0.05).astype(np.float32)
    dense[3] = 0.0
    packed = tquants.pack_q4_direct(dense)
    for jw, tw in ((jnp.asarray(dense), torch.from_numpy(dense)),
                   (jq.Q4Weight.from_packed(packed), tq.Q4Weight.from_packed(packed))):
        # `jq.to_int8` is jitted, and XLA's compiled amax / 127 is one ulp
        # off the IEEE quotient on some rows; op by op it is bit-equal
        with jax.disable_jit():
            want = jq.to_int8(jw)
        got = tq.to_int8(tw)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(jq.to_int8(jw).scale), rtol=2e-7)
        assert got.shape == (16, 256)
    # dequant_prefill_params on an Int8Weight: q * scale in f32, then bf16
    want_dense = jP.dequant_prefill_params({"layers": {"w": jax.tree.map(lambda a: a[None], want)}})
    got_dense = tP.dequant_prefill_params({"layers": [{"w": got}]})
    assert got_dense["layers"][0]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_dense["layers"][0]["w"].float().numpy(),
        np.asarray(want_dense["layers"]["w"][0].astype(jnp.float32)))


# --------------------------------------------------------------------------
# int8 loaders, by both routes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q4k_dir(tmp_path_factory):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("tiny-256", TINY_256)
    d = tmp_path_factory.mktemp("aligner_q4k")
    make_synthetic_checkpoint(str(d), "tiny-256", quant="q4_k", seed=0)
    make_synthetic_checkpoint(str(d), "tiny-256", quant="q4_k", aligner=True, seed=1)
    return str(d)


def _assert_same_tree(got, want, path=""):
    """Port parameter trees equal leaf by leaf, bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_same_tree(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif dataclasses.is_dataclass(want):
        assert type(got) is type(want), path
        for f in dataclasses.fields(want):
            _assert_same_tree(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("llm_fn,classes", [("qwen3_asr_llm.q4_k.gguf", None),
                                            ("qwen3_aligner_llm.q4_k.gguf", 5000)])
def test_int8_decoder_load_equals_jax_params_carried_across(q4k_dir, llm_fn, classes):
    path = os.path.join(q4k_dir, llm_fn)
    jcfg, jparams, _ = jP.load_decoder_gguf(path, precision="int8")
    tcfg, tparams, _ = tP.load_decoder_gguf(path, precision="int8")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.classify_num == classes
    assert isinstance(tparams["layers"][0]["q_proj"], tq.Int8Weight)
    assert isinstance(tparams["lm_head"], tq.Int8Weight)
    assert tparams["lm_head"].q.shape[0] == (classes or tcfg.vocab_size)
    assert tparams["embed"].dtype == torch.bfloat16
    _assert_same_tree(tparams, tP.from_jax_params(_np(jparams)))
    # and fused, as the aligner holds them
    _assert_same_tree(tP.fuse_layer_weights(tparams),
                      tP.from_jax_params(_np(jP.fuse_layer_weights(jparams))))


@pytest.mark.parametrize("precision,dtype", [("f32", torch.float32), ("bf16", torch.bfloat16)])
def test_dense_aligner_decoder_load(q4k_dir, precision, dtype):
    path = os.path.join(q4k_dir, "qwen3_aligner_llm.q4_k.gguf")
    jcfg, jparams, _ = jP.load_decoder_gguf(path, precision=precision)
    tcfg, tparams, _ = tP.load_decoder_gguf(path, precision=precision)
    assert tcfg.classify_num == jcfg.classify_num == 5000
    assert tparams["lm_head"].shape == (5000, tcfg.hidden_size)
    assert tparams["lm_head"].dtype == dtype
    _assert_same_tree(tparams, tP.from_jax_params(_np(jparams)))


def test_int8_encoder_load_equals_jax_params_carried_across(q4k_dir):
    path = os.path.join(q4k_dir, "qwen3_aligner_encoder.safetensors")
    jcfg, jparams = jP.load_encoder_quantized(path, kind="int8")
    tcfg, tparams = tP.load_encoder_quantized(path, kind="int8")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert isinstance(tparams["proj1_w"], tq.Int8Weight)
    assert isinstance(tparams["layers"][0]["fc1_w"], tq.Int8Weight)
    _assert_same_tree(tparams, tP.from_jax_params(_np(jparams)))
    with pytest.raises(ValueError):
        tP.load_encoder_quantized(path, kind="int3")


# --------------------------------------------------------------------------
# SparseLogitsRunner
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_dir(tmp_path_factory):
    """The checkpoints of tests/test_golden.py."""
    d = tmp_path_factory.mktemp("aligner_f32")
    make_synthetic_checkpoint(str(d), "tiny", quant="f16", seed=0)
    make_synthetic_checkpoint(str(d), "tiny", quant="f16", aligner=True, seed=1)
    return str(d)


def _align_config(model_dir, llm_fn, precision):
    return AlignerConfig(model_dir=model_dir, llm_fn=llm_fn, precision=precision, n_ctx=512)


def test_sparse_logits_runner_vs_jax(f32_dir):
    """`logits_at` within atol 1e-4 of the JAX runner on the f32 `tiny`
    aligner (f32 sums in another order), `argmax_at` equal."""
    path = os.path.join(f32_dir, "qwen3_aligner_llm.f16.gguf")
    jcfg, jparams, _ = jP.load_decoder_gguf(path, precision="f32")
    tcfg, tparams, _ = tP.load_decoder_gguf(path, precision="f32")
    jrun = JaxRunner(jP.fuse_layer_weights(jparams), jcfg, n_ctx=512)
    trun = SparseLogitsRunner(tP.fuse_layer_weights(tparams), tcfg, n_ctx=512, device="cpu")
    assert trun._prompt_pad(40) == jrun._prompt_pad(40) == 256
    assert trun._prompt_pad(500) == jrun._prompt_pad(500) == 512
    rng = np.random.default_rng(5)
    t, n_audio = 40, 17
    embd = rng.standard_normal((t, tcfg.hidden_size)).astype(np.float32)
    positions = np.asarray([21, 22, 30, 31, 38, 39], np.int32)
    want = jrun.logits_at(embd, positions)
    got = trun.logits_at(embd, positions)
    assert got.shape == want.shape == (6, 5000) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.array_equal(got[:, :4000].argmax(1), want[:, :4000].argmax(1))

    ids = rng.integers(0, tcfg.vocab_size, size=t).astype(np.int32)
    mask = np.zeros(t, bool)
    mask[1: 1 + n_audio] = True
    audio = rng.standard_normal((32, tcfg.hidden_size)).astype(np.float32)  # bucket-shaped
    want_ts = jrun.argmax_at(ids, mask, jnp.asarray(audio), positions, 4000)
    got_ts = trun.argmax_at(ids, mask, torch.from_numpy(audio), positions, 4000)
    assert got_ts.dtype == np.int32
    np.testing.assert_array_equal(got_ts, want_ts)


def test_padded_query_rows_stay_finite(f32_dir):
    """Rows past `length` see only masked keys beyond their own causal span;
    the -1e30 mask (not -inf) keeps every row of the padded prefill finite."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as tdec

    path = os.path.join(f32_dir, "qwen3_aligner_llm.f16.gguf")
    cfg, params, _ = tP.load_decoder_gguf(path, precision="f32")
    embd = torch.zeros((256, cfg.hidden_size))
    embd[:3] = 1.0
    hidden, _ = tdec.forward_prefill(params, cfg, embd, None, length=3)
    assert torch.isfinite(hidden).all()


# --------------------------------------------------------------------------
# QwenForcedAligner
# --------------------------------------------------------------------------


def _items(res):
    return [(it.text, it.start_time, it.end_time) for it in res.items]


def test_aligner_equals_jax_on_f32(f32_dir):
    cfg = _align_config(f32_dir, "qwen3_aligner_llm.f16.gguf", "f32")
    jal, tal = JaxAligner(cfg), QwenForcedAligner(cfg, device="cpu")
    for audio, text, lang, off in ((_audio(1.2, 660.0), "hello world again", "English", 0.5),
                                   (_audio(2.0, 330.0), "今天天气很好，我们去公园。", "Chinese", 2.0),
                                   (_audio(0.7, 500.0), "。，", "Chinese", 0.0)):
        want = jal.align(audio, text, language=lang, offset_sec=off)
        got = tal.align(audio, text, language=lang, offset_sec=off)
        assert _items(got) == _items(want)  # same classes, same float arithmetic
        assert set(got.performance) == {"encoder_time", "decoder_time", "total_time"}


def test_aligner_reproduces_golden(f32_dir):
    tal = QwenForcedAligner(_align_config(f32_dir, "qwen3_aligner_llm.f16.gguf", "f32"),
                            device="cpu")
    ares = tal.align(_audio(1.2, 660.0), "hello world again", language="English", offset_sec=0.5)
    got = {"items": [{"text": it.text, "start": round(it.start_time, 3),
                      "end": round(it.end_time, 3)} for it in ares.items]}
    assert got == json.loads((GOLDEN_DIR / "aligner.json").read_text())


def test_int8_aligner_keeps_containers_on_the_cpu_and_equals_jax(q4k_dir):
    """Off the card the aligner keeps its `Int8Weight` layers, as the JAX
    package does off the TPU; the int8 path is exact up to f32 rounding, so
    the timestamp classes and the items are equal."""
    cfg = _align_config(q4k_dir, "qwen3_aligner_llm.q4_k.gguf", "int8")
    jal, tal = JaxAligner(cfg), QwenForcedAligner(cfg, device="cpu")
    assert isinstance(tal.runner.params["layers"][0]["qkv_proj"], tq.Int8Weight)
    assert isinstance(tal.encoder.params["proj1_w"], tq.Int8Weight)
    want = jal.align(_audio(1.5, 440.0), TEXT, language="English", offset_sec=1.0)
    got = tal.align(_audio(1.5, 440.0), TEXT, language="English", offset_sec=1.0)
    assert _items(got) == _items(want)


def test_dense_bf16_aligner_branch_vs_jax_with_explicit_dequant(q4k_dir):
    """The branch the card takes (`dense_prefill=True`: int8 layers
    dequantized once to dense bf16) against the JAX aligner with
    `dequant_prefill_params` applied explicitly (what it does on the TPU).
    Weights bit-equal; the sparse logits of one prompt within 2e-2 of
    max|logits| (bf16 activations round at other places in the two
    frameworks) with cosine >= 0.999 per row."""
    cfg = _align_config(q4k_dir, "qwen3_aligner_llm.q4_k.gguf", "int8")
    jal = JaxAligner(cfg)
    jal.runner.params = jP.dequant_prefill_params(jal.runner.params)
    tal = QwenForcedAligner(cfg, device="cpu", dense_prefill=True)
    layer = tal.runner.params["layers"][0]
    assert layer["qkv_proj"].dtype == torch.bfloat16 and layer["down_proj"].dtype == torch.bfloat16
    assert isinstance(tal.runner.params["lm_head"], tq.Int8Weight)  # the head stays int8
    _assert_same_tree(tal.runner.params, tP.from_jax_params(_np(jal.runner.params)))

    audio = _audio(1.5, 440.0)
    words = TEXT.split()
    n_audio = tal.encoder.valid_tokens(len(audio))
    ids, mask, positions = tal._prompt(words, n_audio)
    assert len(positions) == 2 * len(words)
    audio_embd = np.asarray(jal.encoder.encode_async(audio).astype(jnp.float32))
    np.testing.assert_allclose(tal.encoder.encode(audio).float().numpy(), audio_embd,
                               rtol=0, atol=1e-4)  # int8 encoder in f32 on the CPU
    embd = np.asarray(jax.tree.map(np.asarray, jal.runner.params)["embed"].astype(np.float32))[ids]
    embd[mask] = audio_embd[:n_audio]
    want = jal.runner.logits_at(embd.astype(jnp.bfloat16), positions)
    got = tal.runner.logits_at(embd, positions)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999
    res = tal.align(audio, TEXT, language="English", offset_sec=0.0)
    assert [it.text for it in res.items if it.text.strip()] == words
    assert all(it.start_time <= it.end_time for it in res.items)


# --------------------------------------------------------------------------
# the engine's alignment
# --------------------------------------------------------------------------


def _engine_config(model_dir):
    """The configuration of tests/test_golden.py."""
    return ASREngineConfig(
        model_dir=model_dir, llm_fn="qwen3_asr_llm.f16.gguf", precision="f32", chunk_size=2.0,
        n_ctx=512, verbose=False, max_new_tokens=16, decode_block=8, enable_aligner=True,
        align_config=_align_config(model_dir, "qwen3_aligner_llm.f16.gguf", "f32"))


@pytest.fixture(scope="module")
def engines(f32_dir):
    return JaxEngine(_engine_config(f32_dir)), QwenASREngine(_engine_config(f32_dir), device="cpu")


def test_engine_alignment_equals_jax_on_two_chunks(engines):
    """A 3.5 s clip in 2 s chunks: chunk 1's window starts where chunk 0's
    last item ended (the overlap-aware offset), so equal items pin the
    window logic, the rollback-trimmed text and the final sort."""
    jeng, teng = engines
    audio = _audio(3.5, 550.0)
    np.random.seed(11)
    want = jeng.asr(audio, context="", language="English", chunk_size_sec=2.0,
                    memory_chunks=1, temperature=0.0)
    np.random.seed(11)
    got = teng.asr(audio, context="", language="English", chunk_size_sec=2.0,
                   memory_chunks=1, temperature=0.0)
    assert got.text == want.text
    assert want.alignment is not None and got.alignment is not None
    assert len(got.alignment.items) == len(want.alignment.items)
    for g, w in zip(got.alignment.items, want.alignment.items):
        assert g.text == w.text
        assert abs(g.start_time - w.start_time) <= 1e-6 and abs(g.end_time - w.end_time) <= 1e-6
    starts = [it.start_time for it in got.alignment.items]
    assert starts == sorted(starts)
    assert got.performance["align_dec_time"] > 0 and got.performance["align_enc_time"] > 0
    golden = json.loads((GOLDEN_DIR / "engine_transcribe.json").read_text())
    assert len(got.alignment.items) == golden["n_align_items"]
    assert got.text == golden["text"]
    assert got.performance["decode_tokens"] == golden["decode_tokens"]


def test_engine_alignment_with_detected_language(engines):
    jeng, teng = engines
    audio = _audio(2.5, 440.0)
    np.random.seed(3)
    want = jeng.asr(audio, context="", language=None, chunk_size_sec=2.0, temperature=0.0,
                    detect_language=True)
    np.random.seed(3)
    got = teng.asr(audio, context="", language=None, chunk_size_sec=2.0, temperature=0.0,
                   detect_language=True)
    assert got.text == want.text and got.language == want.language
    assert _items(got.alignment) == _items(want.alignment) if want.alignment else not got.alignment


def test_a_failing_chunk_alignment_is_logged_and_skipped(engines, monkeypatch, caplog):
    """One chunk's failed alignment degrades that chunk to no items and the
    call still returns the other chunk's items and the whole text."""
    _, teng = engines
    inner, calls = teng.aligner.align, []

    def flaky(audio, text, **kw):
        calls.append(kw["offset_sec"])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return inner(audio, text, **kw)

    monkeypatch.setattr(teng.aligner, "align", flaky)
    np.random.seed(11)
    with caplog.at_level("WARNING"):
        res = teng.asr(_audio(3.5, 550.0), context="", language="English", chunk_size_sec=2.0,
                       memory_chunks=1, temperature=0.0)
    assert len(calls) == 2 and calls == [0.0, 2.0]  # no items for chunk 0: its own start
    assert "forced alignment failed for chunk 0" in caplog.text
    assert res.alignment is not None and 0 < len(res.alignment.items)
    assert all(it.start_time >= 2.0 for it in res.alignment.items)
    assert res.text


def test_engine_without_aligner_returns_no_alignment(f32_dir):
    cfg = _engine_config(f32_dir)
    cfg.enable_aligner = False
    eng = QwenASREngine(cfg, device="cpu")
    assert eng.aligner is None
    res = eng.asr(_audio(1.0, 440.0), context="", language="English", chunk_size_sec=2.0,
                  temperature=0.0)
    assert res.alignment is None and res.performance["align_dec_time"] == 0.0
