"""Port parity for micro-batching: the port's `BatchedGenerator`,
`BatchedEngine` and `MicroBatcher` on the CPU against the port's engine, the
JAX engine and the JAX package's own `BatchedEngine`, greedy.

On the f32 `tiny` engine a batched row computes the engine's own numbers
(each row prefills at the engine's prompt bucket, and the rows step's
products are the single-token step's, row by row), so every greedy text and
token must equal both engines exactly. `max_new_tokens` stays below the
engine's 16-token repetition-breaker window, whose retries sample with each
framework's own random numbers. Inputs of one 2 s chunk or less are batched;
a 3.5 s input goes through `engine.asr`.
"""

import threading
import time

import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.runtime.batched import BatchedEngine as JaxBatchedEngine
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq
from qwen3_asr_gguf_tpu_torch.runtime.batched import BatchedEngine, BatchedGenerator
from qwen3_asr_gguf_tpu_torch.runtime.microbatch import MicroBatcher, _Pending

from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import KERNEL_PRESET, _audio, _config

NEW_TOKENS = 12  # below the breaker's 16-token window
SHORT = [(1.0, 330.0), (1.5, 550.0), (2.0, 770.0)]  # one 2 s chunk or less


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(port engine, JAX engine) of one f32 tiny checkpoint."""
    d = str(tmp_path_factory.mktemp("batched_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16", seed=0)
    cfg = _config(d, "qwen3_asr_llm.f16.gguf", "f32")
    cfg.max_new_tokens = NEW_TOKENS
    return QwenASREngine(cfg, device="cpu"), JaxEngine(cfg)


def _engine_text(engine, audio, language="English"):
    return engine.asr(audio, context="", language=language, chunk_size_sec=2.0,
                      memory_chunks=1, temperature=0.0).text


def test_batched_engine_equals_both_engines_and_jax_batched(tiny):
    """Three short inputs decode as one batch and a 3.5 s input goes through
    `engine.asr`; every text equals the port's engine, the JAX engine and
    the JAX package's BatchedEngine."""
    port, jax_engine = tiny
    audios = [_audio(s, f) for s, f in SHORT] + [_audio(3.5, 440.0)]
    got = BatchedEngine(port, block=8).transcribe_batch(audios, language="English")
    want = JaxBatchedEngine(jax_engine, block=8).transcribe_batch(audios, language="English")
    for audio, g, w in zip(audios, got, want):
        assert g.text == w.text == _engine_text(port, audio) == _engine_text(jax_engine, audio)
        assert g.text
    assert [bool(r.performance.get("batched")) for r in got] == [True, True, True, False]
    assert got[0].performance["n_generate"] == NEW_TOKENS
    assert got[0].performance["batch_audio_s"] == 8.0


def _jax_prompts(engine, requests, chunk):
    """The JAX BatchedEngine's prompt inputs (its transcribe_batch body)."""
    ids_list, mask_list, embds = [], [], []
    for audio, context, language in requests:
        n_valid = engine.encoder.valid_tokens(len(audio))
        padded = np.pad(audio, (0, chunk - len(audio)))
        embds.append(engine.encoder.encode_async(padded)[: engine.encoder.valid_tokens(chunk)])
        ids, mask = engine._build_prompt_ids(n_valid, "", context, language)
        ids_list.append(ids)
        mask_list.append(mask)
    return ids_list, mask_list, embds


def test_generator_tokens_equal_the_jax_generator(tiny):
    """Token rows of one batch against the JAX BatchedGenerator's on the same
    prompts: the same ids and masks, and the same tokens per row."""
    port, jax_engine = tiny
    requests = [(_audio(s, f), "", "English") for s, f in SHORT]
    be, jbe = BatchedEngine(port, block=8), JaxBatchedEngine(jax_engine, block=8)
    ids, masks, embds = be.prompts(requests)
    j_ids, j_masks, j_embds = _jax_prompts(jax_engine, requests, be.chunk_samples)
    for a, b in zip(ids + masks, j_ids + j_masks):
        np.testing.assert_array_equal(a, b)
    for e, je in zip(embds, j_embds):  # f32 encoders, summed in other orders
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0, atol=1e-5)
    got = be.gen.generate(ids, masks, embds, temperature=0.0, max_new_tokens=NEW_TOKENS)
    want = jbe.gen.generate(j_ids, j_masks, j_embds, temperature=0.0,
                            max_new_tokens=NEW_TOKENS)
    assert got == want
    assert all(len(row) == NEW_TOKENS for row in got)


def test_idle_rows_of_a_rounded_width_change_nothing(tiny, monkeypatch):
    """A width rounded up to the kernels' row tiles (on the card, 8 rows for
    the int4 weights) runs the extra rows idle and latched done: the real
    rows' tokens are the same as at the batch's own width."""
    port, _ = tiny
    be = BatchedEngine(port, block=4)
    inputs = be.prompts([(_audio(s, f), "", "English") for s, f in SHORT])
    want = be.gen.generate(*inputs, temperature=0.0, max_new_tokens=NEW_TOKENS)
    monkeypatch.setattr(be.gen, "rows", lambda b: 8)
    assert be.gen.generate(*inputs, temperature=0.0, max_new_tokens=NEW_TOKENS) == want


def test_context_full_stops_the_batch(tiny):
    """The n_ctx stop rule: no block starts past n_ctx - block, so a long
    max_new_tokens ends with the context."""
    port, _ = tiny
    be = BatchedEngine(port, block=8)
    inputs = be.prompts([(_audio(1.0, 330.0), "", "English")])
    gen = BatchedGenerator(be.gen.params, port.dec_cfg, n_ctx=96, eos_ids=(-1,), block=8,
                           cache_dtype=torch.float32, device="cpu")
    t = len(inputs[0][0])
    rows = gen.generate(*inputs, temperature=0.0, max_new_tokens=1000)
    assert len(rows[0]) == (96 - t) // 8 * 8


@pytest.fixture(scope="module")
def kernel_dir(tmp_path_factory):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    d = tmp_path_factory.mktemp("batched_kernel_ckpt")
    make_synthetic_checkpoint(str(d), "kernel-512", quant="q4_k", seed=1)
    return str(d)


@pytest.mark.parametrize("precision,container", [("int8", tq.Int8Weight),
                                                  ("q4_k", tq.Q4Weight)])
def test_quantized_engines_batch_on_their_prefill_weights(kernel_dir, precision, container):
    """At int8 and q4_k the batch decodes on the engine's own containers
    (`prefill_params`: `Int8Weight` rows through int8_matmul, `Q4Weight`
    rows through dequant + dense on the CPU and q4_matmul on the card), and
    its greedy text equals the engine's on full 2 s chunks."""
    cfg = _config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", precision)
    cfg.max_new_tokens = 8
    engine = QwenASREngine(cfg, device="cpu")
    be = BatchedEngine(engine, block=8)
    assert isinstance(be.gen.params["layers"][0]["qkv_proj"], container)
    audios = [_audio(2.0, f) for f in (440.0, 550.0)]
    got = be.transcribe_batch(audios, language="English")
    for audio, res in zip(audios, got):
        assert res.text and res.text == _engine_text(engine, audio)


def test_width_is_rounded_or_refused_by_the_kernels(kernel_dir):
    """On the card a batch of `Q4KWeight` products rounds up to whole 8-row
    tiles and a `Q4Weight` batch above 64 rows is refused (the kernels' row
    sets, `qtensor.kernel_rows`); the CPU takes any width."""
    engine = QwenASREngine(_config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", "int4"), device="cpu")
    gen = engine.generator
    int4 = BatchedGenerator(gen.params, engine.dec_cfg, n_ctx=512, eos_ids=(0,), device="cpu")
    assert int4.rows(5) == 5
    int4.device = torch.device("cuda")  # the rule only; nothing is launched
    assert int4.rows(5) == 8 and int4.rows(64) == 64
    with pytest.raises(ValueError, match="64"):
        int4.rows(65)
    q4 = QwenASREngine(_config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", "q4_k"), device="cpu")
    qgen = BatchedGenerator(q4.generator.prefill_params, q4.dec_cfg, n_ctx=512, eos_ids=(0,),
                            device="cpu")
    qgen.device = torch.device("cuda")
    assert qgen.rows(5) == 5
    with pytest.raises(ValueError, match="64"):
        qgen.rows(72)


def test_micro_batcher_under_concurrent_submits(tiny):
    """Four requests submitted together inside the gather window decode as
    one batch; each text equals both engines'. A lone request then runs on
    the engine alone."""
    port, jax_engine = tiny
    mb = MicroBatcher(port, window_s=0.3, max_batch=4)
    try:
        audios = [_audio(s, f) for s, f in SHORT + [(1.5, 660.0)]]
        results = [None] * len(audios)

        def run(i):
            results[i] = mb.submit(audios[i], language="English", temperature=0.0)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(audios))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert mb.n_batches >= 1 and mb.n_batched_requests >= 2
        for audio, res in zip(audios, results):
            assert res.text and res.text == _engine_text(port, audio) == _engine_text(
                jax_engine, audio)
        n = mb.n_batches
        lone = mb.submit(_audio(1.0, 990.0), language="English", temperature=0.0)
        assert mb.n_batches == n and lone.text == _engine_text(port, _audio(1.0, 990.0))
        assert mb.eligible(_audio(2.0)) and not mb.eligible(_audio(2.5))
    finally:
        mb.close()


def test_micro_batches_are_keyed_by_temperature(tiny):
    """A batch takes the queue head's temperature and at most max_batch
    requests; the others wait for the next batch in their order."""
    port, _ = tiny
    mb = MicroBatcher(port, window_s=0.0, max_batch=2)
    mb.close()  # the worker is gone: the queue is driven by hand
    a = _audio(1.0)
    items = [_Pending(a, "", None, t) for t in (0.0, 0.5, 0.0, 0.0)]
    mb._queue.extend(items)
    assert mb._take_batch() == [items[0], items[2]]
    assert mb._take_batch() == [items[1]]
    assert mb._take_batch() == [items[3]]
    assert mb._take_batch() == []


def test_micro_batch_errors_reach_every_caller(tiny, monkeypatch):
    port, _ = tiny
    mb = MicroBatcher(port, window_s=0.2, max_batch=4)

    def boom(batch):
        raise RuntimeError("batched decode failed")

    monkeypatch.setattr(mb, "_run_batch", boom)
    errors = []

    def run(i):
        try:
            mb.submit(_audio(1.0, 330.0 + 110 * i), language="English")
        except RuntimeError as e:
            errors.append(str(e))

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=60)
    finally:
        mb.close()
    assert errors == ["batched decode failed"] * 2
