"""Port parity for continuous batching: the port's `ContinuousBatcher` on
the CPU against the port's sequential engine and the JAX engine, greedy.

On the f32 `tiny` engine the batcher serves with f32 KV, and its greedy text
must equal both engines exactly (the JAX package pins the same for its own
batcher, tests/test_continuous.py). On the int4 `kernel-512` engine at
max_batch 8 every batched matmul takes the multi-row q4_k route; its plain
version equals the matvec's row by row bit for bit, so the greedy text
equals the sequential engine's on inputs whose ties the attention's sum
order does not break (see the test for the margins).
"""

import threading
import time

import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.ops import q4k
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq
from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher, batch_rows

from test_torch_engine import KERNEL_PRESET, _audio, _config


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config, port engine, JAX engine) of one f32 tiny checkpoint."""
    d = str(tmp_path_factory.mktemp("cb_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16")
    cfg = _config(d, "qwen3_asr_llm.f16.gguf", "f32")
    cfg.max_new_tokens = 12  # below the engine's 16-token repetition-breaker window
    return cfg, QwenASREngine(cfg, device="cpu"), JaxEngine(cfg)


def _sequential(engines, audio, language):
    outs = []
    for engine in engines:
        res = engine.asr(audio, context="", language=language, chunk_size_sec=2.0,
                         memory_chunks=1, temperature=0.0,
                         detect_language=language is None)
        outs.append((res.text, res.language))
    return outs


def _submit_all(cb, jobs, delays=None):
    """Submit (audio, kwargs) jobs from concurrent threads."""
    results = [None] * len(jobs)

    def run(i):
        if delays:
            time.sleep(delays[i])
        audio, kw = jobs[i]
        results[i] = cb.submit(audio, **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


def test_concurrent_requests_into_fewer_rows(tiny):
    """5 concurrent requests into 4 rows: one admission waits for a row."""
    _, port, jax_engine = tiny
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    assert cb.b == 4 and len(cb.rows) == 4  # on the CPU the row count stays max_batch
    try:
        audios = [_audio(1.5, f) for f in (330.0, 440.0, 550.0, 660.0, 770.0)]
        results = _submit_all(cb, [(a, {"language": "English"}) for a in audios])
        assert cb.stats["completed"] == 5 and cb.stats["admitted"] == 5
        for audio, res in zip(audios, results):
            (p_text, _), (j_text, _) = _sequential((port, jax_engine), audio, "English")
            assert res.text == p_text == j_text
            assert res.performance["batched"] == "continuous"
    finally:
        cb.close()


def test_staggered_admission(tiny):
    """A request arriving mid-decode joins a free row while the first one
    is still generating. (The batcher encodes a short chunk as it is, the
    engine zero-pads it to the full chunk, as in the JAX package; their
    encoder rows differ by ~1e-4, which flips a greedy token of a 1.8 s
    330 Hz tone. A full 2 s chunk encodes identically.)"""
    _, port, jax_engine = tiny
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        jobs = [(_audio(2.0, 330.0), {"language": "English"}),
                (_audio(1.0, 990.0), {"language": "English"})]
        results = _submit_all(cb, jobs, delays=[0.0, 0.05])
        assert cb.stats["completed"] == 2
        for (audio, _), res in zip(jobs, results):
            (p_text, _), (j_text, _) = _sequential((port, jax_engine), audio, "English")
            assert res.text == p_text == j_text
    finally:
        cb.close()


def test_mixed_temperatures(tiny):
    """Greedy and sampled rows in one batch: each row samples at its own
    temperature; the greedy rows stay exactly the engine's."""
    _, port, jax_engine = tiny
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    try:
        audios = [_audio(1.5, f) for f in (330.0, 440.0, 550.0, 660.0)]
        temps = [0.0, 0.9, 0.0, 1.3]
        results = _submit_all(cb, [(a, {"language": "English", "temperature": t})
                                   for a, t in zip(audios, temps)])
        for audio, t, res in zip(audios, temps, results):
            assert isinstance(res.text, str) and res.performance["n_generate"] > 0
            if t == 0.0:
                (p_text, _), (j_text, _) = _sequential((port, jax_engine), audio, "English")
                assert res.text == p_text == j_text
    finally:
        cb.close()


def test_two_chunk_audio_with_auto_language(tiny):
    """3.5 s at 2 s chunks: chunk 0 runs the detection prompt, chunk 1 the
    memory prompt (previous chunk's audio and stable tokens) in a later row
    session; text and language equal both engines' auto mode."""
    _, port, jax_engine = tiny
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        audio = _audio(3.5, 550.0)
        res = cb.submit(audio, language=None, temperature=0.0)
        assert res.performance["n_chunks"] == 2
        (p_text, p_lang), (j_text, j_lang) = _sequential((port, jax_engine), audio, None)
        assert res.text == p_text == j_text
        assert res.language == p_lang == j_lang
    finally:
        cb.close()


def test_windows_are_whole_tiles_at_any_n_ctx(tiny, monkeypatch):
    """At an n_ctx that is not a multiple of 256 the row caches round up to
    the 256-slot buckets, so every decode block's attention window is whole
    tiles of the rows attention kernel; the text is unchanged."""
    _, port, jax_engine = tiny
    audio = _audio(1.5, 440.0)
    (p_text, _), (j_text, _) = _sequential((port, jax_engine), audio, "English")
    wins = []
    real = dec.forward_step_rows
    monkeypatch.setattr(dec, "forward_step_rows",
                        lambda *a, attn_window, **kw: wins.append(attn_window)
                        or real(*a, attn_window=attn_window, **kw))
    monkeypatch.setattr(port.config, "n_ctx", 300)
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        assert cb.caches["k"][0].shape[1] == 512
        res = cb.submit(audio, language="English", temperature=0.0)
    finally:
        cb.close()
    assert wins and all(w % 256 == 0 for w in wins)
    assert res.text == p_text == j_text


def test_prompt_overflow_fails_alone(tiny):
    cfg, port, _ = tiny
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        cb.n_ctx = 40  # shorter than any prompt
        with pytest.raises(ValueError):
            cb.submit(_audio(1.5, 330.0), language="English", timeout=60)
        assert cb.stats["admitted"] == 0
    finally:
        cb.close()


@pytest.fixture(scope="module")
def kernel_engine(tmp_path_factory):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    d = str(tmp_path_factory.mktemp("cb_kernel"))
    make_synthetic_checkpoint(d, "kernel-512", quant="q4_k")
    cfg = _config(d, "qwen3_asr_llm.q4_k.gguf", "int4")
    cfg.max_new_tokens = 12
    return QwenASREngine(cfg, device="cpu")


def test_int4_batcher_takes_the_rows_route(kernel_engine, monkeypatch):
    """max_batch 8 on the kernel-shaped int4 engine: every decode matmul
    (qkv, o, gate_up, down, lm_head) runs on the multi-row q4_k matmul.
    Its plain version is bit-equal to the matvec's row by row, so the
    greedy text equals the engine's unless the attention's other sum order
    breaks a tie. Margins are thin on random weights: the smallest top-2
    gap of the engine's greedy steps is an exact bf16 tie at 440 Hz and one
    bf16 ulp (0.0078) at 660 Hz; neither flips here."""
    calls = []
    real = q4k.q4k_matmul_rows
    monkeypatch.setattr(q4k, "q4k_matmul_rows",
                        lambda x, w: calls.append(tuple(x.shape)) or real(x, w))
    cb = ContinuousBatcher(kernel_engine, max_batch=8, block=4)
    try:
        audios = [_audio(1.5, 440.0), _audio(1.5, 660.0)]
        results = _submit_all(cb, [(a, {"language": "English"}) for a in audios])
    finally:
        cb.close()
    assert calls and {c[0] for c in calls} == {8}
    n_steps = cb.stats["n_blocks"] * cb.block
    assert len(calls) == n_steps * (4 * KERNEL_PRESET.text.num_layers + 1)
    monkeypatch.setattr(q4k, "q4k_matmul_rows", real)
    for audio, res in zip(audios, results):
        seq = kernel_engine.asr(audio, context="", language="English", chunk_size_sec=2.0,
                                temperature=0.0)
        assert res.text == seq.text


def _weights_of(kind: str) -> list:
    """One weight of each decoder container, as the batcher inspects them."""
    if kind == "q4k":
        return [q4k.Q4KWeight(*(torch.zeros(1, dtype=dt) for dt in
                                (torch.uint8, torch.int8, torch.int8, torch.float32))),
                torch.ones(4)]
    if kind == "q4":
        return [tq.Q4Weight(torch.zeros(1, dtype=torch.uint8), torch.zeros(1), torch.zeros(1))]
    if kind == "int8":
        return [tq.Int8Weight(q=torch.zeros(1, dtype=torch.int8), scale=torch.zeros(1))]
    return [torch.zeros(2, 2)]


@pytest.mark.parametrize("kind,max_batch,rows", [
    ("q4k", 1, 8), ("q4k", 4, 8), ("q4k", 8, 8), ("q4k", 12, 16), ("q4k", 63, 64),
    ("q4k", 64, 64), ("q4", 4, 4), ("q4", 64, 64), ("int8", 4, 4), ("int8", 72, 72),
    ("dense", 3, 3), ("dense", 100, 100),
])
def test_batch_rows_rounds_to_the_kernels_tiles_on_the_card(kind, max_batch, rows):
    """On the card a q4_k decoder's batch rounds up to whole 8-row tiles of
    the multi-row kernel; other containers keep `max_batch`; on the CPU
    every container keeps it."""
    assert batch_rows(max_batch, _weights_of(kind), on_cuda=True) == rows
    assert batch_rows(max_batch, _weights_of(kind), on_cuda=False) == max_batch


@pytest.mark.parametrize("kind", ["q4k", "q4"])
@pytest.mark.parametrize("max_batch", [65, 72, 128])
def test_batch_rows_refuses_more_rows_than_the_kernels_take(kind, max_batch):
    """Above 64 rows a multi-row kernel would not take the product: on the
    card the batcher refuses at construction and names the limit; the CPU
    runs the plain versions at any count."""
    limit = q4k.MAX_ROWS if kind == "q4k" else tq.qmm.MAX_ROWS
    assert limit == 64
    with pytest.raises(ValueError, match=str(limit)):
        batch_rows(max_batch, _weights_of(kind), on_cuda=True)
    assert batch_rows(max_batch, _weights_of(kind), on_cuda=False) == max_batch
    with pytest.raises(ValueError):
        batch_rows(0, _weights_of(kind), on_cuda=False)
