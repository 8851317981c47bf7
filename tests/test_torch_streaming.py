"""Port parity for streaming transcription and the model API: the port's
`StreamingTranscriber` and `Qwen3ASRModel` over the port's engine on the CPU
against the JAX package's over the JAX engine, the committed streaming
golden, and the encoder runner's `bucketed=` branch.

f32 `tiny` checkpoint (the golden's), greedy: texts are compared exactly.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.runtime.encoder_runner import EncoderRunner as JaxRunner
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu.runtime.model_api import Qwen3ASRModel as JaxModel
from qwen3_asr_gguf_tpu.runtime.streaming import StreamingTranscriber as JaxStreaming
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.audio.split import split_audio_into_chunks
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.runtime.encoder_runner import EncoderRunner
from qwen3_asr_gguf_tpu_torch.runtime.model_api import ASRResult, Qwen3ASRModel
from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber

from test_torch_engine import _audio, _config

GOLDEN_DIR = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("streaming_ckpt"))
    make_synthetic_checkpoint(d, "tiny", quant="f16", seed=0)
    return d


@pytest.fixture(scope="module")
def engines(model_dir):
    cfg = _config(model_dir, "qwen3_asr_llm.f16.gguf", "f32")
    return JaxEngine(cfg), QwenASREngine(cfg, device="cpu")


def _stream(cls, engine, audio, piece, **kw):
    """Per-feed texts, then the final one, and the final state."""
    st = cls(engine, **kw)
    state = st.init_state()
    texts = []
    for off in range(0, len(audio), piece):
        st.feed(state, audio[off: off + piece])
        texts.append(state.text)
    final = st.finish(state)
    texts.append(state.text)
    assert final == state.text and state.finished
    return texts, state


def test_streaming_reproduces_golden(engines):
    """1 s chunks, 2.5 s of a 550 Hz tone fed in 0.5 s pieces, greedy."""
    texts, state = _stream(StreamingTranscriber, engines[1], _audio(2.5, 550.0), 8000,
                           language="English", temperature=0.0, chunk_size_sec=1.0)
    assert {"texts": texts} == json.loads((GOLDEN_DIR / "streaming.json").read_text())
    assert state.chunks_seen == 3 and state.language == "English"
    with pytest.raises(RuntimeError):
        StreamingTranscriber(engines[1]).feed(state, np.zeros(10, np.float32))


@pytest.mark.parametrize("language", ["English", None])
def test_streaming_equals_jax_per_chunk(engines, language, monkeypatch):
    """2 s chunks over 9 s (past `unfixed_chunk_num`, so the rolled-back
    prefix is carried), with a forced language and with auto-detection.
    12 new tokens per step keep the repetition breaker (16 tokens at least)
    out: its retries sample, and the two frameworks draw other numbers."""
    for engine in engines:
        monkeypatch.setattr(engine.config, "max_new_tokens", 12)
    audio = _audio(9.0, 440.0) + 0.5 * _audio(9.0, 617.0)
    kw = dict(language=language, temperature=0.0, chunk_size_sec=2.0, unfixed_chunk_num=2,
              unfixed_token_num=3)
    want, jstate = _stream(JaxStreaming, engines[0], audio, 16000, **kw)
    got, tstate = _stream(StreamingTranscriber, engines[1], audio, 16000, **kw)
    assert got == want and len(got) == 10
    assert tstate.tokens == jstate.tokens and tstate.chunks_seen == jstate.chunks_seen == 5
    assert tstate.fixed_prefix == jstate.fixed_prefix and tstate.fixed_prefix
    assert tstate.language == jstate.language


@pytest.mark.parametrize("seconds", [2.0, 3.0, 6.0])
def test_bucketed_encode_vs_jax_runner(model_dir, seconds):
    """`bucketed=True` forces the bucket-padded branch for aligned audio:
    another shape ([65 or 130 rows] against the aligned branch's own length)
    whose valid rows equal the JAX runner's bucketed rows within 1e-4 (f32,
    sums in another order) and the aligned branch's within 2e-4 (padded keys
    are masked, the reflect-padded mel differs at the last frames only by
    rounding)."""
    import os

    path = os.path.join(model_dir, "qwen3_asr_encoder.safetensors")
    jcfg, jparams = jP.load_encoder_safetensors(path)
    tcfg, tparams = tP.load_encoder_safetensors(path)
    jrun, trun = JaxRunner(jparams, jcfg), EncoderRunner(tparams, tcfg, device="cpu")
    audio = _audio(seconds, 330.0)
    n_valid = trun.valid_tokens(len(audio))
    assert n_valid == jrun.valid_tokens(len(audio))
    want = np.asarray(jrun.encode_async(audio, bucketed=True), np.float32)
    got = trun.encode_async(audio, bucketed=True)
    assert got.shape == want.shape and got.shape[0] == (65 if seconds <= 5 else 130)
    np.testing.assert_allclose(got[:n_valid].numpy(), want[:n_valid], rtol=0, atol=1e-4)
    plain = trun.encode(audio)  # the aligned branch: its own length, no mask
    assert plain.shape[0] == n_valid
    np.testing.assert_allclose(got[:n_valid].numpy(), plain.numpy(), rtol=0, atol=2e-4)
    assert torch.equal(trun.encode(audio, bucketed=False), plain)
    # unaligned audio takes the bucket either way
    odd = audio[: len(audio) - 1234]
    assert torch.equal(trun.encode(odd, bucketed=True), trun.encode(odd))


def test_model_api_transcribe_equals_jax(engines):
    audio = _audio(3.0, 440.0)
    want = JaxModel(engines[0]).transcribe([audio, (audio[:8000], 16000)], language="English")
    got = Qwen3ASRModel(engines[1]).transcribe([audio, (audio[:8000], 16000)], language="English")
    assert [type(r) for r in got] == [ASRResult, ASRResult]
    assert [(r.text, r.language, r.time_stamps) for r in got] \
        == [(r.text, r.language, r.time_stamps) for r in want]
    assert got[0].text and got[0].language == "English"
    # auto language: the prompt omits <asr_text> and the engine parses the output
    auto_want = JaxModel(engines[0]).transcribe(audio)
    auto_got = Qwen3ASRModel(engines[1]).transcribe(audio)
    assert [(r.text, r.language) for r in auto_got] == [(r.text, r.language) for r in auto_want]


def test_split_audio_copy_cuts_at_low_energy():
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal(16000 * 9) * 0.1).astype(np.float32)
    pcm[16000 * 3 + 4000: 16000 * 3 + 7200] = 0.0  # a pause 0.25-0.45 s past the 3 s mark
    pieces = split_audio_into_chunks(pcm, chunk_sec=3.0, search_sec=1.0)
    assert len(pieces) >= 2 and pieces[0][1] == 0.0
    assert sum(len(p) for p, _ in pieces) == len(pcm)
    assert 3.25 < pieces[1][1] < 3.45  # the cut moved into the pause
    short = split_audio_into_chunks(pcm[:16000], chunk_sec=3.0)  # fits: returned whole
    assert len(short) == 1 and short[0][0] is not None and short[0][1] == 0.0
