"""Port parity for the server's timestamps: the continuous batcher's align
pool against the port's engine and the JAX engine, and the server built from
`--timestamp` answering srt, vtt and verbose_json over HTTP, on the CPU.

The checkpoints are those of tests/test_golden.py (f32 `tiny` ASR and
aligner). The pool aligns the batcher's chunk texts (a non-final chunk's
rollback-trimmed stable text) in the engine's windows: chunk j starts where
chunk j-1's last item ended, at most 10 s before chunk j-1's end. On full
2 s chunks its items must equal the engine's exactly (text, start and end).
"""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu.schema import AlignerConfig as JaxAlignerConfig
from qwen3_asr_gguf_tpu.schema import ASREngineConfig as JaxEngineConfig
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.cli import serve
from qwen3_asr_gguf_tpu_torch.cli.http import make_handler
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher
from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig, ASREngineConfig
from qwen3_asr_gguf_tpu_torch.text import exporters

from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _audio
from test_torch_serve import _post

NEW_TOKENS = 12  # below the breaker's 16-token window


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("timestamps_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16", seed=0)
    make_synthetic_checkpoint(d, "tiny", quant="f16", aligner=True, seed=1)
    return d


def _config(model_dir, config_cls=ASREngineConfig, aligner_cls=AlignerConfig):
    return config_cls(
        model_dir=model_dir, llm_fn="qwen3_asr_llm.f16.gguf", precision="f32", chunk_size=2.0,
        n_ctx=512, verbose=False, max_new_tokens=NEW_TOKENS, decode_block=8,
        enable_aligner=True,
        align_config=aligner_cls(model_dir=model_dir, llm_fn="qwen3_aligner_llm.f16.gguf",
                                 precision="f32", n_ctx=512))


@pytest.fixture(scope="module")
def engines(model_dir):
    return (QwenASREngine(_config(model_dir), device="cpu"),
            JaxEngine(_config(model_dir, JaxEngineConfig, JaxAlignerConfig)))


def _items(res):
    return [(it.text, it.start_time, it.end_time) for it in res.alignment.items]


@pytest.mark.parametrize("seconds,freq", [(2.0, 550.0), (4.0, 550.0), (4.0, 330.0)])
def test_align_pool_items_equal_the_engines(engines, seconds, freq):
    """One and two full chunks: the pool's items equal the port engine's
    and, within 1e-6 s, the JAX engine's; starts are monotonic and each
    start is at most its end."""
    port, jax_engine = engines
    audio = _audio(seconds, freq)
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        assert cb.supports_timestamps
        got = cb.submit(audio, language="English", temperature=0.0, timestamps=True)
    finally:
        cb.close()
    want = port.asr(audio, context="", language="English", chunk_size_sec=2.0, temperature=0.0)
    jax_want = jax_engine.asr(audio, context="", language="English", chunk_size_sec=2.0,
                              temperature=0.0)
    assert got.text == want.text == jax_want.text
    assert got.performance["n_chunks"] == int(seconds // 2)
    assert got.alignment is not None and _items(got) == _items(want)
    assert len(_items(got)) == len(_items(jax_want))
    for (gt, gs, ge), (jt, js, je) in zip(_items(got), _items(jax_want)):
        assert gt == jt and abs(gs - js) <= 1e-6 and abs(ge - je) <= 1e-6
    starts = [s for _, s, _ in _items(got)]
    assert starts == sorted(starts) and all(s <= e for _, s, e in _items(got))
    if seconds > 2.0:  # the second chunk's window starts inside the first chunk
        assert any(s >= 2.0 for s in starts)


@pytest.mark.parametrize("prev_ends,want", [
    (None, 40.0),  # the first chunk, or a previous chunk without items
    ([], 40.0),
    ([12.0, 35.5], 35.5),  # the previous chunk's last item's end
    ([3.0, 20.0], 30.0),  # at most 10 s before the previous chunk's end
    ([41.0, 44.0], 40.0),  # never after it (random weights can place items there)
])
def test_align_window_rule(prev_ends, want):
    """The one rule of the engine's and the align pool's windows, for chunk
    1 of 40 s chunks."""
    from qwen3_asr_gguf_tpu_torch.runtime.engine import align_offset
    from qwen3_asr_gguf_tpu_torch.schema import ForcedAlignItem

    prev = None if prev_ends is None else [ForcedAlignItem(text="w", start_time=e - 1.0,
                                                           end_time=e) for e in prev_ends]
    assert align_offset(40.0, prev, 40.0) == want


def test_concurrent_timestamped_and_plain_requests(engines):
    """Timestamped and plain requests in one batch: the pool aligns while
    the worker decodes on, and each answer equals the engine's."""
    port, _ = engines
    jobs = [(_audio(2.0, f), ts) for f, ts in ((330.0, True), (440.0, False), (660.0, True))]
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            results = list(pool.map(lambda j: cb.submit(j[0], language="English",
                                                        temperature=0.0, timestamps=j[1]),
                                    jobs))
    finally:
        cb.close()
    for (audio, ts), res in zip(jobs, results):
        want = port.asr(audio, context="", language="English", chunk_size_sec=2.0,
                        temperature=0.0)
        assert res.text == want.text
        assert (_items(res) == _items(want)) if ts else res.alignment is None


def test_a_failing_alignment_degrades_to_empty_with_a_warning(engines, monkeypatch, caplog):
    port, _ = engines

    def boom(*a, **kw):
        raise RuntimeError("aligner down")

    monkeypatch.setattr(port.aligner, "align", boom)
    cb = ContinuousBatcher(port, max_batch=2, block=4)
    try:
        with caplog.at_level("WARNING"):
            res = cb.submit(_audio(2.0, 550.0), language="English", temperature=0.0,
                            timestamps=True)
    finally:
        cb.close()
    assert res.text and res.alignment is None
    assert "forced alignment failed in batched serving" in caplog.text


def test_no_aligner_no_timestamps(model_dir):
    cfg = _config(model_dir)
    cfg.enable_aligner = False
    cb = ContinuousBatcher(QwenASREngine(cfg, device="cpu"), max_batch=2, block=4)
    try:
        assert not cb.supports_timestamps
        res = cb.submit(_audio(1.0, 440.0), language="English", temperature=0.0,
                        timestamps=True)
        assert res.text and res.alignment is None
    finally:
        cb.close()


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------


def test_server_timestamp_answers_srt_vtt_and_verbose_json(model_dir):
    """`--timestamp` builds the aligner from the decoder's file name and the
    continuous batcher aligns on its pool: srt, vtt and verbose_json over
    HTTP carry the engine's items (temperature 1e-6 samples the argmax; the
    server maps 0 to 0.4)."""
    srv, engine, batcher = serve.build(
        ["--model-dir", model_dir, "--prec", "f32", "--chunk-size", "2", "--n-ctx", "512",
         "--max-batch", "4", "--device", "cpu", "--timestamp"],
        max_new_tokens=NEW_TOKENS, decode_block=8)
    assert engine.aligner is not None and batcher.supports_timestamps
    assert engine.config.align_config.llm_fn == "qwen3_aligner_llm.f16.gguf"
    assert engine.config.align_config.precision == "f32"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    audios = [np.round(_audio(s, f) * 32767) / 32767 for s, f in ((1.5, 330.0), (4.0, 550.0),
                                                                 (1.5, 770.0))]
    formats = ["srt", "verbose_json", "vtt"]
    try:
        with ThreadPoolExecutor(len(audios)) as pool:
            answers = list(pool.map(lambda a: _post(url, *a), zip(audios, formats)))
        stats = json.loads(urllib.request.urlopen(f"{url}/stats", timeout=30).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert stats["batching"]["completed"] == 3  # all three through the batcher
    for audio, fmt, (status, body) in zip(audios, formats, answers):
        assert status == 200
        want = engine.asr(audio.astype(np.float32), context="", language="English",
                          chunk_size_sec=2.0, temperature=0.0)
        assert want.alignment is not None
        if fmt == "srt":
            assert body == exporters.alignment_to_srt(want.alignment.items) and " --> " in body
        elif fmt == "vtt":
            assert body == exporters.alignment_to_vtt(want.alignment.items)
            assert body.startswith("WEBVTT\n\n")
        else:
            out = json.loads(body)
            assert out["text"] == want.text and out["duration"] == 4.0
            assert out["words"] and out["segments"]
            assert [w["word"] for w in out["words"]] == [
                it.text for it in want.alignment.items if it.text.strip()]
