"""The audio encoder replayed as a CUDA graph per input key
(`runtime/encoder_runner.py`).

On the CPU: the graph's body on its static buffers (the signal, and the
valid mel frames and encoder tokens in a device buffer) against the eager
`encode` bit for bit, on the `tiny` tower in f32 and quantized to int8 and
int4, on both keys; the key function; the masks built from the buffers
against the host-built ones; `cuda_graphs` off on the CPU; the counters.

On the card (marked `cuda`, skipped elsewhere; no JAX import, so
`python -m pytest tests/test_torch_encoder_graph.py -m cuda --noconftest -q`
runs there): graph against eager (`cuda_graphs=False`) bit for bit at the
1.7B's and the 0.6B's widths (int4) and the aligner's (int8), at the aligned
40 s key and at three buckets with two valid lengths each; two replays in a
row; one capture per key and none inside a `torch.profiler` session; a
capture on a worker thread while decode graphs replay; the aligner's
encoder replaying on the align worker beside `asr`; a replay with no host
wait.
"""

import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu_torch.audio import mel
from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
from qwen3_asr_gguf_tpu_torch.models import encoder as enc
from qwen3_asr_gguf_tpu_torch.models import params as P
from qwen3_asr_gguf_tpu_torch.models.configs import preset
from qwen3_asr_gguf_tpu_torch.runtime.encoder_runner import EncodeGraph, EncoderRunner
from qwen3_asr_gguf_tpu_torch.utils import profiling

SR = 16_000
TINY = preset("tiny").audio


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(n: int, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / SR
    noise = np.random.default_rng(seed).standard_normal(n) * 0.05
    return (np.sin(2 * np.pi * 440 * t) * 0.3 + noise).astype(np.float32)


def _params(cfg, kind: str, path, device="cpu", seed: int = 0) -> dict:
    """Random encoder weights at `cfg` as the engine loads them: f32, or
    the matmul weights quantized ("int8", "int4") from a safetensors file."""
    tree = np_init_like(enc.init_shapes(cfg), seed)
    tree["pos_embed"] = enc.sinusoid_positions(cfg.max_source_positions, cfg.d_model)
    P.save_encoder_safetensors(str(path), cfg, tree)
    if kind == "f32":
        return P.load_encoder_safetensors(str(path), device=device)[1]
    return P.load_encoder_quantized(str(path), kind=kind, device=device)[1]


def _counter(name: str) -> int:
    return profiling.TRACER.counters.get(name, 0)


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------

# (samples, bucketed): the aligned 5 s key, then bucket 1000 at its first
# frame (501), inside it, and at its last (1000: 10 s, aligned audio taken
# bucketed); and bucket 500 from 1.3 s
CASES = ((5 * SR, False), (501 * 160 + 37, False), (777 * 160, False), (10 * SR, True),
         (SR + 4800 + 11, False))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_graph_body_on_static_buffers_equals_encode(kind, tmp_path):
    """`_body` on an `EncodeGraph`'s buffers, filled by `_load`, is today's
    eager `encode` bit for bit; one buffer set per key serves every length
    of its bucket."""
    runner = EncoderRunner(_params(TINY, kind, tmp_path / "enc.safetensors"), TINY,
                           device="cpu")
    buffers: dict = {}
    for n, bucketed in CASES:
        audio = _audio(n, seed=n)
        want = runner.encode(audio, bucketed=bucketed)
        key = runner.encode_key(n, bucketed)
        g = buffers.setdefault(key, EncodeGraph(runner.signal_len(key), runner.device))
        runner._load(g, key, audio, n // 160)
        got = runner._body(key, g.sig, g.valid())
        assert got.shape == want.shape and torch.equal(got, want), (kind, n, bucketed)
        if key[0] == "bucket":
            assert g.lens.tolist() == [n // 160, runner.valid_tokens(n)]
    assert sorted(buffers) == [("aligned", 5 * SR), ("bucket", 500), ("bucket", 1000)]


@pytest.mark.usefixtures("one_thread")
def test_aligned_key_takes_a_tensor_or_host_audio(tmp_path):
    """The aligned key's signal from a tensor (the engine's chunk rows) or
    from host audio fills the same buffer."""
    runner = EncoderRunner(_params(TINY, "f32", tmp_path / "enc.safetensors"), TINY,
                           device="cpu")
    audio = _audio(3 * SR, seed=3)
    key = runner.encode_key(len(audio))
    want = runner.encode(torch.from_numpy(audio))
    for src in (audio, torch.from_numpy(audio)):
        g = EncodeGraph(runner.signal_len(key), runner.device)
        runner._load(g, key, src, len(audio) // 160)
        assert torch.equal(g.sig, torch.from_numpy(audio))
        assert torch.equal(runner._body(key, g.sig, g.valid()), want)


def test_encode_key():
    runner = EncoderRunner({}, TINY, device="cpu")
    assert runner.encode_key(40 * SR) == ("aligned", 40 * SR)
    assert runner.encode_key(40 * SR, bucketed=True) == ("bucket", 4000)
    assert runner.encode_key(40 * SR + 160) == ("bucket", 4500)
    assert runner.encode_key(2 * SR - 1) == ("bucket", 500)
    assert runner.encode_key(55 * SR + 1) == ("bucket", 10000)  # doubling above 50 s
    assert runner.signal_len(("aligned", 40 * SR)) == 40 * SR
    assert runner.signal_len(("bucket", 500)) == 503 * 160
    # whole seconds that are not whole conv windows take a bucket
    wide = EncoderRunner({}, dataclasses.replace(TINY, n_window=200), device="cpu")
    assert wide.encode_key(3 * SR) == ("bucket", wide.mel_bucket(300))
    assert wide.encode_key(4 * SR) == ("aligned", 4 * SR)


@pytest.mark.parametrize("valid", [1, 7, 63, 64])
def test_masks_from_buffers_equal_the_host_masks(valid):
    buf = torch.tensor([valid, 0], dtype=torch.int32)
    assert torch.equal(enc.valid_key_mask(buf[0:1], 64, buf.device),
                       enc.valid_key_mask(valid, 64, buf.device))
    assert torch.equal(enc.valid_key_mask(valid, 64, buf.device),
                       torch.arange(64)[None, :] < valid)
    assert torch.equal(mel.valid_frame_mask(buf[0:1], 64, buf.device),
                       mel.valid_frame_mask(valid, 64, buf.device))
    assert mel.valid_frame_mask(valid, 64, buf.device).shape == (1, 64, 1)
    two = torch.tensor([valid, 3], dtype=torch.int32)
    assert torch.equal(enc.valid_key_mask(two, 64, two.device),
                       enc.valid_key_mask([valid, 3], 64, two.device))


def test_graphs_stay_off_on_the_cpu(tmp_path):
    runner = EncoderRunner(_params(TINY, "f32", tmp_path / "enc.safetensors"), TINY,
                           device="cpu", cuda_graphs=True)
    assert not runner.cuda_graphs
    runner.encode(_audio(2 * SR))
    assert runner.graphs == {}


@pytest.mark.usefixtures("one_thread")
def test_counters_count_every_encode(tmp_path):
    """`encode.calls` counts every encode, eager ones too, and is recorded
    inside `profiling.recording()`; the eager path replays and captures
    nothing."""
    runner = EncoderRunner(_params(TINY, "f32", tmp_path / "enc.safetensors"), TINY,
                           device="cpu")
    before = {n: _counter(n) for n in ("encode.calls", "encode.graph_replays",
                                       "encode.graph_captures")}
    profiling.clear()
    with profiling.recording():
        runner.encode(_audio(2 * SR))
        runner.encode(_audio(SR + 123), bucketed=True)
    runner.encode(_audio(SR))
    recs = [r for r in profiling.records() if r.name.startswith("encode.")]
    profiling.clear()
    assert _counter("encode.calls") - before["encode.calls"] == 3
    assert _counter("encode.graph_replays") == before["encode.graph_replays"]
    assert _counter("encode.graph_captures") == before["encode.graph_captures"]
    assert [(r.name, r.n) for r in recs] == [("encode.calls", 1)] * 2


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

TOWERS = {  # name: (config, weights) at the published widths, 4 layers
    "1.7b": (dataclasses.replace(preset("qwen3-asr-1.7b").audio, encoder_layers=4), "int4"),
    "0.6b": (dataclasses.replace(preset("qwen3-asr-0.6b").audio, encoder_layers=4), "int4"),
    "aligner": (dataclasses.replace(preset("qwen3-forced-aligner-0.6b").audio,
                                    encoder_layers=4), "int8"),
}
# (samples, bucketed): the engine's 40 s chunk, then two lengths in each of
# three buckets (500, 2000, 4500 frames), as the stream and the aligner meet them
CARD_CASES = ((40 * SR, False),
              (2 * SR, True), (4 * SR + 3210, True),
              (16 * SR + 160, True), (20 * SR, True),
              (41 * SR + 555, False), (44 * SR + 7, False))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_runners(name: str, path, device):
    cfg, kind = TOWERS[name]
    params = _params(cfg, kind, path, device=device, seed=len(name))
    return (EncoderRunner(params, cfg, device=device, cuda_graphs=False),
            EncoderRunner(params, cfg, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TOWERS))
def test_graph_encode_equals_eager_bit_for_bit(name, cuda, tmp_path):
    eager, graph = _card_runners(name, tmp_path / "enc.safetensors", cuda)
    assert graph.cuda_graphs and not eager.cuda_graphs
    captures, replays = _counter("encode.graph_captures"), _counter("encode.graph_replays")
    for n, bucketed in CARD_CASES:
        audio = _audio(n, seed=n)
        # the engine hands its chunks over on the device
        src = torch.from_numpy(audio).to(cuda) if not bucketed and n % SR == 0 else audio
        want = eager.encode(src, bucketed=bucketed)
        got = graph.encode(src, bucketed=bucketed)
        assert torch.equal(got, want), (name, n, bucketed)
    keys = {graph.encode_key(n, b) for n, b in CARD_CASES}
    assert set(graph.graphs) == keys == {("aligned", 40 * SR), ("bucket", 500),
                                        ("bucket", 2000), ("bucket", 4500)}
    assert _counter("encode.graph_captures") - captures == len(keys)
    assert _counter("encode.graph_replays") - replays == len(CARD_CASES)


@pytest.mark.cuda
def test_two_replays_in_a_row_leave_the_first_result(cuda, tmp_path):
    eager, graph = _card_runners("0.6b", tmp_path / "enc.safetensors", cuda)
    a, b = _audio(3 * SR + 11, seed=1), _audio(4 * SR + 99, seed=2)
    first = graph.encode(a, bucketed=True)
    second = graph.encode(b, bucketed=True)
    third = graph.encode(a, bucketed=True)
    assert torch.equal(first, eager.encode(a, bucketed=True))
    assert torch.equal(second, eager.encode(b, bucketed=True))
    assert torch.equal(third, first)


@pytest.mark.cuda
def test_one_capture_per_key_and_none_under_the_profiler(cuda, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    eager, graph = _card_runners("aligner", tmp_path / "enc.safetensors", cuda)
    captures = _counter("encode.graph_captures")
    for seed in range(3):
        graph.encode(_audio(3 * SR + 1 + seed, seed=seed))  # bucket 500
    assert _counter("encode.graph_captures") - captures == 1
    replays = _counter("encode.graph_replays")
    audio = _audio(12 * SR + 5, seed=9)  # bucket 1500: not captured yet
    with profile(activities=[ProfilerActivity.CUDA]):
        got = graph.encode(audio)
        graph.encode(_audio(3 * SR + 7, seed=7))  # captured: replays
        torch.cuda.synchronize()
    assert _counter("encode.graph_captures") - captures == 1
    assert _counter("encode.graph_replays") - replays == 1
    assert graph.encode_key(len(audio)) not in graph.graphs
    assert torch.equal(got, eager.encode(audio))
    graph.encode(audio)  # outside the session it captures
    assert _counter("encode.graph_captures") - captures == 2


def _kernel_preset():
    """A decoder the card's kernels take (hidden 512, heads of 128) behind
    the tiny tower; its aligner is the same shape with a class head."""
    from qwen3_asr_gguf_tpu_torch.models import configs as TC

    return TC.PRESETS.setdefault("kernel-512-enc-graph", TC.ThinkerConfig(
        audio=TC.AudioEncoderConfig(num_mel_bins=128, d_model=64, encoder_layers=2,
                                    encoder_attention_heads=4, encoder_ffn_dim=128,
                                    downsample_hidden_size=32, output_dim=512),
        text=TC.TextDecoderConfig(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
                                  num_kv_heads=2, head_dim=128, intermediate_size=1024)))


@pytest.mark.cuda
def test_capture_on_a_worker_beside_decode_graph_replays(cuda, tmp_path):
    """A worker thread captures and replays encodes of new keys while the
    main thread replays decode-step graphs: both equal their runs alone."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    _kernel_preset()
    make_synthetic_checkpoint(str(tmp_path), "kernel-512-enc-graph", quant="q4_k", seed=0)
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(tmp_path), llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4",
        chunk_size=2.0, n_ctx=512, verbose=False, max_new_tokens=12, decode_block=4),
        device=cuda)
    eager, graph = _card_runners("0.6b", tmp_path / "enc.safetensors", cuda)
    clips = [_audio(n, seed=n) for n in (3 * SR + 1, 9 * SR + 2, 14 * SR + 3, 23 * SR + 4)]
    want = [eager.encode(c) for c in clips]
    speech = _audio(int(5.5 * SR), seed=4)
    alone = engine.asr(speech, context="", language="English", temperature=0.0)
    got, errors = [], []

    def worker():
        try:
            for c in clips:
                got.append(graph.encode(c))
            torch.cuda.current_stream(cuda).synchronize()
        except Exception as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    beside = [engine.asr(speech, context="", language="English", temperature=0.0)
              for _ in range(2)]
    t.join()
    assert not errors, errors
    assert engine.generator.graphs  # the decode steps replayed
    assert len(graph.graphs) == len(clips)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(r.text == alone.text for r in beside)


@pytest.mark.cuda
def test_aligner_encoder_replays_on_the_align_worker(cuda, tmp_path):
    """`asr` with word times: the aligner's int8 tower captures and replays
    on the align worker beside the main thread's encodes and decode graphs;
    text and items equal the same calls with both encoders eager."""
    from qwen3_asr_gguf_tpu_torch import ASREngineConfig, QwenASREngine
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
    from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig

    _kernel_preset()
    make_synthetic_checkpoint(str(tmp_path), "kernel-512-enc-graph", quant="q4_k", seed=0)
    make_synthetic_checkpoint(str(tmp_path), "kernel-512-enc-graph", quant="q4_k", seed=1,
                              aligner=True)
    engine = QwenASREngine(ASREngineConfig(
        model_dir=str(tmp_path), llm_fn="qwen3_asr_llm.q4_k.gguf", precision="int4",
        chunk_size=2.0, n_ctx=512, verbose=False, max_new_tokens=12, decode_block=4,
        enable_aligner=True, align_config=AlignerConfig(
            model_dir=str(tmp_path), llm_fn="qwen3_aligner_llm.q4_k.gguf", precision="int8",
            n_ctx=512)), device=cuda)
    aligner = engine.aligner
    speech = _audio(int(5.5 * SR), seed=4)

    def call():
        res = engine.asr(speech, context="", language="English", temperature=0.0)
        return res.text, [(i.text, i.start_time, i.end_time) for i in res.alignment.items]

    graphed = [call(), call()]
    assert aligner.encoder.cuda_graphs and aligner.encoder.graphs
    assert engine.encoder.graphs
    replays = _counter("encode.graph_replays")
    captures = _counter("encode.graph_captures")
    again = call()
    assert _counter("encode.graph_replays") > replays
    assert _counter("encode.graph_captures") == captures  # every key met in the first calls
    engine.encoder.cuda_graphs = aligner.encoder.cuda_graphs = False
    eager = call()
    assert graphed[0] == graphed[1] == again == eager
    assert eager[1], "no word times"


@pytest.mark.cuda
def test_replayed_encode_makes_no_host_wait(cuda, tmp_path):
    """Once captured, an encode from host audio (bucketed) and from a
    device chunk (aligned) queues nothing that waits for the card."""
    _, graph = _card_runners("0.6b", tmp_path / "enc.safetensors", cuda)
    host = _audio(7 * SR + 3, seed=1)
    chunk = torch.from_numpy(_audio(10 * SR, seed=2)).to(cuda)
    graph.encode(host)
    graph.encode(chunk)
    gc.collect()
    torch.cuda.synchronize()
    calls = _counter("encode.graph_replays")
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = graph.encode(_audio(6 * SR + 9, seed=3))
        b = graph.encode(chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _counter("encode.graph_replays") - calls == 2
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
