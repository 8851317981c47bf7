"""The port's tool CLIs on the CPU at tiny sizes: diagnostics, the streaming
demo over HTTP, the release bundle, the example twins, and every new entry
point's refusal to run without a card when asked for one.

- diagnostics: the JAX tool's report keys; no memory figures off the card.
- demo: two sessions fed at once over HTTP (a barrier puts their chunk
  requests in flight together) each end in the text a `StreamingTranscriber`
  on the same engine gives alone on the same chunks (greedy, exact); the
  store feeds one request at a time. The engine itself is safe under
  threads that feed it at once: each decode prefills a cache of its own.
- release: `csrc` sources in, `build/` and the JAX package out; the extracted
  tree imports with only itself on PYTHONPATH and loads no JAX.
- examples: `run_asr` and `run_aligner` on tiny checkpoints.
"""

import base64
import dataclasses
import json
import shutil
import subprocess
import sys
import threading
import urllib.request
import wave
import zipfile
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.cli import diagnostics as jdiag
from qwen3_asr_gguf_tpu_torch.cli import demo_streaming, diagnostics, perplexity, quant_accuracy
from qwen3_asr_gguf_tpu_torch.cli import release, verify_weights
from qwen3_asr_gguf_tpu_torch.examples import run_aligner, run_asr
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber
from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_fidelity import PRESET  # tiny-ppl-256: hidden 256, so int4 loads

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 16_000
FORBIDDEN = ("jax", "jaxlib", "qwen3_asr_gguf_tpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """tiny f16 ASR checkpoint (the demo and diagnostics) plus a q4_k
    decoder and the forced aligner (the examples at their defaults)."""
    d = tmp_path_factory.mktemp("tools_ckpt")
    make_synthetic_checkpoint(str(d), PRESET, quant="f16", seed=0)
    make_synthetic_checkpoint(str(d), PRESET, quant="q4_k", seed=0)
    make_synthetic_checkpoint(str(d), PRESET, quant="q4_k", aligner=True, seed=1)
    return d


def _tone(seconds: float, freq: float) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * freq * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))
            ).astype(np.float32)


def _write_wav(path: Path, audio: np.ndarray) -> Path:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


def test_diagnostics_report_keys(model_dir, capsys):
    argv = ["--model-dir", str(model_dir), "--seconds", "2"]
    assert diagnostics.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jdiag.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got["backend"] == "cpu" and got["device"] == "cpu"
    assert got["memory_baseline"] == got["memory_peak"] == {}
    assert got["encoder_seconds_audio"] == 2.0 and got["encoder_rtf"] > 0
    assert diagnostics.main(argv + ["--int4", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["encoder_time_s"] > 0


# --------------------------------------------------------------------------
# the streaming demo
# --------------------------------------------------------------------------

DEMO_CHUNK_S = 1.0
DEMO_PIECE_S = 0.5  # each request carries half a chunk: a decode every other request
# 3 (2) whole chunks and a tail that finish() flushes; the lengths differ
# because the tiny random model's text depends on the audio's length, not on
# its content, and the two sessions' texts must differ
DEMO_AUDIO_S = (3.5, 2.5)


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_demo_two_sessions_at_once_equal_the_transcriber_alone(model_dir):
    store, _ = demo_streaming.build(
        ["--model-dir", str(model_dir), "--prec", "f16", "--device", "cpu",
         "--chunk-sec", str(DEMO_CHUNK_S), "--language", "English"],
        precision="f32", n_ctx=512, max_new_tokens=12, decode_block=8)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), demo_streaming.make_handler(store))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    audios = [_tone(secs, f) for secs, f in zip(DEMO_AUDIO_S, (330.0, 550.0))]
    piece = int(DEMO_PIECE_S * SR)
    pieces = [[a[i: i + piece] for i in range(0, len(a), piece)] for a in audios]
    steps = max(map(len, pieces))
    together = threading.Barrier(2)
    finals, partials, errors = [None, None], [[], []], []

    def session(i: int) -> None:
        try:
            sid = _post(url + "/api/start", {})["sid"]
            for j in range(steps):
                together.wait(timeout=60)  # both sessions' requests in flight at once
                if j < len(pieces[i]):
                    b64 = base64.b64encode(pieces[i][j].tobytes()).decode()
                    partials[i].append(
                        _post(url + "/api/chunk", {"sid": sid, "pcm": b64})["text"])
            finals[i] = _post(url + "/api/finish", {"sid": sid})["text"]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
            together.abort()

    try:
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            assert b"live transcription" in r.read()
        threads = [threading.Thread(target=session, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/api/chunk", {"sid": "nope", "pcm": ""})
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()

    for i in range(2):
        alone = StreamingTranscriber(store.transcriber.engine, chunk_size_sec=DEMO_CHUNK_S,
                                     language="English")
        state = alone.init_state()
        texts = []
        for p in pieces[i]:
            alone.feed(state, p)
            texts.append(state.text)
        assert partials[i] == texts
        assert finals[i] == alone.finish(state)
        assert state.chunks_seen == int(DEMO_AUDIO_S[i]) + 1
    assert finals[0] and finals[1] and finals[0] != finals[1]


class _SlowTranscriber:
    """A transcriber that records how many feeds and finishes overlap."""

    def __init__(self):
        self.inside, self.most, self.lock = 0, 0, threading.Lock()

    def init_state(self):
        return StreamingTranscriber(None).init_state()

    def _enter_and_wait(self):
        with self.lock:
            self.inside += 1
            self.most = max(self.most, self.inside)
        threading.Event().wait(0.02)
        with self.lock:
            self.inside -= 1

    def feed(self, state, pcm):
        self._enter_and_wait()
        state.buffer = np.concatenate([state.buffer, pcm])
        state.text = str(state.buffer.size)

    def finish(self, state):
        self._enter_and_wait()
        return state.text


def test_session_store_feeds_one_request_at_a_time():
    """Chunks of two sessions, and two overlapping chunks of one session
    (the page does not wait for an answer before it posts the next), reach
    the transcriber one at a time, and no piece is lost."""
    fake = _SlowTranscriber()
    store = demo_streaming.SessionStore(fake)
    sids = [store.start(), store.start()]
    piece = np.ones(160, np.float32)
    jobs = [sids[0]] * 4 + [sids[1]] * 4
    threads = [threading.Thread(target=store.chunk, args=(sid, piece)) for sid in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert [store.finish(sid) for sid in sids] == ["640", "640"]
    assert fake.most == 1


def test_transcribers_on_threads_share_no_state(model_dir):
    """Six threads (more than the lane's cores per worker) feed one engine
    with a switch interval of 10 us, so their decodes interleave at every
    few bytecodes; each must end in its own sequential text. A shared cache
    or counter written in place would show as a text of another length."""
    store, _ = demo_streaming.build(
        ["--model-dir", str(model_dir), "--prec", "f16", "--device", "cpu", "--chunk-sec", "1"],
        precision="f32", n_ctx=512, max_new_tokens=6, decode_block=6)
    engine = store.transcriber.engine
    lengths = (1.5, 2.5, 1.5, 2.0, 3.0, 2.5)

    def run(secs: float) -> str:
        st = StreamingTranscriber(engine, chunk_size_sec=1.0, language="English")
        state = st.init_state()
        st.feed(state, _tone(secs, 440.0))
        return st.finish(state)

    want = [run(secs) for secs in lengths]
    got, errors = [None] * len(lengths), []
    start = threading.Barrier(len(lengths))

    def worker(i: int) -> None:
        try:
            start.wait(timeout=60)
            got[i] = run(lengths[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(lengths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == want and len(set(want)) > 1


# --------------------------------------------------------------------------
# the release bundle
# --------------------------------------------------------------------------


def test_release_bundle_carries_the_port_alone(tmp_path, monkeypatch):
    """A copy of the package with a kernel build and bytecode in it: the
    bundle keeps the CUDA sources and leaves out build/ and __pycache__."""
    pkg = tmp_path / "src" / "qwen3_asr_gguf_tpu_torch"
    shutil.copytree(release._PKG_ROOT, pkg, ignore=shutil.ignore_patterns("__pycache__", "build"))
    (pkg / "build").mkdir()
    (pkg / "build" / "libq3a_kernels.so").write_bytes(b"\0")
    (pkg / "ops" / "__pycache__").mkdir()
    (pkg / "ops" / "__pycache__" / "q4k.cpython-312.pyc").write_bytes(b"\0")
    monkeypatch.setattr(release, "_PKG_ROOT", pkg)

    zip_path = release.build_release(tmp_path / "dist", with_native=False)
    root = zip_path.stem
    assert root.startswith("qwen3-asr-gguf-tpu-torch-")
    with zipfile.ZipFile(zip_path) as zf:
        names = set(zf.namelist())
    port = f"{root}/qwen3_asr_gguf_tpu_torch"
    for src in release._PKG_ROOT.glob("csrc/*.cu*"):
        assert f"{port}/csrc/{src.name}" in names
    assert any(n.endswith(".cuh") for n in names)
    assert f"{port}/cli/transcribe.py" in names and f"{port}/examples/run_asr.py" in names
    assert not [n for n in names if "/build/" in n.removeprefix(f"{root}/native/")
                or "__pycache__" in n]
    assert not [n for n in names if n.startswith(f"{root}/qwen3_asr_gguf_tpu/")
                or n.startswith(f"{root}/examples/")]
    assert f"{root}/native/CMakeLists.txt" in names
    assert any(n.startswith(f"{root}/native/src/") for n in names)
    # the repo's start_server.sh launches the JAX package: left out
    assert f"{root}/start_server.sh" not in names
    for shim in ("transcribe", "serve"):
        text = (tmp_path / "dist" / root / "bin" / shim).read_text()
        assert f"-m qwen3_asr_gguf_tpu_torch.cli.{shim}" in text
    meta = json.loads((tmp_path / "dist" / root / "RELEASE.json").read_text())
    assert meta["name"] == "qwen3-asr-gguf-tpu-torch" and meta["version"]

    code = (
        "import sys\n"
        "import qwen3_asr_gguf_tpu_torch as pkg, qwen3_asr_gguf_tpu_torch.runtime.engine\n"
        "import qwen3_asr_gguf_tpu_torch.cli.transcribe, qwen3_asr_gguf_tpu_torch.ops._build as b\n"
        f"assert not [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(pkg.__file__, b.BUILD_DIR)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={"PYTHONPATH": str(tmp_path / "dist" / root), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    pkg_file, build_dir = proc.stdout.split()
    assert pkg_file.startswith(str(tmp_path / "dist" / root))
    assert build_dir == str(tmp_path / "dist" / root / "qwen3_asr_gguf_tpu_torch" / "build")


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------


def test_run_asr_example(model_dir, tmp_path, monkeypatch, capsys):
    """At the engine's defaults (int4 on the q4_k GGUF, 40 s chunks) but for
    the token budget, which no argument sets: 12 new tokens."""
    @dataclasses.dataclass
    class Short(run_asr.ASREngineConfig):
        max_new_tokens: int = 12
        decode_block: int = 8

    monkeypatch.setattr(run_asr, "ASREngineConfig", Short)
    wav = _write_wav(tmp_path / "a.wav", _tone(2.0, 440.0))
    run_asr.main([str(model_dir), str(wav), "English", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "--- transcript ---" in out and "decode_tokens" in out


def test_run_aligner_example(model_dir, tmp_path, capsys):
    wav = _write_wav(tmp_path / "a.wav", _tone(3.0, 440.0))
    run_aligner.main([str(model_dir), str(wav), "the quick brown fox", "English",
                      "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    items = [ln.split("] ", 1)[1] for ln in lines if ln.startswith("[")]
    # the items reconcile with the text: the words and the spaces between them
    assert [w for w in items if w.strip()] == ["the", "quick", "brown", "fox"]
    assert lines[-1].startswith("--- performance ---")


# --------------------------------------------------------------------------
# --device cuda without a card
# --------------------------------------------------------------------------

ON_CARD = {
    "perplexity": lambda d: perplexity.main(["--llm", str(d / "qwen3_asr_llm.q4_k.gguf"),
                                             "--text", str(d / "config.json")]),
    "quant_accuracy": lambda d: quant_accuracy.main(["--model-dir", str(d)]),
    "diagnostics": lambda d: diagnostics.main(["--model-dir", str(d)]),
    "demo_streaming": lambda d: demo_streaming.build(["--model-dir", str(d)]),
    "verify_weights": lambda d: verify_weights.main(["--hf", str(d), "--out", str(d / "x")]),
    "run_asr": lambda d: run_asr.main([str(d), "a.wav"]),
    "run_aligner": lambda d: run_aligner.main([str(d), "a.wav", "text"]),
}


@pytest.mark.parametrize("entry", sorted(ON_CARD))
def test_default_device_is_the_card_and_absent_here(model_dir, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ON_CARD[entry](model_dir)
    assert not (model_dir / "x").exists()
