"""The port's OpenAI-compatible server on the CPU: built by its CLI's build
function from real arguments (`--device cpu`), served on a local port, with
the continuous batcher behind it.

The server maps temperature <= 0 to 0.4, as the reference server does; the
requests here ask for temperature 1e-6 instead, which the batcher samples as
the argmax (the tiny engine's smallest top-2 logit gap on these inputs is
1.1e-3, 1100 units at that temperature), so each text must equal the
engine's greedy transcript.
"""

import io
import json
import sys
import threading
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from qwen3_asr_gguf_tpu_torch.cli import serve
from qwen3_asr_gguf_tpu_torch.cli.http import make_handler
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

from test_torch_engine import _audio
from test_torch_parallel import world_of_one  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16", seed=0)
    return d


def _argv(model_dir, *extra):
    return ["--model-dir", model_dir, "--prec", "f32", "--chunk-size", "2", "--n-ctx", "512",
            "--max-batch", "4", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def server(model_dir):
    srv, engine, batcher = serve.build(_argv(model_dir), max_new_tokens=12, decode_block=8)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", engine, batcher
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def _wav(audio) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _post(url, audio, response_format):
    bd = "portservetest"
    body = (f'--{bd}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n\r\n'
            ).encode() + _wav(audio)
    for name, value in (("response_format", response_format), ("language", "en"),
                        ("temperature", "0.000001")):
        body += (f'\r\n--{bd}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                 f"{value}").encode()
    body += f"\r\n--{bd}--\r\n".encode()
    req = urllib.request.Request(f"{url}/v1/audio/transcriptions", data=body,
                                 headers={"Content-Type": f"multipart/form-data; boundary={bd}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode("utf-8")


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_health_and_models(server):
    url, _, _ = server
    assert _get(f"{url}/health") == (200, {"status": "ok"})
    status, models = _get(f"{url}/v1/models")
    assert status == 200 and models["data"][0]["id"] == serve.MODEL_NAME


def test_concurrent_posts_equal_the_engine(server):
    url, engine, batcher = server
    # the 16 bit WAV round trip is what the server transcribes
    audios = [np.round(_audio(1.5, f) * 32767) / 32767 for f in (330.0, 550.0, 770.0)]
    formats = ["json", "text", "json"]
    with ThreadPoolExecutor(3) as pool:
        answers = list(pool.map(lambda a: _post(url, *a), zip(audios, formats)))
    for audio, fmt, (status, body) in zip(audios, formats, answers):
        assert status == 200
        text = json.loads(body)["text"] if fmt == "json" else body
        want = engine.asr(audio.astype(np.float32), context="", language="English",
                          chunk_size_sec=2.0, temperature=0.0).text
        assert text and text == want
    status, stats = _get(f"{url}/stats")
    assert stats["requests"] >= 3 and stats["batching"]["completed"] >= 3


def test_build_is_the_cli_path_and_loads_no_jax(model_dir):
    """The module and its build run without JAX; `--batch-mode off`
    serves on the engine alone."""
    import subprocess

    code = ("import sys; from qwen3_asr_gguf_tpu_torch.cli import serve; "
            f"s, e, b = serve.build({_argv(model_dir, '--batch-mode', 'off')!r}); "
            "assert b is None and s.batcher is None; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("extra", [("--mesh", "model=2")])
def test_not_ported_flags_raise(model_dir, extra):
    """`--mesh` without a torchrun world raises and says how to launch."""
    with pytest.raises(RuntimeError, match="torchrun"):
        serve.build(_argv(model_dir, *extra))


def test_mesh_model_1_serves_in_a_gloo_world_of_one(model_dir, world_of_one):
    """`--mesh model=1` in a gloo world of one rank: the lockstep batcher
    (rank 0 plans, nothing to follow) gives the plain batcher's greedy text;
    a mesh refuses the other batch modes."""
    audio = _audio(1.5, 440.0)
    texts = []
    for extra in ((), ("--mesh", "model=1")):
        _, engine, batcher = serve.build(_argv(model_dir, *extra), max_new_tokens=12,
                                         decode_block=8)
        try:
            assert batcher.lockstep == bool(extra) and batcher.leader
            texts.append(batcher.submit(audio, language="English", temperature=0.0).text)
        finally:
            batcher.close()
    assert texts[0] == texts[1] and texts[0]
    with pytest.raises(ValueError, match="continuous"):
        serve.build(_argv(model_dir, "--mesh", "model=1", "--batch-mode", "micro"))


def test_micro_mode_serves_concurrent_posts_as_one_batch(model_dir):
    """`--batch-mode micro` puts a MicroBatcher behind the server: three
    concurrent requests inside the gather window decode as one batch, each
    text equal to the engine's greedy transcript, and /stats reads the
    batcher's counters."""
    from qwen3_asr_gguf_tpu_torch.runtime.microbatch import MicroBatcher

    srv, engine, batcher = serve.build(
        _argv(model_dir, "--batch-mode", "micro", "--batch-window", "0.5"),
        max_new_tokens=12, decode_block=8)
    assert isinstance(batcher, MicroBatcher) and batcher.window_s == 0.5
    assert batcher.max_batch == 4 and engine.config.precision == "f32"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    audios = [np.round(_audio(1.5, f) * 32767) / 32767 for f in (330.0, 550.0, 770.0)]
    try:
        with ThreadPoolExecutor(3) as pool:
            answers = list(pool.map(lambda a: _post(url, a, "json"), audios))
        status, stats = _get(f"{url}/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    for audio, (code, body) in zip(audios, answers):
        want = engine.asr(audio.astype(np.float32), context="", language="English",
                          chunk_size_sec=2.0, temperature=0.0).text
        assert code == 200 and json.loads(body)["text"] == want and want
    assert stats["batches"] == batcher.n_batches >= 1
    assert stats["batched_requests"] == batcher.n_batched_requests >= 2


@pytest.mark.parametrize("extra", [("--batch-mode", "micro", "--batch-window", "0"),
                                   ("--batch-mode", "micro", "--max-batch", "1"),
                                   ("--batch-mode", "continuous", "--max-batch", "1")])
def test_no_batcher_without_a_window_or_a_batch(model_dir, extra):
    """`--batch-window 0` turns micro-batching off, and so does `--max-batch
    1` in either mode: the engine serves every request alone."""
    srv, _, batcher = serve.build(_argv(model_dir, *extra))
    assert batcher is None and srv.batcher is None


def test_no_fallback_to_another_device(model_dir, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build(_argv(model_dir)[:-2])  # the default device, cuda
