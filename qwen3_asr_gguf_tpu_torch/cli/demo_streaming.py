"""Browser streaming-ASR demo on the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/cli/demo_streaming.py).

The same page, session store (TTL garbage collection) and endpoints: the
page captures microphone audio with the WebAudio API, posts 16 kHz PCM
chunks as base64 f32 to /api/chunk, and renders the transcript as it grows;
/api/start opens a session and /api/finish flushes it.

  python -m qwen3_asr_gguf_tpu_torch.cli.demo_streaming --model-dir model/ --port 8080 \\
      [--prec int8] [--device cuda|cpu]

`ThreadingHTTPServer` answers each request on its own thread. The engine
would be right under sessions that feed it at once (each decode prefills a
KV cache of its own, `Generator.start_spliced`, and the engine writes no
other state across calls), but `SessionStore` feeds and finishes one at a
time, on one lock: two decodes interleaved on the host run each chunk
several times slower than in turn (on an H100, PERF.md, PR 10), and the page
posts a session's next chunk without waiting for the answer to the last, so
two requests of one session could otherwise feed its state at once.
`--device` names the torch device; there is no fallback to another one.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .device import cli_device

SESSION_TTL_S = 300.0

PAGE = """<!doctype html>
<meta charset="utf-8"><title>Qwen3-ASR TPU streaming demo</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2rem auto}
#t{border:1px solid #ccc;min-height:8rem;padding:1rem;white-space:pre-wrap}</style>
<h2>Qwen3-ASR TPU &mdash; live transcription</h2>
<button id="b">start</button> <span id="s"></span>
<div id="t"></div>
<script>
let ctx, node, sid = null, running = false;
const b = document.getElementById('b'), t = document.getElementById('t'), s = document.getElementById('s');
async function post(p, body) {
  const r = await fetch(p, {method:'POST', headers:{'Content-Type':'application/json'},
                            body: JSON.stringify(body||{})});
  return r.json();
}
b.onclick = async () => {
  if (running) {
    running = false; b.textContent = 'start';
    node && node.disconnect(); ctx && ctx.close();
    const r = await post('/api/finish', {sid}); t.textContent = r.text; s.textContent = 'done';
    return;
  }
  const st = await post('/api/start'); sid = st.sid;
  const stream = await navigator.mediaDevices.getUserMedia({audio:true});
  ctx = new AudioContext({sampleRate: 16000});
  const src = ctx.createMediaStreamSource(stream);
  node = ctx.createScriptProcessor(4096, 1, 1);
  node.onaudioprocess = async (e) => {
    if (!running) return;
    const pcm = e.inputBuffer.getChannelData(0);
    const b64 = btoa(String.fromCharCode(...new Uint8Array(new Float32Array(pcm).buffer)));
    const r = await post('/api/chunk', {sid, pcm: b64});
    if (r.text !== undefined) t.textContent = r.text;
  };
  src.connect(node); node.connect(ctx.destination);
  running = true; b.textContent = 'stop'; s.textContent = 'listening...';
};
</script>"""


class SessionStore:
    def __init__(self, transcriber):
        self.transcriber = transcriber
        self.sessions: dict[str, dict] = {}
        self.lock = threading.Lock()  # the session table
        self.engine_lock = threading.Lock()  # one feed or finish on the engine at a time

    def gc(self) -> None:
        now = time.time()
        with self.lock:
            dead = [k for k, v in self.sessions.items() if now - v["ts"] > SESSION_TTL_S]
            for k in dead:
                del self.sessions[k]

    def start(self) -> str:
        self.gc()
        sid = uuid.uuid4().hex[:12]
        with self.lock:
            self.sessions[sid] = {"state": self.transcriber.init_state(), "ts": time.time()}
        return sid

    def chunk(self, sid: str, pcm: np.ndarray) -> str:
        with self.lock:
            sess = self.sessions.get(sid)
        if sess is None:
            raise KeyError(sid)
        sess["ts"] = time.time()
        with self.engine_lock:
            self.transcriber.feed(sess["state"], pcm)
            return sess["state"].text

    def finish(self, sid: str) -> str:
        with self.lock:
            sess = self.sessions.pop(sid, None)
        if sess is None:
            return ""
        with self.engine_lock:
            return self.transcriber.finish(sess["state"])


def make_handler(store: SessionStore):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})
            if self.path == "/api/start":
                return self._json(200, {"sid": store.start()})
            if self.path == "/api/chunk":
                try:
                    pcm = np.frombuffer(
                        base64.b64decode(payload.get("pcm", "")), dtype=np.float32
                    )
                    text = store.chunk(payload.get("sid", ""), pcm)
                    return self._json(200, {"text": text})
                except KeyError:
                    return self._json(404, {"error": "unknown session"})
            if self.path == "/api/finish":
                return self._json(200, {"text": store.finish(payload.get("sid", ""))})
            return self._json(404, {"error": "not found"})

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qwen3_asr_gguf_tpu_torch.cli.demo_streaming")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--prec", default="int8")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--language", default=None)
    p.add_argument("--chunk-sec", type=float, default=2.0)
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p


def build(argv=None, **engine_config) -> tuple[SessionStore, argparse.Namespace]:
    """(session store, parsed arguments) from command-line arguments;
    `engine_config` overrides fields of the engine's `ASREngineConfig`."""
    args = build_parser().parse_args(argv)
    device = cli_device(args.device, "the demo")

    from ..runtime.engine import QwenASREngine
    from ..runtime.streaming import StreamingTranscriber
    from ..schema import ASREngineConfig
    from .transcribe import _resolve_llm_fn

    cfg = ASREngineConfig(
        model_dir=args.model_dir,
        llm_fn=_resolve_llm_fn(args.model_dir, args.prec),
        precision=args.prec, verbose=False,
    )
    for name, value in engine_config.items():
        setattr(cfg, name, value)
    engine = QwenASREngine(cfg, device=device)
    transcriber = StreamingTranscriber(engine, chunk_size_sec=args.chunk_sec,
                                       language=args.language)
    return SessionStore(transcriber), args


def main(argv=None) -> int:
    store, args = build(argv)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(store))
    print(f"demo at http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
