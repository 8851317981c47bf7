"""OpenAI-compatible transcription server.

Mirrors the reference FastAPI server (serve_openai_gguf.py:202-337) on the
stdlib http.server (FastAPI/uvicorn aren't dependencies):

  POST /v1/audio/transcriptions   multipart: file, model, language (ISO),
                                  prompt, temperature, response_format
                                  (json | text | srt | vtt | verbose_json)
  GET  /v1/models | /health | /stats

Reference behaviors kept: temperature 0 -> 0.4 remap (:98-100), ISO-639-1
language resolution (:31-42), verbose_json word+segment synthesis
(:112-161), in-memory stats ring of 50 (:51-58). One shared engine;
requests serialize on an engine lock (the reference's async handlers call
the blocking engine too, SURVEY.md §2.2).
"""

from __future__ import annotations

import json
import re
import tempfile
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler
from pathlib import Path


def parse_multipart(body: bytes, content_type: str) -> dict[str, tuple[str | None, bytes]]:
    """Minimal multipart/form-data parser -> {name: (filename, payload)}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts: dict[str, tuple[str | None, bytes]] = {}
    for chunk in body.split(b"--" + boundary):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--":
            continue
        if b"\r\n\r\n" not in chunk:
            continue
        header_blob, payload = chunk.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", errors="replace")
        nm = re.search(r'name="([^"]+)"', headers)
        if not nm:
            continue
        fm = re.search(r'filename="([^"]*)"', headers)
        parts[nm.group(1)] = (fm.group(1) if fm else None, payload)
    return parts


def synthesize_verbose_json(result, duration: float, language: str) -> dict:
    """words + segments from alignment (reference serve_openai_gguf.py:112-161)."""
    words = []
    segments = []
    if result.alignment:
        for it in result.alignment.items:
            if it.text.strip():
                words.append({"word": it.text, "start": round(it.start_time, 3),
                              "end": round(it.end_time, 3)})
        seg_words: list[dict] = []
        seg_start = 0.0
        sid = 0
        for w in words:
            if not seg_words:
                seg_start = w["start"]
            seg_words.append(w)
            if re.search(r"[，。？！,.?!]$", w["word"]) or len(seg_words) >= 30:
                segments.append({
                    "id": sid, "start": seg_start, "end": w["end"],
                    "text": "".join(x["word"] for x in seg_words),
                })
                sid += 1
                seg_words = []
        if seg_words:
            segments.append({
                "id": sid, "start": seg_start, "end": seg_words[-1]["end"],
                "text": "".join(x["word"] for x in seg_words),
            })
    return {
        "task": "transcribe",
        "language": language or "",
        "duration": round(duration, 3),
        "text": result.text,
        "words": words,
        "segments": segments,
    }


class ASRServer:
    def __init__(self, engine, model_name: str = "qwen3-asr-tpu", batcher=None):
        self.engine = engine
        self.model_name = model_name
        self.batcher = batcher  # MicroBatcher: concurrent short requests
        self.lock = threading.Lock()
        self.stats_ring: deque = deque(maxlen=50)
        self.started = time.time()
        self.n_requests = 0

    # -- request handling --------------------------------------------------

    def handle_transcription(self, form: dict) -> tuple[int, str, str]:
        from ..audio.io import load_audio
        from ..text import exporters
        from ..utils.languages import resolve_language

        if "file" not in form:
            return 400, "application/json", json.dumps(
                {"error": {"message": "missing 'file' form field", "type": "invalid_request_error"}}
            )
        filename, payload = form["file"]

        def field(name, default=""):
            return form[name][1].decode("utf-8", errors="replace") if name in form else default

        try:
            language = resolve_language(field("language") or None)
        except ValueError as e:
            return 400, "application/json", json.dumps(
                {"error": {"message": str(e), "type": "invalid_request_error"}}
            )
        prompt = field("prompt")
        response_format = field("response_format", "json")
        try:
            temperature = float(field("temperature", "0") or 0)
        except ValueError:
            temperature = 0.0
        if temperature <= 0:
            temperature = 0.4  # reference remap (:98-100)

        suffix = Path(filename or "audio.wav").suffix or ".wav"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
            tmp.write(payload)
            tmp_path = tmp.name
        try:
            audio = load_audio(tmp_path)
            duration = len(audio) / 16_000
            t0 = time.time()
            # continuous batching serves every format concurrently: long
            # audio chunks through successive rows and srt/vtt/verbose_json
            # align on the batcher's align pool (the reference server
            # serialized all of this on one engine, serve_openai_gguf.py:249;
            # the micro batcher still handles short json/text only)
            wants_ts = response_format in ("srt", "vtt", "verbose_json")
            if (
                self.batcher is not None
                and self.batcher.eligible(audio)
                and (not wants_ts
                     or getattr(self.batcher, "supports_timestamps", False))
            ):
                kwargs = {"timestamps": True} if wants_ts else {}
                result = self.batcher.submit(
                    audio, context=prompt or "", language=language,
                    temperature=temperature, **kwargs,
                )
            else:
                with self.lock:
                    result = self.engine.asr(
                        audio,
                        context=prompt or "",
                        language=language,
                        chunk_size_sec=self.engine.config.chunk_size,
                        memory_chunks=self.engine.config.memory_num,
                        temperature=temperature,
                    )
            elapsed = time.time() - t0
        except Exception as e:  # pragma: no cover
            return 500, "application/json", json.dumps(
                {"error": {"message": f"transcription failed: {e}", "type": "server_error"}}
            )
        finally:
            Path(tmp_path).unlink(missing_ok=True)

        self.n_requests += 1
        self.stats_ring.append({
            "id": str(uuid.uuid4())[:8],
            "duration": round(duration, 2),
            "elapsed": round(elapsed, 2),
            "rtf": round(elapsed / duration, 4) if duration else 0,
            "language": language or "",
            "ts": time.time(),
        })

        if response_format == "text":
            return 200, "text/plain; charset=utf-8", result.text
        if response_format == "srt":
            return 200, "text/plain; charset=utf-8", exporters.alignment_to_srt(
                result.alignment.items if result.alignment else None
            )
        if response_format == "vtt":
            return 200, "text/vtt; charset=utf-8", exporters.alignment_to_vtt(
                result.alignment.items if result.alignment else None
            )
        if response_format == "verbose_json":
            return 200, "application/json", json.dumps(
                synthesize_verbose_json(result, duration, language or ""), ensure_ascii=False
            )
        return 200, "application/json", json.dumps({"text": result.text}, ensure_ascii=False)

    def stats(self) -> dict:
        out = {
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.n_requests,
            "history": list(self.stats_ring),
        }
        if self.batcher is not None:
            if hasattr(self.batcher, "stats"):  # ContinuousBatcher
                out["batching"] = self.batcher.stats
            else:  # MicroBatcher
                out["batches"] = self.batcher.n_batches
                out["batched_requests"] = self.batcher.n_batched_requests
        return out


# file-upload demo page (the reference's Gradio upload UI, qwen_asr/cli/
# demo.py, as a dependency-free page on the stdlib server; the mic demo
# lives in cli/demo_streaming.py)
DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Qwen3-ASR TPU demo</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:2rem auto;padding:0 1rem}
 fieldset{border:1px solid #ccc;border-radius:8px;margin-bottom:1rem}
 label{display:inline-block;margin:.3rem 1rem .3rem 0}
 #out{white-space:pre-wrap;background:#f6f6f6;border-radius:8px;padding:1rem;min-height:4rem}
 button{padding:.5rem 1.2rem;border-radius:6px;border:1px solid #888;cursor:pointer}
 .busy{opacity:.5;pointer-events:none}
</style></head><body>
<h2>Qwen3-ASR transcription demo</h2>
<fieldset><legend>Input</legend>
 <input type="file" id="file" accept="audio/*">
</fieldset>
<fieldset><legend>Options</legend>
 <label>Language
  <select id="lang"><option value="">auto</option><option>Chinese</option>
  <option>English</option><option>Japanese</option><option>Korean</option>
  <option>German</option><option>French</option><option>Spanish</option>
  <option>Russian</option><option>Arabic</option><option>Portuguese</option></select></label>
 <label>Format
  <select id="fmt"><option>json</option><option>text</option><option>srt</option>
  <option>vtt</option><option>verbose_json</option></select></label>
 <label>Temperature <input id="temp" type="number" value="0.4" step="0.1" min="0" max="2" style="width:4rem"></label>
 <label>Context <input id="ctx" type="text" placeholder="optional prompt" style="width:14rem"></label>
</fieldset>
<button id="go">Transcribe</button> <span id="status"></span>
<h3>Result</h3><div id="out"></div>
<script>
const $=id=>document.getElementById(id);
$('go').onclick=async()=>{
  const f=$('file').files[0];
  if(!f){$('status').textContent='choose an audio file first';return;}
  const fd=new FormData();
  fd.append('file',f);
  fd.append('response_format',$('fmt').value);
  fd.append('temperature',$('temp').value);
  if($('lang').value)fd.append('language',$('lang').value);
  if($('ctx').value)fd.append('prompt',$('ctx').value);
  $('go').classList.add('busy');$('status').textContent='transcribing...';
  const t0=performance.now();
  try{
    const r=await fetch('/v1/audio/transcriptions',{method:'POST',body:fd});
    const body=await r.text();
    let shown=body;
    try{const j=JSON.parse(body);shown=j.text!==undefined?j.text:JSON.stringify(j,null,2);}catch(e){}
    $('out').textContent=shown;
    $('status').textContent=(r.ok?'done':'error '+r.status)+' in '+((performance.now()-t0)/1000).toFixed(1)+'s';
  }catch(e){$('status').textContent='request failed: '+e;}
  $('go').classList.remove('busy');
};
</script></body></html>
"""


def make_handler(server: ASRServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, ctype: str, body: str) -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # quieter default
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, "application/json", json.dumps({"status": "ok"}))
            elif self.path in ("/demo", "/demo/"):
                self._send(200, "text/html; charset=utf-8", DEMO_HTML)
            elif self.path == "/stats":
                self._send(200, "application/json", json.dumps(server.stats()))
            elif self.path == "/v1/models":
                self._send(200, "application/json", json.dumps({
                    "object": "list",
                    "data": [{"id": server.model_name, "object": "model",
                              "created": int(server.started), "owned_by": "local"}],
                }))
            else:
                self._send(404, "application/json", json.dumps({"error": {"message": "not found"}}))

        def do_POST(self):
            if self.path != "/v1/audio/transcriptions":
                self._send(404, "application/json", json.dumps({"error": {"message": "not found"}}))
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            try:
                form = parse_multipart(body, ctype)
            except ValueError as e:
                self._send(400, "application/json",
                           json.dumps({"error": {"message": str(e)}}))
                return
            code, out_type, out = server.handle_transcription(form)
            self._send(code, out_type, out)

    return Handler
