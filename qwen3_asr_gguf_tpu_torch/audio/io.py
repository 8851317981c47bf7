"""Audio loading: file -> float32 mono 16 kHz PCM.

Replaces the reference's pydub/ffmpeg loader (qwen_asr_gguf/inference/
utils.py:57-81): WAV files decode through the stdlib, anything else shells
out to ffmpeg when present. Also accepts raw (array, sr) pairs and base64
payloads like the official package (qwen_asr/inference/utils.py).
"""

from __future__ import annotations

import base64
import io
import shutil
import subprocess
import wave
from typing import Optional, Union

import numpy as np

SAMPLE_RATE = 16_000

MAX_ASR_INPUT_SECONDS = 1200.0
MAX_FORCE_ALIGN_INPUT_SECONDS = 180.0
MIN_INPUT_SECONDS = 0.5


def resample(audio: np.ndarray, src_sr: int, dst_sr: int = SAMPLE_RATE) -> np.ndarray:
    if src_sr == dst_sr:
        return audio.astype(np.float32, copy=False)
    try:
        from scipy.signal import resample_poly

        from math import gcd

        g = gcd(src_sr, dst_sr)
        out = resample_poly(audio.astype(np.float64), dst_sr // g, src_sr // g)
        return out.astype(np.float32)
    except ImportError:  # linear fallback
        n_out = int(round(len(audio) * dst_sr / src_sr))
        x_old = np.linspace(0.0, 1.0, len(audio), endpoint=False)
        x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
        return np.interp(x_new, x_old, audio).astype(np.float32)


def _load_wav(data: bytes) -> tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width == 2:
        audio = np.frombuffer(frames, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(frames, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    return audio, sr


def _load_via_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and ffmpeg is not installed"
        )
    cmd = [
        ffmpeg, "-nostdin", "-v", "error", "-i", path,
        "-f", "f32le", "-ac", "1", "-ar", str(sample_rate), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.float32).copy()


def load_audio(
    source: Union[str, bytes, tuple, np.ndarray],
    sample_rate: int = SAMPLE_RATE,
    start_second: Optional[float] = None,
    duration: Optional[float] = None,
) -> np.ndarray:
    """Load audio from a path / raw bytes / (array, sr) / base64 data-URI.

    Returns float32 mono at `sample_rate`, optionally windowed by
    `start_second`/`duration` (reference utils.py:57-81 API).
    """
    if isinstance(source, tuple):
        arr, sr = source
        audio = resample(np.asarray(arr, dtype=np.float32).reshape(-1), int(sr), sample_rate)
    elif isinstance(source, np.ndarray):
        audio = source.astype(np.float32).reshape(-1)
    elif isinstance(source, (bytes, bytearray)):
        audio, sr = _load_wav(bytes(source))
        audio = resample(audio, sr, sample_rate)
    else:
        path = str(source)
        if path.startswith("data:audio"):
            payload = base64.b64decode(path.split(",", 1)[1])
            audio, sr = _load_wav(payload)
            audio = resample(audio, sr, sample_rate)
        elif path.startswith(("http://", "https://")):
            # URL source (reference qwen_asr/inference/utils.py accepts
            # http(s) audio); fetched to memory, decoded like bytes/ffmpeg
            import urllib.request

            with urllib.request.urlopen(path, timeout=30) as resp:
                payload = resp.read()
            if payload[:4] == b"RIFF" and payload[8:12] == b"WAVE":
                audio, sr = _load_wav(payload)
                audio = resample(audio, sr, sample_rate)
            else:
                import tempfile

                with tempfile.NamedTemporaryFile(suffix=".audio") as tmp:
                    tmp.write(payload)
                    tmp.flush()
                    audio = _load_via_ffmpeg(tmp.name, sample_rate)
        else:
            try:
                with open(path, "rb") as f:
                    head = f.read(12)
                is_wav = head[:4] == b"RIFF" and head[8:12] == b"WAVE"
            except OSError:
                raise FileNotFoundError(path)
            if is_wav:
                with open(path, "rb") as f:
                    audio, sr = _load_wav(f.read())
                audio = resample(audio, sr, sample_rate)
            else:
                audio = _load_via_ffmpeg(path, sample_rate)

    if start_second:
        audio = audio[int(start_second * sample_rate):]
    if duration:
        audio = audio[: int(duration * sample_rate)]
    return np.ascontiguousarray(audio, dtype=np.float32)
