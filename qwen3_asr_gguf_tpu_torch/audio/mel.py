"""Log-mel spectrogram frontend (counterpart of
`qwen3_asr_gguf_tpu/audio/mel.py`).

Whisper-style semantics: reflect-pad (center), periodic Hann window, 400-pt
real DFT at hop 160, power spectrum, 128-bin slaney mel bank (0-8 kHz),
log10, dynamic-range clamp to (max - 8), (x + 4) / 4. The DFT is a dense
matmul. The numpy half (`mel_filterbank`, `_dft_constants`, `log_mel_np`) is
a copy of the JAX package's, which cannot be imported without JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_MELS = 128
F_MAX = 8_000.0


def _hz_to_mel_slaney(freq):
    f_sp = 200.0 / 3
    mels = np.asarray(freq, dtype=np.float64) / f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(
        np.asarray(freq) >= min_log_hz,
        min_log_mel + np.log(np.maximum(np.asarray(freq, dtype=np.float64), 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    freqs = np.asarray(mels, dtype=np.float64) * f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(
    sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS,
    f_min: float = 0.0, f_max: float = F_MAX,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank [n_freqs, n_mels]."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=2)
def _dft_constants(n_fft: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(window, dft_cos [n_fft, n_bins], dft_sin) as float32 host constants."""
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)  # periodic Hann
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = -2.0 * np.pi * n * k / n_fft
    return window, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def pad_signal_for_bucket(audio: np.ndarray, n_frames_bucket: int) -> np.ndarray:
    """Reflect-pad the exact slice (center padding) and zero-extend it to the
    bucket's framing span."""
    pad = N_FFT // 2
    y = np.pad(audio.astype(np.float32), pad, mode="reflect")
    out = np.zeros((n_frames_bucket + 3) * HOP, np.float32)
    out[: len(y)] = y[: len(out)]
    return out


def log_mel_np(audio: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Host (numpy) log-mel of an arbitrary-length signal -> [n_mels, T]."""
    window, dft_cos, dft_sin = _dft_constants(N_FFT)
    pad = N_FFT // 2
    y = np.pad(audio.astype(np.float32), pad, mode="reflect")
    num_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(num_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    frames = y[idx] * window
    re = frames @ dft_cos
    im = frames @ dft_sin
    power = re * re + im * im
    mel = power @ filters
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = log_spec[: audio.shape[-1] // HOP]
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return (((log_spec + 4.0) / 4.0).T).astype(np.float32)


def valid_frame_mask(valid_frames, n_frames: int, device) -> torch.Tensor:
    """[B, n_frames, 1] bool, frame f of signal b valid below `valid_frames`
    (an int, one per signal, or an int tensor on `device`, read there: a
    captured encode's mask follows its device buffer)."""
    vf = torch.as_tensor(valid_frames, device=device).reshape(-1, 1, 1)
    return torch.arange(n_frames, device=device)[None, :, None] < vf


class LogMelFrontend:
    """audio -> [n_mels, T] log-mel on the audio tensor's device."""

    def __init__(self, filters: np.ndarray | None = None, device="cpu"):
        self.filters = np.asarray(filters if filters is not None else mel_filterbank(), np.float32)
        window, dft_cos, dft_sin = _dft_constants(N_FFT)
        self._filters = torch.from_numpy(self.filters).to(device)
        self._window = torch.from_numpy(window).to(device)
        self._dft = torch.from_numpy(np.concatenate([dft_cos, dft_sin], axis=1)).to(device)

    def _power_mel(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [..., F, N_FFT] (unwindowed) -> log10 mel power [..., F, n_mels]."""
        spec = torch.matmul(frames * self._window, self._dft)  # [..., F, 2*n_bins]
        n_bins = spec.shape[-1] // 2
        re, im = spec[..., :n_bins], spec[..., n_bins:]
        mel = torch.matmul(re * re + im * im, self._filters)
        return torch.log10(torch.clamp(mel, min=1e-10))

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [..., n] f32 -> [..., n_mels, n // HOP] (the `_log_mel_jit`
        frames); a leading batch axis holds same-length signals."""
        pad = N_FFT // 2
        lead = audio.shape[:-1]
        y = F.pad(audio.float().reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
        frames = y[:, 0].unfold(-1, N_FFT, HOP)  # [B, F, N_FFT]
        log_spec = self._power_mel(frames)[:, : audio.shape[-1] // HOP]
        log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
        return ((log_spec + 4.0) / 4.0).transpose(1, 2).reshape(*lead, N_MELS, -1)

    def padded(self, y: torch.Tensor, valid_frames, n_frames_bucket: int) -> torch.Tensor:
        """Bucketed log-mel (the `_log_mel_padded_jit` frames): y [..., L] is
        the `pad_signal_for_bucket` signal and `valid_frames` an int or one
        per signal; frames >= valid_frames are zeroed and the range clamp
        maxes over the valid frames only."""
        lead = y.shape[:-1]
        frames = y.float().reshape(-1, y.shape[-1]).unfold(-1, N_FFT, HOP)[:, :n_frames_bucket]
        log_spec = self._power_mel(frames)  # [B, F, n_mels]
        valid = valid_frame_mask(valid_frames, n_frames_bucket, y.device)
        vmax = torch.where(valid, log_spec, torch.full_like(log_spec, -float("inf"))).amax(
            dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, vmax - 8.0)
        out = torch.where(valid, (log_spec + 4.0) / 4.0, torch.zeros_like(log_spec))
        return out.transpose(1, 2).reshape(*lead, self._filters.shape[1], n_frames_bucket)
