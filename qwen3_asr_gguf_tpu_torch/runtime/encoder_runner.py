"""Audio-encoder executor (counterpart of
`qwen3_asr_gguf_tpu/runtime/encoder_runner.py`): mel -> conv frontend ->
transformer backend on the engine's device.

Audio whose length is whole seconds and whole conv windows (the engine's
zero-padded chunks) runs at its own length with no key mask; any other
length is reflect-padded into a 5-second mel bucket and its padding keys are
masked, so the valid rows equal the unpadded encode. Serving admission
encodes audios of one `batch_key` as one batch (`encode_batch_async`).
PyTorch queues device work asynchronously, so `encode_async` is `encode`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.mel import HOP, LogMelFrontend, pad_signal_for_bucket
from ..models import encoder as enc
from ..models.configs import AudioEncoderConfig
from ..ops.qtensor import Int8Weight, Q4Weight

SAMPLE_RATE = 16_000


class EncoderRunner:
    def __init__(self, params: dict, cfg: AudioEncoderConfig, *,
                 mel_filters: np.ndarray | None = None, bucket_frames: int = 500,
                 device="cpu"):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.frontend = LogMelFrontend(filters=mel_filters, device=self.device)
        self.bucket_frames = max(cfg.n_window, bucket_frames // cfg.n_window * cfg.n_window)
        # a quantized encoder runs its backend in bf16 on the card and in f32
        # elsewhere (the JAX package's TPU / non-TPU split); norms and GELU
        # compute in f32 either way
        quantized = isinstance(params.get("proj1_w"), (Int8Weight, Q4Weight))
        self.compute_dtype = (
            torch.bfloat16 if quantized and self.device.type == "cuda" else None
        )

    def _backend(self, hidden: torch.Tensor, valid_tokens: int | None = None) -> torch.Tensor:
        if self.compute_dtype is not None:
            hidden = hidden.to(self.compute_dtype)
        return enc.backend_transformer(self.params, self.cfg, hidden, valid_tokens=valid_tokens)

    def encode(self, audio) -> torch.Tensor:
        """audio [n] -> [t_padded, output_dim]; the first
        `valid_tokens(n)` rows are meaningful."""
        n = int(audio.shape[-1])
        frames = n // HOP
        if frames == 0:
            raise ValueError("audio shorter than one mel hop (10 ms)")
        if n % SAMPLE_RATE == 0 and frames % self.cfg.n_window == 0:
            audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
            hidden = enc.conv_frontend(self.params, self.cfg, self.frontend(audio))
            return self._backend(hidden)
        bucket = self.mel_bucket(frames)
        host = audio.cpu().numpy() if isinstance(audio, torch.Tensor) else np.asarray(audio)
        y = torch.from_numpy(pad_signal_for_bucket(host, bucket)).to(self.device)
        mel = self.frontend.padded(y, frames, bucket)
        hidden = enc.conv_frontend(self.params, self.cfg, mel)
        valid = enc.get_feat_extract_output_lengths(frames, self.cfg.n_window)
        return self._backend(hidden, valid_tokens=valid)

    encode_async = encode

    def batch_key(self, audio) -> tuple:
        """Grouping key for `encode_batch_async`: audios with equal keys take
        the same path at the same shapes."""
        n = int(audio.shape[-1])
        frames = max(n // HOP, 1)
        if n % SAMPLE_RATE == 0 and frames % self.cfg.n_window == 0:
            return ("aligned", n)
        return ("varlen", self.mel_bucket(frames))

    def encode_batch_async(self, audios: list) -> list:
        """Same-`batch_key` host audios as one batch -> per-audio
        [t_padded, output_dim] (the first `valid_tokens(len)` rows of each
        meaningful)."""
        keys = {self.batch_key(a) for a in audios}
        if len(keys) != 1:
            raise ValueError(f"mixed encode batch keys: {keys}")
        kind, _ = keys.pop()
        if kind == "aligned":
            ys = torch.from_numpy(np.stack([np.asarray(a, np.float32) for a in audios]))
            hidden = enc.conv_frontend(self.params, self.cfg, self.frontend(ys.to(self.device)))
            out = self._backend(hidden)
        else:
            frames = [max(int(a.shape[-1]) // HOP, 1) for a in audios]
            bucket = self.mel_bucket(max(frames))
            ys = np.stack([pad_signal_for_bucket(np.asarray(a, np.float32), bucket)
                           for a in audios])
            mel = self.frontend.padded(torch.from_numpy(ys).to(self.device), frames, bucket)
            hidden = enc.conv_frontend(self.params, self.cfg, mel)
            valids = [enc.get_feat_extract_output_lengths(f, self.cfg.n_window) for f in frames]
            out = self._backend(hidden, valid_tokens=valids)
        return list(out.unbind(0))

    def mel_bucket(self, frames: int) -> int:
        """Linear 5 s frame buckets up to 50 s, then doubling."""
        b = self.bucket_frames
        while b < frames:
            b = b + self.bucket_frames if b < 5000 else b * 2
        return b

    def valid_tokens(self, audio_len: int) -> int:
        return enc.get_feat_extract_output_lengths(audio_len // HOP, self.cfg.n_window)
