"""Audio-encoder executor (counterpart of
`qwen3_asr_gguf_tpu/runtime/encoder_runner.py`): mel -> conv frontend ->
transformer backend on the engine's device.

Audio whose length is whole seconds and whole conv windows (the engine's
zero-padded chunks) runs at its own length with no key mask; any other
length is reflect-padded into a 5-second mel bucket and its padding keys are
masked, so the valid rows equal the unpadded encode. Serving admission
encodes audios of one `batch_key` as one batch (`encode_batch_async`).
PyTorch queues device work asynchronously, so `encode_async` is `encode`.

On the card `encode` replays one captured CUDA graph per input key
(`encode_key`: the aligned length, or the mel bucket), captured at the
key's first use: the same kernels as the eager encode, on static buffers
(the signal, and the valid mel frames and encoder tokens from which the
graph builds its masks). Counters `encode.calls`, `encode.graph_replays`,
`encode.graph_captures`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..audio.mel import HOP, LogMelFrontend, pad_signal_for_bucket
from ..models import encoder as enc
from ..models.configs import AudioEncoderConfig
from ..ops import _build
from ..ops.qtensor import Int8Weight, Q4Weight
from ..utils import profiling

SAMPLE_RATE = 16_000


def _host(audio) -> np.ndarray:
    return audio.cpu().numpy() if isinstance(audio, torch.Tensor) else np.asarray(audio)


class EncodeGraph:
    """One input key's static buffers and, once captured, its CUDA graph:
    `sig` the signal at the key's length (f32), `lens` the valid mel frames
    and encoder tokens (int32; read by the bucketed key's masks), `out` the
    graph's output, and the kernel launches its capture tallied
    (`ops._build.capture_tally`), added to the wrappers' counts at each
    replay."""

    def __init__(self, n_signal: int, device):
        self.sig = torch.zeros(n_signal, dtype=torch.float32, device=device)
        self.lens = torch.zeros(2, dtype=torch.int32, device=device)
        self.graph = self.out = None
        self.launches: dict = {}

    def valid(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(valid mel frames, valid encoder tokens), one-element views."""
        return self.lens[0:1], self.lens[1:2]

    def replay(self) -> torch.Tensor:
        """Run the graph; a copy of its output (the next replay overwrites
        `out`)."""
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.out.clone()


class EncoderRunner:
    def __init__(self, params: dict, cfg: AudioEncoderConfig, *,
                 mel_filters: np.ndarray | None = None, bucket_frames: int = 500,
                 device="cuda", cuda_graphs: bool = True):
        """`cuda_graphs`: replay each key's encode as a captured CUDA graph
        (on the card only; False for an eager comparison)."""
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
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self.graphs: dict[tuple, EncodeGraph] = {}
        # one replay at a time on the static buffers and the shared pool
        self._graph_lock = threading.Lock()
        self._graph_pool = self._capture_stream = self._copied = None

    def _backend(self, hidden: torch.Tensor, valid_tokens: int | None = None) -> torch.Tensor:
        if self.compute_dtype is not None:
            hidden = hidden.to(self.compute_dtype)
        return enc.backend_transformer(self.params, self.cfg, hidden, valid_tokens=valid_tokens)

    def encode_key(self, n: int, bucketed: bool = False) -> tuple:
        """The shape key of an `n`-sample encode: ("aligned", n) for whole
        seconds of whole conv windows (unless `bucketed`), else ("bucket",
        its mel bucket)."""
        frames = n // HOP
        if not bucketed and n % SAMPLE_RATE == 0 and frames % self.cfg.n_window == 0:
            return ("aligned", n)
        return ("bucket", self.mel_bucket(frames))

    def encode(self, audio, *, bucketed: bool = False) -> torch.Tensor:
        """audio [n] -> [t_padded, output_dim]; the first
        `valid_tokens(n)` rows are meaningful. `bucketed=True` takes the
        bucket-padded branch for aligned audio too (a streaming session's
        growing audio then meets a few bucket shapes, not one per length).
        With `cuda_graphs` the key's graph replays; a key not yet captured
        runs eagerly inside a `torch.profiler` session."""
        n = int(audio.shape[-1])
        frames = n // HOP
        if frames == 0:
            raise ValueError("audio shorter than one mel hop (10 ms)")
        profiling.count("encode.calls")
        key = self.encode_key(n, bucketed)
        if self.cuda_graphs and (key in self.graphs or not profiling.profiler_active()):
            with self._graph_lock:
                return self._graphed(key, audio, frames)
        if key[0] == "aligned":
            return self._body(key, torch.as_tensor(audio, dtype=torch.float32, device=self.device))
        y = torch.from_numpy(pad_signal_for_bucket(_host(audio), key[1])).to(self.device)
        return self._body(key, y, (frames, enc.get_feat_extract_output_lengths(
            frames, self.cfg.n_window)))

    def _body(self, key: tuple, sig: torch.Tensor, valid=None) -> torch.Tensor:
        """The encode of one signal at `key`'s shape: the eager path and the
        graph's body. `valid` (bucketed key): (mel frames, encoder tokens),
        ints or one-element device tensors."""
        if key[0] == "aligned":
            return self._backend(enc.conv_frontend(self.params, self.cfg, self.frontend(sig)))
        mel = self.frontend.padded(sig, valid[0], key[1])
        return self._backend(enc.conv_frontend(self.params, self.cfg, mel),
                             valid_tokens=valid[1])

    def signal_len(self, key: tuple) -> int:
        """Samples of the signal `_body` takes at `key`."""
        return key[1] if key[0] == "aligned" else (key[1] + 3) * HOP

    @staticmethod
    def _upload(dst: torch.Tensor, host: torch.Tensor) -> None:
        """Host -> `dst` without a host wait (through pinned memory)."""
        if dst.is_cuda:
            host = host.pin_memory()
        dst.copy_(host, non_blocking=True)

    def _load(self, g: EncodeGraph, key: tuple, audio, frames: int) -> None:
        """`audio` into `g`'s static buffers: the signal (reflect-padded to
        the bucket as the eager path pads it) and its valid lengths."""
        if key[0] == "aligned":
            if isinstance(audio, torch.Tensor) and audio.device.type == g.sig.device.type:
                g.sig.copy_(audio)
            else:
                self._upload(g.sig, torch.as_tensor(_host(audio), dtype=torch.float32))
            return
        self._upload(g.sig, torch.from_numpy(pad_signal_for_bucket(_host(audio), key[1])))
        valid = enc.get_feat_extract_output_lengths(frames, self.cfg.n_window)
        self._upload(g.lens, torch.tensor([frames, valid], dtype=torch.int32))

    def _graphed(self, key: tuple, audio, frames: int) -> torch.Tensor:
        """The encode as a replay of `key`'s graph, captured at its first
        use (counters `encode.graph_captures`, `encode.graph_replays`). The
        static buffers are refilled only once the last replay's output has
        been copied out, on whatever stream that ran."""
        stream = torch.cuda.current_stream(self.device)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        else:
            stream.wait_event(self._copied)
        g = self.graphs.get(key)
        fresh = g is None
        if fresh:
            g = EncodeGraph(self.signal_len(key), self.device)
        self._load(g, key, audio, frames)
        if fresh:
            self._capture(g, key)
            self.graphs[key] = g
        out = g.replay()
        self._copied.record(stream)
        profiling.count("encode.graph_replays")
        return out

    def _capture(self, g: EncodeGraph, key: tuple) -> None:
        """Run the body once eagerly on the capture stream (which warms
        that stream up, as capture needs), then capture it on `g`'s
        buffers into a graph of this runner's pool; nothing of the capture
        runs."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side, main = self._capture_stream, torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body(key, g.sig, g.valid())
            with _build.capture_tally() as launches:
                # thread-local: the other threads (decode, the align
                # worker) may queue work meanwhile
                graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                try:
                    out = self._body(key, g.sig, g.valid())
                finally:
                    graph.capture_end()
        main.wait_stream(side)
        g.graph, g.out, g.launches = graph, out, launches
        profiling.count("encode.graph_captures")

    encode_async = encode

    def batch_key(self, audio) -> tuple:
        """Grouping key for `encode_batch_async`: audios with equal keys take
        the same path at the same shapes (`encode_key`)."""
        return self.encode_key(max(int(audio.shape[-1]), HOP))

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
