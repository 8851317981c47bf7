"""Qwen3-ASR on PyTorch and CUDA: the port of `qwen3_asr_gguf_tpu` (JAX on a
TPU) to one NVIDIA Hopper GPU.

Same public API as the JAX package (`QwenASREngine` with the shared
`ASREngineConfig`), with an explicit torch device. Modules that import no
JAX (formats, text, schema, configs, the native codec) are shared with the
JAX package; everything else is ported, and the Pallas kernels of the main
path are hand-written CUDA kernels in `csrc/`, built with nvcc at first use.
This package never imports JAX.
"""

from __future__ import annotations

from qwen3_asr_gguf_tpu.models.configs import preset
from qwen3_asr_gguf_tpu.schema import (
    ASREngineConfig,
    DecodeResult,
    TranscribeResult,
)

__version__ = "0.1.0"

__all__ = ["ASREngineConfig", "DecodeResult", "TranscribeResult", "QwenASREngine", "native",
           "preset", "__version__"]


def __getattr__(name: str):
    # lazy, like the JAX package: importing the package loads no model code
    if name == "QwenASREngine":
        from .runtime.engine import QwenASREngine

        return QwenASREngine
    if name == "native":  # the shared C codec (q4_k quantize/dequant on the host)
        from qwen3_asr_gguf_tpu import native

        return native
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
