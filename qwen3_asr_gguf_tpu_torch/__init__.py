"""Qwen3-ASR on PyTorch and CUDA: the port of `qwen3_asr_gguf_tpu` (JAX on a
TPU) to one NVIDIA Hopper GPU.

Same public API as the JAX package (`QwenASREngine` with an
`ASREngineConfig`), with an explicit torch device. The package keeps its own
copies of the JAX package's modules that need no JAX (formats, text, schema,
configs, audio I/O, the native codec binding); everything else is ported,
and the Pallas kernels of the ported paths are hand-written CUDA kernels in
`csrc/`, built with nvcc at first use. This package imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

from .models.configs import preset
from .schema import (
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
    if name == "native":  # the C codec (q4_k quantize/dequant on the host)
        import importlib

        return importlib.import_module(".native", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
