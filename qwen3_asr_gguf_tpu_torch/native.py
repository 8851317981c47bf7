"""ctypes binding to the native host runtime (native/libqwen3asr_host.so).

The TPU owns all model FLOPs; this C++ layer owns the host-side byte work
the reference delegates to llama.cpp's C core — ggml block codecs and the
load-time repack into the TPU planar int4 layout. Every entry point has a
pure-NumPy fallback (formats/quants.py), so the package works unbuilt;
`python -m qwen3_asr_gguf_tpu_torch.native` builds the library in place.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO / "native"
_SO_CANDIDATES = [
    _NATIVE_DIR / "build" / "libqwen3asr_host.so",
    _NATIVE_DIR / "libqwen3asr_host.so",
]

_lib = None
_load_attempted = False

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64

MAX_NATIVE_K = 1 << 14  # repack row-buffer bound in quants.cpp


def _bind(lib) -> None:
    lib.q3a_dequant_q4k.argtypes = [_u8p, _i64, _f32p]
    lib.q3a_dequant_q6k.argtypes = [_u8p, _i64, _f32p]
    lib.q3a_dequant_q8_0.argtypes = [_u8p, _i64, _f32p]
    lib.q3a_repack_q4k.argtypes = [_u8p, _i64, _i64, _u8p, _f32p, _f32p]
    lib.q3a_quantize_q4k.argtypes = [_f32p, _i64, _u8p]
    lib.q3a_pack_q4_direct.argtypes = [_f32p, _i64, _i64, _u8p, _f32p, _f32p]


def _sources_mtime() -> float:
    paths = list((_NATIVE_DIR / "src").glob("*.cpp")) + [_NATIVE_DIR / "CMakeLists.txt"]
    return max((p.stat().st_mtime for p in paths if p.exists()), default=0.0)


def load() -> ctypes.CDLL | None:
    """Load the native library if built; None otherwise (NumPy fallback).

    A .so older than the C++ sources is treated as absent — a stale binary
    silently overriding edited sources would make numerics diverge with no
    visible diff. Rebuild with `python -m qwen3_asr_gguf_tpu_torch.native build`.
    """
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("QWEN3_ASR_TPU_NO_NATIVE"):
        return None
    src_mtime = _sources_mtime()
    for so in _SO_CANDIDATES:
        if so.exists():
            if so.stat().st_mtime < src_mtime:
                import warnings

                warnings.warn(
                    f"{so} is older than native/src — ignoring it; rebuild with "
                    "`python -m qwen3_asr_gguf_tpu_torch.native build`",
                    stacklevel=2,
                )
                continue
            try:
                lib = ctypes.CDLL(str(so))
                _bind(lib)
                _lib = lib
                break
            except OSError:
                continue
    return _lib


def available() -> bool:
    return load() is not None


def build(verbose: bool = True) -> Path:
    """Build libqwen3asr_host.so with cmake+ninja (g++ fallback).

    On success, resets the load cache so an `available()` that already failed
    in this process (e.g. a fresh machine before the first build) retries; a
    failed build leaves the cached negative result intact."""
    global _load_attempted
    build_dir = _NATIVE_DIR / "build"
    build_dir.mkdir(exist_ok=True)
    try:
        subprocess.run(
            ["cmake", "-G", "Ninja", "-DCMAKE_BUILD_TYPE=Release", ".."],
            cwd=build_dir, check=True, capture_output=not verbose,
        )
        subprocess.run(["ninja"], cwd=build_dir, check=True, capture_output=not verbose)
    except (subprocess.CalledProcessError, FileNotFoundError):
        # plain g++ fallback
        out = _NATIVE_DIR / "libqwen3asr_host.so"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(_NATIVE_DIR / "src" / "quants.cpp"), "-o", str(out)],
            check=True,
        )
        _load_attempted = False
        return out
    _load_attempted = False
    return build_dir / "libqwen3asr_host.so"


# -- typed wrappers (None-safe: callers check available() first) -----------


def dequant_q4k(blocks: np.ndarray, out_shape) -> np.ndarray:
    lib = load()
    b = np.ascontiguousarray(blocks.reshape(-1, 144))
    out = np.empty(b.shape[0] * 256, dtype=np.float32)
    lib.q3a_dequant_q4k(b.reshape(-1), b.shape[0], out)
    return out.reshape(out_shape)


def dequant_q6k(blocks: np.ndarray, out_shape) -> np.ndarray:
    lib = load()
    b = np.ascontiguousarray(blocks.reshape(-1, 210))
    out = np.empty(b.shape[0] * 256, dtype=np.float32)
    lib.q3a_dequant_q6k(b.reshape(-1), b.shape[0], out)
    return out.reshape(out_shape)


def dequant_q8_0(blocks: np.ndarray, out_shape) -> np.ndarray:
    lib = load()
    b = np.ascontiguousarray(blocks.reshape(-1, 34))
    out = np.empty(b.shape[0] * 32, dtype=np.float32)
    lib.q3a_dequant_q8_0(b.reshape(-1), b.shape[0], out)
    return out.reshape(out_shape)


def repack_q4k(blocks: np.ndarray, rows: int, k: int):
    lib = load()
    b = np.ascontiguousarray(blocks.reshape(-1))
    packed = np.empty((rows, k // 2), dtype=np.uint8)
    scale = np.empty((rows, k // 32), dtype=np.float32)
    minv = np.empty((rows, k // 32), dtype=np.float32)
    lib.q3a_repack_q4k(b, rows, k // 256, packed, scale, minv)
    return packed, scale, minv


def quantize_q4k(x: np.ndarray) -> np.ndarray:
    lib = load()
    flat = np.ascontiguousarray(x.reshape(-1), dtype=np.float32)
    nb = flat.size // 256
    out = np.empty(nb * 144, dtype=np.uint8)
    lib.q3a_quantize_q4k(flat, nb, out)
    return out.reshape(*x.shape[:-1], -1)


def pack_q4_direct(w: np.ndarray):
    lib = load()
    rows, k = w.shape
    flat = np.ascontiguousarray(w, dtype=np.float32)
    packed = np.empty((rows, k // 2), dtype=np.uint8)
    scale = np.empty((rows, k // 32), dtype=np.float32)
    minv = np.empty((rows, k // 32), dtype=np.float32)
    lib.q3a_pack_q4_direct(flat.reshape(-1), rows, k, packed, scale, minv)
    return packed, scale, minv


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "build" or len(sys.argv) == 1:
        so = build()
        print(f"built {so}")
        print("loadable:", available())
