"""Build and load the port's hand-written CUDA kernels.

At first use the sources in `csrc/*.cu` are compiled with `nvcc` for
Hopper (`sm_90a`), one nvcc process per source, all started together, and
linked into one shared library with a plain C interface, written to
`qwen3_asr_gguf_tpu_torch/build/` (listed in `.gitignore`), and loaded with
`ctypes`. No PyTorch headers are compiled: a build takes seconds, where
`torch.utils.cpp_extension.load` takes minutes.

Calling convention of every C entry point: pointers and the CUDA stream are
`c_void_p`, sizes and flags `c_int`, the epsilon `c_float`; the function
returns `cudaGetLastError()` after its launches, and `check` raises if it is
not 0 (a refused launch never runs, and a later synchronize would not
report it). Each wrapper counts its launches with `count_launch`; a launch
captured into a CUDA graph is counted at each replay instead
(`capture_tally`, `add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libq3a_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# entry point -> argtypes (see csrc/*.cu)
_SIGNATURES = {
    "q4k_matvec_launch": [
        _P, _I,  # x, x_is_bf16
        _P, _P, _P, _P,  # packed, sub_t, min_t, dd_t
        _P, _I,  # out, out_is_bf16
        _I, _I,  # n, k
        _P,  # stream
    ],
    "q4k_matvec_normed_launch": [
        _P, _I,  # x, x_is_bf16
        _P, _F,  # norm_w (f32), eps
        _P, _P, _P, _P,  # packed, sub_t, min_t, dd_t
        _P, _I,  # out, out_is_bf16
        _I, _I,  # n, k
        _P,  # stream
    ],
    "q4k_matmul_rows_launch": [
        _P, _I,  # x, x_is_bf16
        _P, _P,  # xq, sxs (scratch)
        _P, _P, _P, _P,  # packed, sub_t, min_t, dd_t
        _P, _I,  # out, out_is_bf16
        _I, _I, _I,  # t, n, k
        _I, _I,  # channel pairs per block, blocks that split K
        _P,  # stream
    ],
    "gqa_rows_q8_attention_launch": [
        _P, _I,  # q, q_is_bf16
        _P, _P, _P, _P,  # k, k_s, v, v_s
        _P, _P,  # poss (int64), out
        _I, _I, _I, _I, _I, _I,  # b, hq, hkv, d, s_max, win
        _F,  # scale
        _P,  # stream
    ],
    "gqa_decode_attention_launch": [
        _P, _P, _P, _I,  # q, k, v, kv_is_bf16
        _P,  # pos (1-element int32 device tensor)
        _P, _I,  # out, out_is_bf16
        _I, _I, _I, _I, _I,  # hq, hkv, d, s_max, win
        _F,  # scale
        _P,  # stream
    ],
    "q4_matmul_launch": [
        _P, _I,  # x, x_is_bf16 (out takes x's dtype)
        _P,  # scratch of 2*t*k bf16 for an f32 x (null for bf16)
        _P, _P, _P,  # packed, scale, minv
        _P,  # out
        _I, _I, _I,  # t, n, k
        _I, _I, _I,  # channel tiles of 16 per block, group pairs per K chunk, blocks that split K
        _P,  # stream
    ],
    "fused_mlp_launch": [
        _P, _I,  # x, x_is_bf16 (out takes x's dtype)
        _P, _P, _P, _P, _P, _P,  # wg, sg, wu, su, wd, sd
        _P, _P, _P,  # act (f32, m values), counters (uint32, zeroed), out
        _I, _I, _I,  # m, d, tile_m
        _I, _I, _I,  # blocks, Wd slab rows per block, dynamic shared memory (ops.mlp.fused_mlp_plan)
        _P,  # stream
    ],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_capturing = threading.local()  # .tally: launches of a graph being captured on this thread
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    src_mtime = max(p.stat().st_mtime for p in (*_sources(), *CSRC.glob("*.cuh")))
    return LIB_PATH.stat().st_mtime < src_mtime


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once and raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu (in parallel) and link LIB_PATH (atomically: tmp
    file + rename)."""
    if not force and not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
          for src, o in zip(_sources(), objs)])
    tmp = LIB_PATH.with_suffix(f".{tag}.tmp")
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def count_launch(wrapper) -> None:
    """Add one to a wrapper's launch count (two threads may launch); inside
    `capture_tally` on this thread, to the graph's tally instead: a capture
    launches nothing."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def capture_tally():
    """Collect the launches made on this thread inside the block (a CUDA
    graph's capture) into the dict it yields, for `add_launches` at each
    replay of the graph."""
    _capturing.tally = {}
    try:
        yield _capturing.tally
    finally:
        _capturing.tally = None


def add_launches(tally: dict) -> None:
    """Count the launches of one replay of a graph captured under
    `capture_tally`."""
    with _count_lock:
        for wrapper, n in tally.items():
            wrapper.launches += n
