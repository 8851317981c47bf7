"""The safetensors file format with numpy alone.

Layout: an 8-byte little-endian header length, a JSON header (padded with
spaces to a multiple of 8 bytes) mapping each tensor name to its dtype,
shape and [begin, end) byte offsets into the data that follows, plus an
optional "__metadata__" map of strings. The writer orders tensors as the
reference implementation does (by dtype alignment, largest first, then by
name), so its files are byte-identical to `safetensors.numpy.save_file`.

BF16 (what published Hugging Face checkpoints store) has no numpy dtype
without `ml_dtypes`, which the port does not use: the reader widens a BF16
tensor exactly to an f32 array (the 16 bits become the top half of each f32),
and the writer stores as BF16 the uint16 bit patterns of the tensors named
in `bf16` (`bf16_bits` rounds f32 values to them).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values -> the uint16 bit patterns of their bf16 rounding (to
    nearest, ties to even; NaN stays NaN)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    nan = np.isnan(x)
    return np.where(nan, (u >> 16) | np.uint32(0x40), rounded).astype(np.uint16)


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> f32, exactly."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def save_file(tensors: dict[str, np.ndarray], path: str,
              metadata: dict[str, str] | None = None, *, bf16: frozenset | set = frozenset()
              ) -> None:
    """Write `tensors`; those named in `bf16` are uint16 bit patterns stored
    as BF16."""
    arrs = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    names = {}
    for name, a in arrs.items():
        if name in bf16:
            if a.dtype != np.uint16:
                raise TypeError(f"{name}: BF16 takes uint16 bit patterns, not {a.dtype}")
            names[name] = "BF16"
        elif a.dtype in _NAMES:
            names[name] = _NAMES[a.dtype]
        else:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors name")
    order = sorted(arrs, key=lambda k: (-arrs[k].dtype.itemsize, k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        a = arrs[name]
        header[name] = {
            "dtype": names[name],
            "shape": list(a.shape),
            "data_offsets": [offset, offset + a.nbytes],
        }
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    blob += b" " * ((-len(blob)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(arrs[name].astype(arrs[name].dtype.newbyteorder("<"), copy=False).tobytes())


def read_header(path: str) -> tuple[dict, int]:
    """(header dict, byte offset of the data section)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """(name -> array, metadata); arrays are read-only views of one mmap,
    except BF16 tensors, which come widened to f32 arrays of their own
    (`widen_bf16`)."""
    header, start = read_header(path)
    meta = header.pop("__metadata__", None) or {}
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        b, e = info["data_offsets"]
        if info["dtype"] == "BF16":
            bits = mm[start + b: start + e].view(np.dtype("<u2"))
            out[name] = widen_bf16(bits).reshape(info["shape"])
            continue
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = mm[start + b: start + e].view(dt).reshape(info["shape"])
    return out, meta
