"""The safetensors file format with numpy alone.

Layout: an 8-byte little-endian header length, a JSON header (padded with
spaces to a multiple of 8 bytes) mapping each tensor name to its dtype,
shape and [begin, end) byte offsets into the data that follows, plus an
optional "__metadata__" map of strings. The writer orders tensors as the
reference implementation does (by dtype alignment, largest first, then by
name), so its files are byte-identical to `safetensors.numpy.save_file`.
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


def save_file(tensors: dict[str, np.ndarray], path: str,
              metadata: dict[str, str] | None = None) -> None:
    arrs = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    for name, a in arrs.items():
        if a.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors name")
    order = sorted(arrs, key=lambda k: (-arrs[k].dtype.itemsize, k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        a = arrs[name]
        header[name] = {
            "dtype": _NAMES[a.dtype],
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
    """(name -> array, metadata); arrays are read-only views of one mmap."""
    header, start = read_header(path)
    meta = header.pop("__metadata__", None) or {}
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        b, e = info["data_offsets"]
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = mm[start + b: start + e].view(dt).reshape(info["shape"])
    return out, meta
