"""GGUF v3 files: the writer of the benchmark's checkpoints and the
reference's reader (the container layout of the ggml spec, as the port's
`formats/gguf.py` writes and reads it). Tensor payloads are pre-encoded
bytes; `quant.py` encodes and decodes them.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAGIC = b"GGUF"
ALIGN = 32
T_U32, T_I32, T_F32, T_STR, T_ARR, T_U64 = 4, 5, 6, 8, 9, 10
_SCALAR = {0: "<B", 1: "<b", 2: "<H", 3: "<h", T_U32: "<I", T_I32: "<i", T_F32: "<f",
           T_U64: "<Q", 11: "<q", 12: "<d"}

F32, F16, Q4_K, Q6_K = 0, 1, 12, 14
# ggml type -> (elements per block, bytes per block)
BLOCK = {F32: (1, 4), F16: (1, 2), Q4_K: (256, 144), Q6_K: (256, 210)}


def row_bytes(ggml_type: int, n: int) -> int:
    per, size = BLOCK[ggml_type]
    return n // per * size


class Writer:
    """Key-values and tensors, written in one pass by `write`."""

    def __init__(self, arch: str):
        self.kv: list[tuple[str, int, Any]] = [("general.architecture", T_STR, arch),
                                               ("general.alignment", T_U32, ALIGN)]
        self.tensors: list[tuple[str, tuple, int, np.ndarray]] = []

    def add(self, key: str, vtype: int, value: Any) -> None:
        self.kv.append((key, vtype, value))

    def add_tensor(self, name: str, shape: tuple, ggml_type: int, payload: np.ndarray) -> None:
        payload = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
        rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        if payload.size != rows * row_bytes(ggml_type, shape[-1]):
            raise ValueError(f"{name}: {payload.size} bytes for {shape} of type {ggml_type}")
        self.tensors.append((name, tuple(shape), ggml_type, payload))

    @staticmethod
    def _str(f, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)) + b)

    def _value(self, f, vtype: int, value: Any) -> None:
        if vtype in _SCALAR:
            f.write(struct.pack(_SCALAR[vtype], value))
        elif vtype == T_STR:
            self._str(f, value)
        else:  # array: (element type, values)
            etype, vals = value
            f.write(struct.pack("<IQ", etype, len(vals)))
            if etype == T_STR:
                for v in vals:
                    self._str(f, v)
            else:
                f.write(np.asarray(vals, dtype=np.dtype(_SCALAR[etype][1:])).tobytes())

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(MAGIC + struct.pack("<IQQ", 3, len(self.tensors), len(self.kv)))
            for key, vtype, value in self.kv:
                self._str(f, key)
                f.write(struct.pack("<I", vtype))
                self._value(f, vtype, value)
            offset = 0
            for name, shape, t, payload in self.tensors:
                self._str(f, name)
                dims = tuple(reversed(shape))
                f.write(struct.pack("<I", len(dims)) + struct.pack(f"<{len(dims)}Q", *dims))
                f.write(struct.pack("<IQ", t, offset))
                offset += -(-payload.size // ALIGN) * ALIGN
            f.write(b"\0" * ((-f.tell()) % ALIGN))
            for _, _, _, payload in self.tensors:
                f.write(payload.tobytes())
                f.write(b"\0" * ((-payload.size) % ALIGN))


class Reader:
    """Key-values, and each tensor's (shape, type, bytes) from one memmap."""

    def __init__(self, path: str):
        buf = np.memmap(path, dtype=np.uint8, mode="r")
        if bytes(buf[:4]) != MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        n_tensors, n_kv = struct.unpack_from("<QQ", buf, 8)
        pos = 24

        def rstr(p):
            n = struct.unpack_from("<Q", buf, p)[0]
            return bytes(buf[p + 8:p + 8 + n]).decode("utf-8"), p + 8 + n

        def rval(vtype, p):
            if vtype in _SCALAR:
                return struct.unpack_from(_SCALAR[vtype], buf, p)[0], p + struct.calcsize(
                    _SCALAR[vtype])
            if vtype == 7:  # bool
                return bool(buf[p]), p + 1
            if vtype == T_STR:
                return rstr(p)
            etype, count = struct.unpack_from("<IQ", buf, p)
            p += 12
            out = []
            for _ in range(count):
                v, p = rval(etype, p)
                out.append(v)
            return out, p

        self.kv: dict[str, Any] = {}
        for _ in range(n_kv):
            key, pos = rstr(pos)
            vtype = struct.unpack_from("<I", buf, pos)[0]
            self.kv[key], pos = rval(vtype, pos + 4)
        infos = []
        for _ in range(n_tensors):
            name, pos = rstr(pos)
            nd = struct.unpack_from("<I", buf, pos)[0]
            dims = struct.unpack_from(f"<{nd}Q", buf, pos + 4)
            t, off = struct.unpack_from("<IQ", buf, pos + 4 + 8 * nd)
            pos += 4 + 8 * nd + 12
            infos.append((name, tuple(reversed(dims)), t, off))
        start = -(-pos // ALIGN) * ALIGN
        self.tensors: dict[str, tuple[tuple, int, np.ndarray]] = {}
        for name, shape, t, off in infos:
            rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            n = rows * row_bytes(t, shape[-1])
            self.tensors[name] = (shape, t, buf[start + off:start + off + n])
