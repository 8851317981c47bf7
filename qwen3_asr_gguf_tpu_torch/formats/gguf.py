"""GGUF v3 container reader/writer.

Independent implementation of the GGUF on-disk format (spec:
github.com/ggml-org/ggml/blob/master/docs/gguf.md) sufficient to

- read the decoder checkpoints the reference pipeline produces
  (qwen3_asr_llm.q4_k.gguf / qwen3_aligner_llm.q4_k.gguf, written by the
  vendored converter, reference 06-Convert-ASR-Decoder-GGUF.py),
- write such files from our own exporter, and
- memmap-scan the token-embedding table without loading the model
  (reference fast path: qwen_asr_gguf/inference/llama.py:832-937).

Reading is zero-copy: tensor payloads are returned as views into one
``np.memmap`` of the file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Iterable

import numpy as np

from . import quants

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
    T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
    T_I64: "<q", T_F64: "<d",
}


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # logical numpy shape (row-major; last dim = row width)
    ggml_type: int
    offset: int  # relative to data section start
    nbytes: int = 0

    @property
    def type_name(self) -> str:
        return quants.TYPE_NAMES.get(self.ggml_type, str(self.ggml_type))


class GGUFReader:
    """Memmap-backed GGUF reader."""

    def __init__(self, path: str):
        self.path = path
        self.kv: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._parse()

    # -- parsing ----------------------------------------------------------

    def _parse(self) -> None:
        buf = self._mm
        if bytes(buf[:4]) != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = struct.unpack_from("<I", buf, 4)[0]
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack_from("<QQ", buf, 8)
        pos = 24

        def read_str(p: int) -> tuple[str, int]:
            ln = struct.unpack_from("<Q", buf, p)[0]
            s = bytes(buf[p + 8 : p + 8 + ln]).decode("utf-8", errors="replace")
            return s, p + 8 + ln

        def read_value(vtype: int, p: int) -> tuple[Any, int]:
            if vtype in _SCALAR_FMT:
                fmt = _SCALAR_FMT[vtype]
                return struct.unpack_from(fmt, buf, p)[0], p + struct.calcsize(fmt)
            if vtype == T_BOOL:
                return bool(buf[p]), p + 1
            if vtype == T_STR:
                return read_str(p)
            if vtype == T_ARR:
                etype, count = struct.unpack_from("<IQ", buf, p)
                p += 12
                if etype in _SCALAR_FMT and etype != T_BOOL:
                    fmt = _SCALAR_FMT[etype]
                    width = struct.calcsize(fmt)
                    dtype = np.dtype(fmt[1:]).newbyteorder("<")
                    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=p)
                    return arr, p + width * count
                out = []
                for _ in range(count):
                    v, p = read_value(etype, p)
                    out.append(v)
                return out, p
            raise ValueError(f"bad GGUF value type {vtype}")

        for _ in range(n_kv):
            key, pos = read_str(pos)
            vtype = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            self.kv[key], pos = read_value(vtype, pos)

        infos = []
        for _ in range(n_tensors):
            name, pos = read_str(pos)
            n_dims = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            dims = struct.unpack_from(f"<{n_dims}Q", buf, pos)
            pos += 8 * n_dims
            ggml_type, = struct.unpack_from("<I", buf, pos)
            pos += 4
            offset, = struct.unpack_from("<Q", buf, pos)
            pos += 8
            # ggml dims are fastest-first; numpy shape is the reverse
            shape = tuple(reversed(dims))
            infos.append(TensorInfo(name=name, shape=shape, ggml_type=ggml_type, offset=offset))

        align = int(self.kv.get("general.alignment", DEFAULT_ALIGNMENT))
        self.data_start = (pos + align - 1) // align * align
        for ti in infos:
            row = ti.shape[-1] if ti.shape else 1
            n_rows = int(np.prod(ti.shape[:-1])) if len(ti.shape) > 1 else 1
            ti.nbytes = n_rows * quants.byte_width(ti.ggml_type, row)
            self.tensors[ti.name] = ti

    # -- access -----------------------------------------------------------

    def tensor_bytes(self, name: str) -> np.ndarray:
        ti = self.tensors[name]
        start = self.data_start + ti.offset
        return self._mm[start : start + ti.nbytes]

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Fully dequantized tensor."""
        ti = self.tensors[name]
        out = quants.dequantize(self.tensor_bytes(name), ti.ggml_type, ti.shape)
        return out.astype(dtype, copy=False)

    def packed_q4(self, name: str) -> quants.PackedQ4:
        """Tensor repacked into the TPU int4 layout (must be Q4_K, 2-D)."""
        ti = self.tensors[name]
        if ti.ggml_type != quants.GGML_Q4_K:
            raise ValueError(f"{name} is {ti.type_name}, not q4_k")
        return quants.repack_q4_k(self.tensor_bytes(name), ti.shape)  # type: ignore[arg-type]


class EmbeddingTable:
    """Dequantize-on-gather view of a (possibly quantized) embedding tensor.

    Mirrors the reference's <50 ms prompt-building fast path
    (llama.py:786-803): only the gathered rows are dequantized.
    """

    def __init__(self, reader: GGUFReader, name: str = "token_embd.weight"):
        self._ti = reader.tensors[name]
        self._bytes = reader.tensor_bytes(name)
        self.n_vocab, self.n_embd = self._ti.shape
        self._row_bytes = quants.byte_width(self._ti.ggml_type, self.n_embd)

    def __getitem__(self, idx) -> np.ndarray:
        rows = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        flat = self._bytes.reshape(self.n_vocab, self._row_bytes)[rows]
        out = quants.dequantize(flat, self._ti.ggml_type, (len(rows), self.n_embd))
        if np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0):
            return out[0]
        return out.astype(np.float32, copy=False)


def get_token_embeddings_gguf(path: str, name: str = "token_embd.weight") -> EmbeddingTable:
    """API-compatible helper (reference llama.py:832)."""
    return EmbeddingTable(GGUFReader(path), name)


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


class GGUFWriter:
    """Minimal streaming GGUF v3 writer."""

    def __init__(self, path: str, arch: str = "qwen3vl"):
        self.path = path
        self._kv: list[tuple[str, int, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], int, np.ndarray]] = []
        self.add_kv("general.architecture", T_STR, arch)
        self.add_kv("general.alignment", T_U32, DEFAULT_ALIGNMENT)

    def add_kv(self, key: str, vtype: int, value: Any) -> None:
        self._kv.append((key, vtype, value))

    def add_string(self, key: str, value: str) -> None:
        self.add_kv(key, T_STR, value)

    def add_u32(self, key: str, value: int) -> None:
        self.add_kv(key, T_U32, int(value))

    def add_f32(self, key: str, value: float) -> None:
        self.add_kv(key, T_F32, float(value))

    def add_bool(self, key: str, value: bool) -> None:
        self.add_kv(key, T_BOOL, bool(value))

    def add_str_array(self, key: str, values: Iterable[str]) -> None:
        self.add_kv(key, T_ARR, (T_STR, list(values)))

    def add_i32_array(self, key: str, values: Iterable[int]) -> None:
        self.add_kv(key, T_ARR, (T_I32, np.asarray(list(values), dtype=np.int32)))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: int | None = None) -> None:
        """data: f32/f16 array (quantized on write) OR pre-quantized bytes.

        If `ggml_type` is given and data is float, it is quantized here.
        If data is uint8, it must already be `ggml_type` blocks.
        """
        if ggml_type is None:
            ggml_type = quants.GGML_F32 if data.dtype == np.float32 else quants.GGML_F16
        if data.dtype != np.uint8 and ggml_type not in (quants.GGML_F32, quants.GGML_F16):
            payload = quants.quantize(data.astype(np.float32), ggml_type)
            payload = payload.view(np.uint8) if payload.dtype != np.uint8 else payload
        elif ggml_type == quants.GGML_F32:
            payload = data.astype(np.float32)
        elif ggml_type == quants.GGML_F16 and data.dtype != np.uint8:
            payload = data.astype(np.float16)
        else:
            payload = data
        self._tensors.append((name, tuple(data.shape), ggml_type, np.ascontiguousarray(payload)))

    def add_raw_tensor(
        self, name: str, payload: np.ndarray, shape: tuple[int, ...], ggml_type: int
    ) -> None:
        """Pass an already-encoded tensor payload through unchanged, keeping
        its logical shape (metadata-editing tools rewrite files without
        touching tensor bytes)."""
        self._tensors.append(
            (name, tuple(shape), ggml_type, np.ascontiguousarray(payload).view(np.uint8))
        )

    # -- serialization ------------------------------------------------------

    @staticmethod
    def _w_str(f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_value(self, f: BinaryIO, vtype: int, value: Any) -> None:
        if vtype in _SCALAR_FMT:
            f.write(struct.pack(_SCALAR_FMT[vtype], value))
        elif vtype == T_BOOL:
            f.write(struct.pack("<B", 1 if value else 0))
        elif vtype == T_STR:
            self._w_str(f, value)
        elif vtype == T_ARR:
            etype, elems = value
            f.write(struct.pack("<IQ", etype, len(elems)))
            if isinstance(elems, np.ndarray) and etype in _SCALAR_FMT:
                f.write(np.ascontiguousarray(elems).tobytes())
            else:
                for e in elems:
                    self._w_value(f, etype, e)
        else:
            raise ValueError(f"bad value type {vtype}")

    def write(self) -> None:
        align = DEFAULT_ALIGNMENT
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", GGUF_VERSION, len(self._tensors), len(self._kv)))
            for key, vtype, value in self._kv:
                self._w_str(f, key)
                f.write(struct.pack("<I", vtype))
                self._w_value(f, vtype, value)

            offset = 0
            offsets = []
            for name, shape, ggml_type, payload in self._tensors:
                self._w_str(f, name)
                dims = tuple(reversed(shape))
                f.write(struct.pack("<I", len(dims)))
                f.write(struct.pack(f"<{len(dims)}Q", *dims))
                f.write(struct.pack("<IQ", ggml_type, offset))
                offsets.append(offset)
                nbytes = payload.nbytes
                offset += (nbytes + align - 1) // align * align

            pad = (-f.tell()) % align
            f.write(b"\x00" * pad)
            for (_, _, _, payload), off in zip(self._tensors, offsets):
                f.write(payload.tobytes())
                pad = (-payload.nbytes) % align
                f.write(b"\x00" * pad)
