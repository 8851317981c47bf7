"""The reference's weights: read from the checkpoint's bytes with the
benchmark's own codecs, in float32 on the given device, with the
precision's weight semantics worked out again (`quant.py`): at "int4" the
encoder's matrices are group-32 int4 and every decoder matrix that is not
q4_k (the q6_k head) is re-fitted to factored int4; q4_k matrices are
exact at every precision.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from .. import gguf, quant
from ..checkpoint import ENCODER_FN, LAYER_GGUF, NORMS

ENC_INT4 = ("conv_out", "proj1_w", "proj2_w", "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")


def _decode(shape, typ, raw: np.ndarray, device) -> torch.Tensor:
    b = torch.from_numpy(np.array(raw)).to(device)
    if typ == gguf.F32:
        return b.view(torch.float32).reshape(shape)
    if typ == gguf.F16:
        return b.view(torch.float16).float().reshape(shape)
    rows = b.reshape(int(np.prod(shape[:-1])), -1)
    fn = quant.decode_q4_k if typ == gguf.Q4_K else quant.decode_q6_k
    return fn(rows, shape[-1]).reshape(shape)


def decoder(path: Path, t: dict, precision: str, device) -> dict:
    r = gguf.Reader(str(path))

    def get(name):
        return _decode(*r.tensors[name], device)

    def matrix(name):
        w = get(name)
        if precision == "int4" and r.tensors[name][1] != gguf.Q4_K:
            w = quant.int4_factored(w)  # the int4 decoder re-fits any other matrix
        return w

    p = {"embed": get("token_embd.weight"), "final_norm": get("output_norm.weight"),
         "lm_head": matrix("output.weight")}
    for mine, suffix in LAYER_GGUF.items():
        fetch = get if mine in NORMS else matrix
        p[mine] = torch.stack([fetch(f"blk.{i}.{suffix}") for i in range(t["num_layers"])])
    return p


def encoder(d: Path, precision: str, device) -> dict:
    path = d / ENCODER_FN
    raw = path.read_bytes()
    (n,) = struct.unpack_from("<Q", raw, 0)
    header = json.loads(raw[8:8 + n])
    header.pop("__metadata__", None)
    p = {}
    for name, info in header.items():
        b0, b1 = info["data_offsets"]
        if info["dtype"] != "BF16":
            raise ValueError(f"{name}: {info['dtype']}, not BF16")
        bits = np.frombuffer(raw, dtype="<u2", count=(b1 - b0) // 2, offset=8 + n + b0)
        x = torch.from_numpy(bits.astype(np.int32) << 16).to(device).view(torch.float32)
        p[name.removeprefix("layers.")] = x.reshape(info["shape"])
    if precision in ("int4", "q4_k"):
        for name in ENC_INT4:
            w = p[name]
            p[name] = (quant.int4_group32(w) if w.ndim == 2
                       else torch.stack([quant.int4_group32(x) for x in w]))
    return p
