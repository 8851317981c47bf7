"""Parameter loading and saving (counterpart of
`qwen3_asr_gguf_tpu/models/params.py`).

Decoder checkpoints are GGUF files with llama.cpp qwen3 tensor names,
encoder checkpoints safetensors. Loading yields the port's parameter dicts
(per-layer lists; see models/decoder.py) on a torch device. The int4 path
repacks q4_k tensors into the matvec layout (`ops.q4k.Q4KWeight`); nothing is
cached beside the checkpoint (the JAX package's `.int4/` sidecars hold its
own layout and are neither read nor written here). The int8 path
requantizes q4_k content to per-channel int8 (`ops.qtensor.Int8Weight`) on
the host, as the JAX package does; the q4_k path keeps each q4_k tensor as
planar `ops.qtensor.Q4Weight` (the GGUF's own scales; columns in natural order).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..formats import GGUFReader, GGUFWriter
from ..formats import quants as q
from ..formats import q4_0
from ..ops.moe import ExpertWeights, from_q4_0
from ..ops.q4k import Q4KWeight, dequant_mxu, pack_q4k_mxu, pad_rows
from ..ops.qtensor import Int8Weight, Q4Weight, dequant_int8, dequant_q4, dequant_q6k
from ..text.tokenizer import BPETokenizer
from . import safetensors_np
from .configs import AudioEncoderConfig, TextDecoderConfig, ThinkerConfig
from .mla_config import MLAMoEConfig

# param name -> GGUF per-layer tensor suffix
_LAYER_MAP = {
    "attn_norm": "attn_norm.weight",
    "q_proj": "attn_q.weight",
    "k_proj": "attn_k.weight",
    "v_proj": "attn_v.weight",
    "o_proj": "attn_output.weight",
    "q_norm": "attn_q_norm.weight",
    "k_norm": "attn_k_norm.weight",
    "mlp_norm": "ffn_norm.weight",
    "gate_proj": "ffn_gate.weight",
    "up_proj": "ffn_up.weight",
    "down_proj": "ffn_down.weight",
}
_QUANTIZABLE = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}
_ENC_Q4_TOP = ("conv_out", "proj1_w", "proj2_w")
_ENC_Q4_LAYER = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")
_WORKERS = min(8, os.cpu_count() or 1)  # numpy packing releases the GIL
# q6_k tables above this size dequantize on the device when the native host
# codec is not built: numpy's q6_k decode of the 1.7B embed takes ~40 s
DEVICE_Q6K_BYTES = 10 << 20


def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------


def decoder_config_from_gguf(reader: GGUFReader) -> TextDecoderConfig:
    kv = reader.kv
    arch = kv.get("general.architecture", "qwen3vl")

    def g(suffix, default=None):
        return kv.get(f"{arch}.{suffix}", default)

    n_vocab, hidden = reader.tensors["token_embd.weight"].shape
    head_out = reader.tensors["output.weight"].shape[0] if "output.weight" in reader.tensors else n_vocab
    classify = head_out if head_out != n_vocab and head_out < 20_000 else None
    return TextDecoderConfig(
        vocab_size=n_vocab,
        hidden_size=int(g("embedding_length", hidden)),
        num_layers=int(g("block_count")),
        num_heads=int(g("attention.head_count")),
        num_kv_heads=int(g("attention.head_count_kv")),
        head_dim=int(g("attention.key_length", 128)),
        intermediate_size=int(g("feed_forward_length")),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)),
        rope_theta=float(g("rope.freq_base", 5e6)),
        classify_num=classify,
    )


def _embed(reader: GGUFReader, device, dtype) -> torch.Tensor:
    from .. import native

    name = "token_embd.weight"
    ti = reader.tensors[name]
    if ti.ggml_type == q.GGML_Q6_K and ti.nbytes > DEVICE_Q6K_BYTES and not native.available():
        return dequant_q6k(reader.tensor_bytes(name), ti.shape, dtype=dtype, device=device)
    return _t(reader.tensor(name, dtype=np.float32), device).to(dtype)


def _mxu_parts(reader: GGUFReader, name: str):
    ti = reader.tensors[name]
    if ti.ggml_type == q.GGML_Q4_K and len(ti.shape) == 2:
        return pack_q4k_mxu(reader.packed_q4(name))
    # non-q4_k tensor in a mixed file: requantize from f32
    return pack_q4k_mxu(q.pack_q4_direct(reader.tensor(name, dtype=np.float32)))


def _int8_rows(dense: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense [N, K] -> per-channel symmetric int8 on the host: (int8 [N, K],
    f32 scale [N])."""
    amax = np.maximum(np.abs(dense).max(axis=-1), 1e-10)
    scale = (amax / 127.0).astype(np.float32)
    qv = np.clip(np.round(dense / scale[:, None]), -127, 127).astype(np.int8)
    return qv, scale


def _int8_weight(parts: tuple[np.ndarray, np.ndarray], device) -> Int8Weight:
    return Int8Weight(q=_t(parts[0], device), scale=_t(parts[1], device, torch.float32))


def load_decoder_gguf(
    path: str, *, precision: str = "int4", device="cpu",
) -> tuple[TextDecoderConfig, dict, BPETokenizer]:
    """precision "int4": q4_k weights in the matvec layout, bf16 embed;
    "int8": q4_k weights requantized to per-channel int8, the head per-row
    int8 from its f32 values, bf16 embed; "q4_k": q4_k tensors as planar
    `Q4Weight` (any other tensor dense bf16), the head requantized to
    `Q4Weight` with its rows zero-padded to a multiple of 256 (`lm_logits`
    slices them away), bf16 embed; "bf16" / "f32": dense weights of that
    dtype. Norms stay f32."""
    if precision not in ("int4", "int8", "q4_k", "bf16", "f32"):
        raise ValueError(f"unknown decoder precision {precision!r}")
    reader = GGUFReader(path)
    if reader.kv.get("general.architecture") == MLA_ARCH:
        return load_mla_moe_gguf(reader, precision=precision, device=device)
    cfg = decoder_config_from_gguf(reader)
    tokenizer = BPETokenizer.from_gguf_kv(reader.kv)
    dense_dtype = torch.float32 if precision == "f32" else torch.bfloat16
    head_name = "output.weight" if "output.weight" in reader.tensors else "token_embd.weight"

    def norm(name):
        return _t(reader.tensor(name, dtype=np.float32), device, torch.float32)

    if precision == "int4":
        def weight(name):
            return Q4KWeight.from_numpy(*_mxu_parts(reader, name), device=device)

        def head():
            # padded to 1024-row multiples; zero rows give logits of exactly 0
            parts = pad_rows(*pad_rows(*_mxu_parts(reader, head_name)), multiple=1024)
            return Q4KWeight.from_numpy(*parts, device=device)

    elif precision == "int8":
        def weight(name):
            return _int8_weight(_int8_rows(q.unpack_q4(reader.packed_q4(name))), device)

        def head():
            return _int8_weight(_int8_rows(reader.tensor(head_name, dtype=np.float32)), device)

    elif precision == "q4_k":
        def weight(name):
            ti = reader.tensors[name]
            if ti.ggml_type == q.GGML_Q4_K and len(ti.shape) == 2:
                return Q4Weight.from_packed(reader.packed_q4(name), device=device)
            return _t(reader.tensor(name, dtype=np.float32), device, dense_dtype)

        def head():
            if cfg.hidden_size % 64:
                return _t(reader.tensor(head_name, dtype=np.float32), device, dense_dtype)
            # the head is the largest stream of a decode step: requantized to
            # the packed layout; padded rows are all zero and give logits of 0
            head_f32 = reader.tensor(head_name, dtype=np.float32)
            pad = (-head_f32.shape[0]) % 256
            if pad:
                head_f32 = np.concatenate(
                    [head_f32, np.zeros((pad, head_f32.shape[1]), np.float32)])
            return Q4Weight.from_packed(q.pack_q4_direct(head_f32), device=device)

    else:
        def weight(name):
            return _t(reader.tensor(name, dtype=np.float32), device, dense_dtype)

        def head():
            return weight(head_name)

    names = [(i, mine, f"blk.{i}.{suffix}") for i in range(cfg.num_layers)
             for mine, suffix in _LAYER_MAP.items()]
    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        loaded = list(pool.map(
            lambda e: weight(e[2]) if e[1] in _QUANTIZABLE else norm(e[2]), names))
        head_w = pool.submit(head).result()
    layers: list[dict] = [{} for _ in range(cfg.num_layers)]
    for (i, mine, _), v in zip(names, loaded):
        layers[i][mine] = v
    params = {
        # under int4 and int8 the embed is bf16, as the JAX package stores it
        "embed": _embed(reader, device, dense_dtype),
        "layers": layers,
        "final_norm": norm("output_norm.weight"),
        "lm_head": head_w,
    }
    return cfg, params, tokenizer


def _cat(ws: list):
    if isinstance(ws[0], Q4KWeight):
        # channel-pair rows concat along the channel axis (every piece has an
        # even channel count, so nibble pairs never straddle)
        return Q4KWeight(
            packed=torch.cat([w.packed for w in ws], dim=-2),
            sub_t=torch.cat([w.sub_t for w in ws], dim=-1),
            min_t=torch.cat([w.min_t for w in ws], dim=-1),
            dd_t=torch.cat([w.dd_t for w in ws], dim=-1),
        )
    if isinstance(ws[0], Q4Weight):
        return Q4Weight(*(torch.cat([getattr(w, f) for w in ws], dim=-2)
                          for f in ("packed", "scale", "minv")))
    if isinstance(ws[0], Int8Weight):
        return Int8Weight(q=torch.cat([w.q for w in ws], dim=-2),
                          scale=torch.cat([w.scale for w in ws], dim=-1))
    return torch.cat(ws, dim=-2)


def fuse_layer_weights(params: dict) -> dict:
    """Per-layer [q|k|v] -> qkv_proj and [gate|up] -> gateup_proj (one
    weight stream and one launch where there were three / two)."""
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        if "q_proj" in layer:
            layer["qkv_proj"] = _cat([layer.pop("q_proj"), layer.pop("k_proj"), layer.pop("v_proj")])
        if "gate_proj" in layer:
            layer["gateup_proj"] = _cat([layer.pop("gate_proj"), layer.pop("up_proj")])
        layers.append(layer)
    return dict(params, layers=layers)


def dequant_prefill_params(params: dict) -> dict:
    """One-time bf16 dense copy of the quantized layer weights for prefill
    (prefill is compute-bound; decode keeps streaming 4-bit). Embed, norms
    and the lm_head are shared with the decode params."""

    def leaf(v):
        if isinstance(v, ExpertWeights):
            return v.dense(torch.bfloat16)
        if isinstance(v, Q4KWeight):
            return dequant_mxu(v, dtype=torch.bfloat16)
        if isinstance(v, Q4Weight):
            return dequant_q4(v, dtype=torch.bfloat16)
        if isinstance(v, Int8Weight):
            return dequant_int8(v, dtype=torch.bfloat16)
        return v

    return dict(params, layers=[{k: leaf(v) for k, v in layer.items()}
                                for layer in params["layers"]])


def save_decoder_gguf(
    path: str,
    cfg: TextDecoderConfig,
    params: dict,
    tokenizer: BPETokenizer,
    *,
    quant: str = "q4_k",  # "q4_k" | "f16" | "f32" | "q8_0"
    arch: str = "qwen3vl",
) -> None:
    """Write a decoder checkpoint from dense numpy params with STACKED
    layers (copy of the JAX package's writer). Matrix weights get `quant`,
    norms f32, token_embd/output q6_k under q4_k. Lands atomically."""
    tmp_path = path + ".tmp"
    w = GGUFWriter(tmp_path, arch=arch)
    w.add_u32(f"{arch}.block_count", cfg.num_layers)
    w.add_u32(f"{arch}.embedding_length", cfg.hidden_size)
    w.add_u32(f"{arch}.attention.head_count", cfg.num_heads)
    w.add_u32(f"{arch}.attention.head_count_kv", cfg.num_kv_heads)
    w.add_u32(f"{arch}.attention.key_length", cfg.head_dim)
    w.add_u32(f"{arch}.attention.value_length", cfg.head_dim)
    w.add_u32(f"{arch}.feed_forward_length", cfg.intermediate_size)
    w.add_f32(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps)
    w.add_f32(f"{arch}.rope.freq_base", cfg.rope_theta)
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_string("tokenizer.ggml.pre", "qwen2")
    w.add_str_array("tokenizer.ggml.tokens", tokenizer.tokens)
    w.add_str_array(
        "tokenizer.ggml.merges",
        [f"{a} {b}" for (a, b), _ in sorted(tokenizer.merge_ranks.items(), key=lambda kv: kv[1])],
    )
    types = [3 if t in tokenizer.special_tokens else 1 for t in tokenizer.tokens]
    w.add_i32_array("tokenizer.ggml.token_type", types)
    if tokenizer.eos_token_id is not None:
        w.add_u32("tokenizer.ggml.eos_token_id", tokenizer.eos_token_id)

    mat_type = {"q4_k": q.GGML_Q4_K, "q8_0": q.GGML_Q8_0, "f16": q.GGML_F16, "f32": q.GGML_F32}[quant]
    embd_type = q.GGML_Q6_K if quant == "q4_k" else mat_type

    def np32(x):
        return np.asarray(x, dtype=np.float32)

    def rowsafe(t, arr):
        return t if arr.shape[-1] % q.QUANT_SIZES[t][0] == 0 else q.GGML_F16

    embed = np32(params["embed"])
    w.add_tensor("token_embd.weight", embed, rowsafe(embd_type, embed))
    w.add_tensor("output_norm.weight", np32(params["final_norm"]), q.GGML_F32)
    head = np32(params["lm_head"])
    w.add_tensor("output.weight", head, rowsafe(embd_type, head))
    for mine, suffix in _LAYER_MAP.items():
        stacked = params["layers"][mine]
        for i in range(cfg.num_layers):
            arr = np32(stacked[i])
            t = rowsafe(mat_type, arr) if mine in _QUANTIZABLE else q.GGML_F32
            w.add_tensor(f"blk.{i}.{suffix}", arr, t)
    w.write()
    os.replace(tmp_path, path)


# --------------------------------------------------------------------------
# the latent-attention sparse-expert decoder (llama.cpp's deepseek2 layout)
# --------------------------------------------------------------------------

MLA_ARCH = "deepseek2"
# param name -> GGUF per-layer tensor suffix (models/mla_moe.py's names)
_MLA_ATTN = {"attn_norm": "attn_norm.weight", "wq": "attn_q.weight",
             "wkv_a": "attn_kv_a_mqa.weight", "kv_a_norm": "attn_kv_a_norm.weight",
             "wkv_b": "attn_kv_b.weight", "wo": "attn_output.weight",
             "mlp_norm": "ffn_norm.weight"}
_MLA_DENSE = {"gate_proj": "ffn_gate.weight", "up_proj": "ffn_up.weight",
              "down_proj": "ffn_down.weight"}
_MLA_MOE = {"router": "ffn_gate_inp.weight", "router_bias": "exp_probs_b.bias",
            "gate_exps": "ffn_gate_exps.weight", "up_exps": "ffn_up_exps.weight",
            "down_exps": "ffn_down_exps.weight", "gate_shexp": "ffn_gate_shexp.weight",
            "up_shexp": "ffn_up_shexp.weight", "down_shexp": "ffn_down_shexp.weight"}
_MLA_NORMS = {"attn_norm", "kv_a_norm", "mlp_norm"}
_MLA_EXPERTS = ("gate_exps", "up_exps", "down_exps", "gate_shexp", "up_shexp", "down_shexp")


def mla_config_from_gguf(reader: GGUFReader) -> MLAMoEConfig:
    kv = reader.kv

    def g(suffix, default=None):
        return kv.get(f"{MLA_ARCH}.{suffix}", default)

    n_vocab, hidden = reader.tensors["token_embd.weight"].shape
    rope = int(g("rope.dimension_count"))
    return MLAMoEConfig(
        vocab_size=n_vocab, hidden_size=int(g("embedding_length", hidden)),
        num_layers=int(g("block_count")), num_heads=int(g("attention.head_count")),
        q_lora_rank=int(g("attention.q_lora_rank", 0)) or None,
        kv_lora_rank=int(g("attention.kv_lora_rank")),
        qk_nope_head_dim=int(g("attention.key_length")) - rope, qk_rope_head_dim=rope,
        v_head_dim=int(g("attention.value_length")),
        intermediate_size=int(g("feed_forward_length")),
        moe_intermediate_size=int(g("expert_feed_forward_length")),
        n_routed_experts=int(g("expert_count")), n_shared_experts=int(g("expert_shared_count")),
        num_experts_per_tok=int(g("expert_used_count")),
        first_k_dense_replace=int(g("leading_dense_block_count")),
        routed_scaling_factor=float(g("expert_weights_scale")),
        norm_topk_prob=bool(g("expert_weights_norm", True)),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon")),
        rope_theta=float(g("rope.freq_base")),
    )


def _device_bytes(reader: GGUFReader, name: str, device) -> torch.Tensor:
    """A tensor's bytes as stored, on `device` (one copy from the file's map)."""
    import warnings

    with warnings.catch_warnings():  # the map is read-only; nothing writes to it
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(reader.tensor_bytes(name)).to(device)


def load_mla_moe_gguf(reader: GGUFReader, *, precision: str = "int4", device="cpu"
                      ) -> tuple[MLAMoEConfig, dict, BPETokenizer]:
    """A deepseek2 GGUF as `models/mla_moe.py`'s parameters. The experts'
    q4_0 bytes go to the device as stored and are split into kernel 8's
    planes there (`ops.moe.from_q4_0`); nothing of them is repacked on the
    host. "int4": wq, wo, the dense MLP and the head as `Q4KWeight` (kernels
    1 and 2), wkv_a as `Q4Weight` (kernel 6), wkv_b dense f32; "bf16" /
    "f32": those dense. Router, its bias and the norms f32; the embed
    bf16 (f32 under "f32")."""
    if precision not in ("int4", "bf16", "f32"):
        raise NotImplementedError(f"decoder precision {precision!r} for {MLA_ARCH}")
    cfg = mla_config_from_gguf(reader)
    if cfg.q_lora_rank is not None:
        raise NotImplementedError("a low-rank q projection (q_lora_rank) is not ported")
    tokenizer = BPETokenizer.from_gguf_kv(reader.kv)
    dense_dtype = torch.float32 if precision == "f32" else torch.bfloat16

    def f32(name):
        return _t(reader.tensor(name, dtype=np.float32), device, torch.float32)

    def weight(name, kernel6=False):
        if precision != "int4":
            return _t(reader.tensor(name, dtype=np.float32), device, dense_dtype)
        if kernel6:
            ti = reader.tensors[name]
            packed = (reader.packed_q4(name) if ti.ggml_type == q.GGML_Q4_K
                      else q.pack_q4_direct(reader.tensor(name, dtype=np.float32)))
            return Q4Weight.from_packed(packed, device=device)
        return Q4KWeight.from_numpy(*_mxu_parts(reader, name), device=device)

    def attn_leaf(mine, name):
        if mine in _MLA_NORMS or mine == "wkv_b":
            return f32(name)
        return weight(name, kernel6=mine == "wkv_a")

    jobs = [(i, mine, f"blk.{i}.{suffix}") for i in range(cfg.num_layers)
            for mine, suffix in _MLA_ATTN.items()]
    jobs += [(i, mine, f"blk.{i}.{suffix}") for i in range(cfg.first_k_dense_replace)
             for mine, suffix in _MLA_DENSE.items()]
    moe_layers = range(cfg.first_k_dense_replace, cfg.num_layers)
    jobs += [(i, mine, f"blk.{i}.{_MLA_MOE[mine]}") for i in moe_layers
             for mine in ("router", "router_bias")]

    def load(job):
        _, mine, name = job
        if mine in _MLA_DENSE:
            return weight(name)
        if mine in ("router", "router_bias"):
            return f32(name)
        return attn_leaf(mine, name)

    head_name = "output.weight" if "output.weight" in reader.tensors else "token_embd.weight"

    def head():
        if precision != "int4":
            return weight(head_name)
        parts = pad_rows(*pad_rows(*_mxu_parts(reader, head_name)), multiple=1024)
        return Q4KWeight.from_numpy(*parts, device=device)

    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        loaded = list(pool.map(load, jobs))
        head_w = pool.submit(head).result()
    layers: list[dict] = [{} for _ in range(cfg.num_layers)]
    for (i, mine, _), v in zip(jobs, loaded):
        layers[i][mine] = v
    m, d = cfg.moe_intermediate_size, cfg.hidden_size
    for i in moe_layers:
        raw = {mine: _device_bytes(reader, f"blk.{i}.{_MLA_MOE[mine]}", device)
               for mine in _MLA_EXPERTS}
        e = cfg.n_routed_experts
        layers[i]["experts"] = from_q4_0(
            raw["gate_exps"].reshape(e, m, -1), raw["up_exps"].reshape(e, m, -1),
            raw["down_exps"].reshape(e, d, -1), m, d,
            shared=(raw["gate_shexp"].reshape(cfg.n_shared_experts * m, -1),
                    raw["up_shexp"].reshape(cfg.n_shared_experts * m, -1),
                    raw["down_shexp"].reshape(d, -1)))
        del raw
    params = {"embed": _embed(reader, device, dense_dtype), "layers": layers,
              "final_norm": f32("output_norm.weight"), "lm_head": head_w}
    return cfg, params, tokenizer


def mla_moe_shapes(cfg: MLAMoEConfig) -> dict:
    """Parameter shapes with stacked layers: "layers" (every layer's
    attention and norms), "dense_layers" (the first `first_k_dense_replace`
    layers' MLP), "moe_layers" (every later layer's router, its bias, the
    routed experts [E, M, D] / [E, D, M] and the shared SwiGLU)."""
    d, n, h = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nd = cfg.first_k_dense_replace
    nm, e, m = n - nd, cfg.n_routed_experts, cfg.moe_intermediate_size
    ms = cfg.n_shared_experts * m
    return {
        "embed": (cfg.vocab_size, d), "final_norm": (d,), "lm_head": (cfg.vocab_size, d),
        "layers": {"attn_norm": (n, d), "wq": (n, h * cfg.qk_head_dim, d),
                   "wkv_a": (n, r + rope, d), "kv_a_norm": (n, r),
                   "wkv_b": (n, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r),
                   "wo": (n, d, h * cfg.v_head_dim), "mlp_norm": (n, d)},
        "dense_layers": {"gate_proj": (nd, cfg.intermediate_size, d),
                         "up_proj": (nd, cfg.intermediate_size, d),
                         "down_proj": (nd, d, cfg.intermediate_size)},
        "moe_layers": {"router": (nm, e, d), "router_bias": (nm, e),
                       "gate_exps": (nm, e, m, d), "up_exps": (nm, e, m, d),
                       "down_exps": (nm, e, d, m), "gate_shexp": (nm, ms, d),
                       "up_shexp": (nm, ms, d), "down_shexp": (nm, d, ms)},
    }


def save_mla_moe_gguf(path: str, cfg: MLAMoEConfig, params: dict,
                      tokenizer: BPETokenizer) -> None:
    """A deepseek2 GGUF from dense numpy params shaped as `mla_moe_shapes`:
    q4_k matrices where their rows are whole 256-blocks (f16 otherwise),
    q4_0 experts, f32 router, bias and norms, q6_k embed and head. Lands
    atomically."""
    tmp_path = path + ".tmp"
    a = MLA_ARCH
    w = GGUFWriter(tmp_path, arch=a)
    for key, val in (("block_count", cfg.num_layers), ("embedding_length", cfg.hidden_size),
                     ("feed_forward_length", cfg.intermediate_size),
                     ("attention.head_count", cfg.num_heads),
                     ("attention.head_count_kv", cfg.num_heads),
                     ("attention.kv_lora_rank", cfg.kv_lora_rank),
                     ("attention.key_length", cfg.qk_head_dim),
                     ("attention.value_length", cfg.v_head_dim),
                     ("rope.dimension_count", cfg.qk_rope_head_dim),
                     ("leading_dense_block_count", cfg.first_k_dense_replace),
                     ("expert_feed_forward_length", cfg.moe_intermediate_size),
                     ("expert_count", cfg.n_routed_experts),
                     ("expert_shared_count", cfg.n_shared_experts),
                     ("expert_used_count", cfg.num_experts_per_tok),
                     ("expert_gating_func", 2), ("vocab_size", cfg.vocab_size)):
        w.add_u32(f"{a}.{key}", int(val))
    w.add_f32(f"{a}.expert_weights_scale", cfg.routed_scaling_factor)
    w.add_bool(f"{a}.expert_weights_norm", cfg.norm_topk_prob)
    w.add_f32(f"{a}.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps)
    w.add_f32(f"{a}.rope.freq_base", cfg.rope_theta)
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_string("tokenizer.ggml.pre", "qwen2")
    w.add_str_array("tokenizer.ggml.tokens", tokenizer.tokens)
    w.add_str_array(
        "tokenizer.ggml.merges",
        [f"{x} {y}" for (x, y), _ in sorted(tokenizer.merge_ranks.items(), key=lambda kv: kv[1])])
    w.add_i32_array("tokenizer.ggml.token_type",
                    [3 if t in tokenizer.special_tokens else 1 for t in tokenizer.tokens])
    if tokenizer.eos_token_id is not None:
        w.add_u32("tokenizer.ggml.eos_token_id", tokenizer.eos_token_id)

    def np32(x):
        return np.asarray(x, dtype=np.float32)

    def matrix(arr, typ=q.GGML_Q4_K):
        return typ if arr.shape[-1] % q.QUANT_SIZES[typ][0] == 0 else q.GGML_F16

    def experts(name, arr):
        w.add_raw_tensor(name, q4_0.quantize_q4_0(arr), arr.shape, q4_0.GGML_Q4_0)

    embed, head = np32(params["embed"]), np32(params["lm_head"])
    w.add_tensor("token_embd.weight", embed, matrix(embed, q.GGML_Q6_K))
    w.add_tensor("output_norm.weight", np32(params["final_norm"]), q.GGML_F32)
    w.add_tensor("output.weight", head, matrix(head, q.GGML_Q6_K))
    nd = cfg.first_k_dense_replace
    for i in range(cfg.num_layers):
        for mine, suffix in _MLA_ATTN.items():
            arr = np32(params["layers"][mine][i])
            w.add_tensor(f"blk.{i}.{suffix}", arr,
                         q.GGML_F32 if mine in _MLA_NORMS else matrix(arr))
        if i < nd:
            for mine, suffix in _MLA_DENSE.items():
                arr = np32(params["dense_layers"][mine][i])
                w.add_tensor(f"blk.{i}.{suffix}", arr, matrix(arr))
            continue
        for mine, suffix in _MLA_MOE.items():
            arr = np32(params["moe_layers"][mine][i - nd])
            if mine in _MLA_EXPERTS:
                experts(f"blk.{i}.{suffix}", arr)
            else:
                w.add_tensor(f"blk.{i}.{suffix}", arr, q.GGML_F32)
    w.write()
    os.replace(tmp_path, path)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def save_encoder_safetensors(path: str, cfg: AudioEncoderConfig, params: dict) -> None:
    """Stacked-layer numpy params -> f32 safetensors with the config in the
    metadata (byte-identical to the JAX package's writer)."""
    flat = {k: np.asarray(v, dtype=np.float32) for k, v in _flatten(params).items()}
    safetensors_np.save_file(flat, path, metadata={"config": json.dumps(asdict(cfg))})


def _read_encoder(path: str) -> tuple[AudioEncoderConfig, dict[str, np.ndarray]]:
    flat, meta = safetensors_np.load_file(path)
    cfg = AudioEncoderConfig(**json.loads(meta["config"])) if "config" in meta else AudioEncoderConfig()
    return cfg, {k: np.array(v, dtype=np.float32) for k, v in flat.items()}  # off the mmap


def _encoder_tree(flat: dict[str, Any], n_layers: int) -> dict:
    """Flat "layers.<name>" stacked leaves -> {"layers": [per-layer dict]}."""
    tree: dict = {"layers": [{} for _ in range(n_layers)]}
    for name, v in flat.items():
        if name.startswith("layers."):
            for i in range(n_layers):
                tree["layers"][i][name[len("layers."):]] = v[i]
        else:
            tree[name] = v
    return tree


def load_encoder_safetensors(path: str, *, dtype=torch.float32, device="cpu"
                             ) -> tuple[AudioEncoderConfig, dict]:
    cfg, flat = _read_encoder(path)
    tensors = {k: _t(v, device, dtype) for k, v in flat.items()}
    return cfg, _encoder_tree(tensors, cfg.encoder_layers)


def load_encoder_half(path: str, *, device="cpu") -> tuple[AudioEncoderConfig, dict]:
    """The half-precision encoder of the JAX package: every f32 value
    rounded to f16 on the host (half the upload), then to bf16 on the
    device. Rounding twice gives other weights than one f32 -> bf16 cast."""
    cfg, flat = _read_encoder(path)
    tensors = {k: _t(v.astype(np.float16), device).to(torch.bfloat16) for k, v in flat.items()}
    return cfg, _encoder_tree(tensors, cfg.encoder_layers)


def load_encoder_quantized(path: str, *, group: int = 32, kind: str = "int4", device="cpu"
                           ) -> tuple[AudioEncoderConfig, dict]:
    """Encoder safetensors with its matmul weights quantized: kind "int4"
    packs them to group-32 asymmetric int4 (`Q4Weight`), "int8" to
    per-channel symmetric int8 (`Int8Weight`); everything else f32."""
    if kind not in ("int4", "int8"):
        raise ValueError(f"unknown encoder quant kind {kind!r}")
    cfg, flat = _read_encoder(path)
    qnames = set(_ENC_Q4_TOP) | {f"layers.{n}" for n in _ENC_Q4_LAYER}

    def pack(name_i):
        name, i = name_i
        w = flat[name] if i is None else flat[name][i]
        if kind == "int8":
            return _int8_weight(_int8_rows(w), device)
        return Q4Weight.from_packed(q.pack_q4_direct(w, group=group), device=device)

    jobs = [(n, None) for n in _ENC_Q4_TOP]
    jobs += [(f"layers.{n}", i) for n in _ENC_Q4_LAYER for i in range(cfg.encoder_layers)]
    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        packed = dict(zip(jobs, pool.map(pack, jobs)))
    tree = _encoder_tree({k: _t(v, device, torch.float32) for k, v in flat.items()
                          if k not in qnames}, cfg.encoder_layers)
    for (name, i), w in packed.items():
        if i is None:
            tree[name] = w
        else:
            tree["layers"][i][name[len("layers."):]] = w
    return cfg, tree


# --------------------------------------------------------------------------
# parameters carried across from the JAX package (tests)
# --------------------------------------------------------------------------


def _np_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a.view(np.uint16)).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _convert_leaf(v, device, index=None):
    pick = (lambda a: a) if index is None else (lambda a: np.asarray(a)[index])
    if all(hasattr(v, f) for f in ("packed", "sub_t", "min_t", "dd_t")):
        return Q4KWeight(*(_np_to_torch(pick(getattr(v, f)), device)
                           for f in ("packed", "sub_t", "min_t", "dd_t")))
    if all(hasattr(v, f) for f in ("packed", "scale", "minv")):
        return Q4Weight.from_reference(*(pick(getattr(v, f)) for f in ("packed", "scale", "minv")),
                                       device=device)
    if all(hasattr(v, f) for f in ("q", "scale")):
        return Int8Weight(*(_np_to_torch(pick(getattr(v, f)), device) for f in ("q", "scale")))
    return _np_to_torch(pick(v), device)


def from_jax_params(tree: dict, device="cpu") -> dict:
    """The JAX package's decoder or encoder parameter tree, with its leaves
    already converted to numpy (`jax.tree.map(np.asarray, params)`), as port
    parameters: stacked "layers" become a per-layer list; quantized
    containers are recognised by their fields."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            first = next(iter(v.values()))
            n = np.asarray(getattr(first, "packed", getattr(first, "q", first))).shape[0]
            out[k] = [{name: _convert_leaf(leaf, device, i) for name, leaf in v.items()}
                      for i in range(n)]
        else:
            out[k] = _convert_leaf(v, device)
    return out


# --------------------------------------------------------------------------
# checkpoint directories
# --------------------------------------------------------------------------


def save_thinker_config(model_dir: str, thinker: ThinkerConfig) -> None:
    cfg = {
        "audio_config": asdict(thinker.audio),
        "text_config": asdict(thinker.text),
        "audio_token_id": thinker.audio_token_id,
        "audio_start_token_id": thinker.audio_start_token_id,
        "im_start_token_id": thinker.im_start_token_id,
        "im_end_token_id": thinker.im_end_token_id,
        "asr_text_token_id": thinker.asr_text_token_id,
        "audio_end_token_id": thinker.audio_end_token_id,
        "eos_token_ids": list(thinker.eos_token_ids),
        "timestamp_token_id": thinker.timestamp_token_id,
        "timestamp_segment_ms": thinker.timestamp_segment_ms,
    }
    Path(model_dir, "config.json").write_text(json.dumps(cfg, indent=2))


def _text_config(raw: dict):
    return MLAMoEConfig(**raw) if "kv_lora_rank" in raw else TextDecoderConfig(**raw)


def load_thinker_config(model_dir: str) -> ThinkerConfig:
    p = Path(model_dir, "config.json")
    if not p.exists():
        return ThinkerConfig()
    raw = json.loads(p.read_text())
    return ThinkerConfig(
        audio=AudioEncoderConfig(**raw.get("audio_config", {})),
        text=_text_config(raw.get("text_config", {})),
        audio_token_id=raw.get("audio_token_id", 151646),
        audio_start_token_id=raw.get("audio_start_token_id", 151647),
        im_start_token_id=raw.get("im_start_token_id", 151644),
        im_end_token_id=raw.get("im_end_token_id", 151645),
        asr_text_token_id=raw.get("asr_text_token_id", 151704),
        audio_end_token_id=raw.get("audio_end_token_id", 151648),
        eos_token_ids=tuple(raw.get("eos_token_ids", (151645, 151643))),
        timestamp_token_id=raw.get("timestamp_token_id", 151705),
        timestamp_segment_ms=raw.get("timestamp_segment_ms", 80.0),
    )
