"""Device mesh and Megatron sharding rules (counterpart of
`qwen3_asr_gguf_tpu/parallel/sharding.py`).

One process per rank. `make_mesh` lays the initialised world out as a
`DeviceMesh` with dims ("data", "model"): data parallelism over the batch,
tensor parallelism over attention heads and MLP columns. A spec names, per
axis of a leaf, the mesh dim that splits it (None: whole); the tables below
are the JAX package's PartitionSpecs for one layer (its stacked leading
layer axis dropped: the port keeps a list of layers).

Column-parallel products (q / k / v, gate / up, the LM head on the vocab,
the encoder's q / k / v / fc1 / conv_out / proj1) split the out axis [N];
row-parallel ones (o, down, the encoder's o / fc2 / proj2) split the in axis
[K] and end in one all-reduce. `shard_params` cuts this rank's local tiles:
each tile dequantizes to exactly the same slice of the dense weight, for
every container:

- `Q4KWeight` pairs adjacent channels in a byte, so an N split is a row
  slice of `packed`; its scale planes are K-major [G, N] / [2S, N], their
  axes swapped relative to the spec; a K split lands on whole 256-wide
  superblocks (`int4_tp_supported`).
- `Q4Weight` holds element j and K/2 + j in one byte (natural order): a K
  split unpacks the nibbles, slices and repacks at the local K.
- `Int8Weight`: `q` like the dense weight; `scale` follows the out axis only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.configs import AudioEncoderConfig, TextDecoderConfig
from ..ops.q4k import BN, Q4KWeight
from ..ops.qtensor import Int8Weight, Q4Weight

DIMS = ("data", "model")
M = "model"

# per-layer decoder specs, weights [out, in]
DEC_LAYER_SPECS: dict[str, tuple] = {
    "attn_norm": (),
    "q_proj": (M, None),
    "k_proj": (M, None),
    "v_proj": (M, None),
    "o_proj": (None, M),
    "q_norm": (),
    "k_norm": (),
    "mlp_norm": (),
    "gate_proj": (M, None),
    "up_proj": (M, None),
    "down_proj": (None, M),
}
DEC_TOP_SPECS: dict[str, tuple] = {
    "embed": (None, None),  # replicated: every rank embeds the replicated tokens
    "final_norm": (),
    "lm_head": (M, None),  # vocab-split logits, gathered
}
ENC_LAYER_SPECS: dict[str, tuple] = {
    "ln1_w": (), "ln1_b": (),
    "q_w": (M, None), "q_b": (M,),
    "k_w": (M, None), "k_b": (M,),
    "v_w": (M, None), "v_b": (M,),
    "o_w": (None, M), "o_b": (),
    "ln2_w": (), "ln2_b": (),
    "fc1_w": (M, None), "fc1_b": (M,),
    "fc2_w": (None, M), "fc2_b": (),
}
ENC_TOP_SPECS: dict[str, tuple] = {
    "conv1_w": (), "conv1_b": (),
    "conv2_w": (), "conv2_b": (),
    "conv3_w": (), "conv3_b": (),
    "conv_out": (M, None),
    "pos_embed": (),
    "ln_post_w": (), "ln_post_b": (),
    "proj1_w": (M, None), "proj1_b": (M,),
    "proj2_w": (None, M), "proj2_b": (),
}


def make_mesh(shape: Optional[dict[str, int]] = None):
    """The initialised default process group as a `DeviceMesh` of dims
    ("data", "model"); `shape` e.g. {"model": 2} or {"data": 2, "model": 2}
    (a missing dim is 1; default: every rank on "model"). Raises when no
    group is initialised or its world size is not the product of `shape`:
    launch under `torchrun --nproc-per-node N` (then
    `parallel.launch.init_from_env()`) or `parallel.launch.spawn`."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed world: launch under "
            "`torchrun --nproc-per-node N` or `qwen3_asr_gguf_tpu_torch.parallel.launch.spawn`")
    world = dist.get_world_size()
    shape = dict(shape) if shape else {"model": world}
    unknown = set(shape) - set(DIMS)
    if unknown:
        raise ValueError(f"unknown mesh dims {sorted(unknown)}; known: {DIMS}")
    dims = tuple(int(shape.get(n, 1)) for n in DIMS)
    if dims[0] * dims[1] != world:
        raise ValueError(f"mesh {shape} wants {dims[0] * dims[1]} ranks, the world has {world}")
    # gloo groups (the CPU, or test worlds of several ranks on one card) lay
    # the mesh out on "cpu"; NCCL gives each rank its card
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, dims, mesh_dim_names=DIMS)


def mesh_dim(mesh, name: str) -> tuple[int, int]:
    """(this rank's coordinate, size) along mesh dim `name`."""
    return mesh.get_local_rank(name), mesh.size(DIMS.index(name))


def tp_group(mesh):
    """The "model" process group of `mesh`, or None without tensor
    parallelism (no mesh, or a "model" dim of 1)."""
    if mesh is None or mesh.size(DIMS.index(M)) == 1:
        return None
    return mesh.get_group(M)


def int4_tp_supported(cfg: TextDecoderConfig, model: int) -> bool:
    """Can the PACKED int4 decode path shard over `model` ways? Heads and
    KV heads must divide (Megatron tiles), and every K split must land on
    whole 256-wide q4_k superblocks (o_proj splits K = heads*head_dim,
    down_proj splits K = intermediate)."""
    return (
        model >= 1
        and cfg.num_heads % model == 0
        and cfg.num_kv_heads % model == 0
        and (cfg.num_heads * cfg.head_dim) % (model * 256) == 0
        and cfg.intermediate_size % (model * 256) == 0
    )


def local_config(cfg: TextDecoderConfig, tp: int) -> TextDecoderConfig:
    """The decoder config of one rank's tiles: heads and kv heads over tp."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads do not split "
                         f"{tp} ways")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def decoder_param_specs(cfg: TextDecoderConfig, params: Any | None = None) -> dict:
    """Spec tree of the port's decoder parameters (per-layer list)."""
    n = cfg.num_layers if params is None else len(params["layers"])
    return {**DEC_TOP_SPECS, "layers": [dict(DEC_LAYER_SPECS) for _ in range(n)]}


def decoder_cache_specs(cfg: TextDecoderConfig, cache_dtype=None) -> dict:
    """KV cache [S, Hkv, hd] split on the kv heads, an int8 cache's scales
    [S, Hkv] too: the cache of `local_config`, which each rank allocates
    itself (`models.decoder.init_cache`)."""
    specs = {"k": [(None, M, None)] * cfg.num_layers, "v": [(None, M, None)] * cfg.num_layers}
    if cache_dtype == torch.int8:
        specs["k_s"] = [(None, M)] * cfg.num_layers
        specs["v_s"] = [(None, M)] * cfg.num_layers
    return specs


def encoder_param_specs(cfg: AudioEncoderConfig) -> dict:
    return {**ENC_TOP_SPECS,
            "layers": [dict(ENC_LAYER_SPECS) for _ in range(cfg.encoder_layers)]}


# --------------------------------------------------------------------------
# local tiles
# --------------------------------------------------------------------------


def _narrow(t: torch.Tensor, axis: int, idx: int, n: int) -> torch.Tensor:
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split {n} ways")
    return t.narrow(axis, idx * (size // n), size // n).contiguous()


def _split_dense(t: torch.Tensor, spec: tuple, idx: int, n: int) -> torch.Tensor:
    for axis, name in enumerate(spec):
        if name == M:
            t = _narrow(t, axis, idx, n)
    return t


def _split_q4k(w: Q4KWeight, spec: tuple, idx: int, n: int) -> Q4KWeight:
    """packed [N/2, K] follows the dense spec (the channel pairs of a byte
    stay together: N/n is even); sub_t / min_t [K/32, N] and dd_t [2S, N]
    take it swapped."""
    swapped = (spec[1], spec[0])
    return Q4KWeight(packed=_split_dense(w.packed, spec, idx, n),
                     sub_t=_split_dense(w.sub_t, swapped, idx, n),
                     min_t=_split_dense(w.min_t, swapped, idx, n),
                     dd_t=_split_dense(w.dd_t, swapped, idx, n))


def _split_q4(w: Q4Weight, spec: tuple, idx: int, n: int) -> Q4Weight:
    """N split: rows of every plane. K split: the natural-order nibbles
    unpacked to [N, K], the local columns repacked at the local K (byte j:
    element j low, element K_local/2 + j high); scale and minv per 32-group
    columns."""
    packed, scale, minv = w.packed, w.scale, w.minv
    if spec[0] == M:
        packed, scale, minv = (_narrow(t, 0, idx, n) for t in (packed, scale, minv))
    if spec[1] == M:
        vals = torch.cat([packed & 0x0F, packed >> 4], dim=-1)  # [N, K]
        vals = _narrow(vals, 1, idx, n)
        half = vals.shape[1] // 2
        packed = (vals[:, :half] | (vals[:, half:] << 4)).contiguous()
        scale, minv = _narrow(scale, 1, idx, n), _narrow(minv, 1, idx, n)
    return Q4Weight(packed=packed, scale=scale, minv=minv)


def _split_int8(w: Int8Weight, spec: tuple, idx: int, n: int) -> Int8Weight:
    return Int8Weight(q=_split_dense(w.q, spec, idx, n),
                      scale=_split_dense(w.scale, spec[:1], idx, n))


def split_leaf(w: Any, spec: tuple, idx: int, n: int) -> Any:
    """Tile `idx` of `n` of one leaf under `spec` (a dense tensor or a
    quantized container); a leaf whose spec names no "model" axis is kept
    as it is (shared, not copied)."""
    if M not in spec or n == 1:
        return w
    if isinstance(w, Q4KWeight):
        return _split_q4k(w, spec, idx, n)
    if isinstance(w, Q4Weight):
        return _split_q4(w, spec, idx, n)
    if isinstance(w, Int8Weight):
        return _split_int8(w, spec, idx, n)
    return _split_dense(w, spec, idx, n)


def shard_params(mesh, params: Any, specs: Any) -> Any:
    """This rank's local tiles of `params` (a dict / list tree) under
    `specs` (the same tree with a spec tuple per leaf) along the mesh's
    "model" dim; replicated leaves are shared."""
    idx, n = mesh_dim(mesh, M)
    return shard_tree(params, specs, idx, n)


def shard_tree(params: Any, specs: Any, idx: int, n: int) -> Any:
    if isinstance(params, dict):
        return {k: shard_tree(v, specs[k], idx, n) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_tree(v, s, idx, n) for v, s in zip(params, specs)]
    return split_leaf(params, specs, idx, n)


def pad_head(head: Any, tp: int) -> Any:
    """The LM head with its rows zero-padded so that each of tp vocab tiles
    is whole: a `Q4KWeight` to a multiple of 2*BN*tp (each local tile whole
    kernel tiles), other weights to a multiple of tp. Zero rows give logits
    of exactly 0, which `lm_logits` slices away."""
    n_rows = head.shape[0]
    mult = 2 * BN * tp if isinstance(head, Q4KWeight) else tp
    pad = (-n_rows) % mult
    if not pad:
        return head

    def rows(t: torch.Tensor, k: int, axis: int = 0) -> torch.Tensor:
        shape = list(t.shape)
        shape[axis] = k
        return torch.cat([t, t.new_zeros(shape)], dim=axis)

    if isinstance(head, Q4KWeight):
        return Q4KWeight(packed=rows(head.packed, pad // 2), sub_t=rows(head.sub_t, pad, 1),
                         min_t=rows(head.min_t, pad, 1), dd_t=rows(head.dd_t, pad, 1))
    if isinstance(head, Q4Weight):
        return Q4Weight(*(rows(getattr(head, f), pad) for f in ("packed", "scale", "minv")))
    if isinstance(head, Int8Weight):
        return Int8Weight(q=rows(head.q, pad), scale=rows(head.scale, pad))
    return rows(head, pad)


def check_local_tiles(layers: list, head: Any, device_type: str) -> None:
    """Refuse, on the card, a local tile that a decode product (one row) or
    a batched rows product would take through dequant + dense instead of
    its kernel: a `Q4KWeight` needs N % 512 == 0 and K % 512 == 0 (kernels 1
    and 3 ask the same of the weight, `q4k.supported` / `supported_rows`), a `Q4Weight`
    whole 32-groups and K % 64 == 0 (kernel 6, `qmm.supported`). The JAX
    package's `int4_tp_supported` checks K only, so at tp = 4 the 1.7B
    k_proj / v_proj tiles (N = 256) would take its dense route. Raises
    ValueError naming the tile and the rule; on the CPU every product runs
    its plain version and nothing is refused."""
    from ..ops import q4k, qmm

    if device_type != "cuda":
        return
    tiles = [(f"layer {i} {name}", w) for i, layer in enumerate(layers)
             for name, w in layer.items()] + [("lm_head", head)]
    for where, w in tiles:
        if isinstance(w, Q4KWeight):
            n, k = w.shape
            if not q4k.supported((1, k), w):
                raise ValueError(
                    f"{where}: local q4_k tile N={n} K={k} has no kernel on the card "
                    f"(q4k_matvec / q4k_matmul_rows need N % {q4k.BN} == 0 and K % 512 == 0); "
                    "choose a smaller tensor-parallel width")
        elif isinstance(w, Q4Weight):
            n, k = w.shape
            if not qmm.supported((1, k), w):
                raise ValueError(
                    f"{where}: local int4 tile N={n} K={k} has no kernel on the card "
                    "(q4_matmul needs whole 32-groups and K % 64 == 0); choose a smaller "
                    "tensor-parallel width")
