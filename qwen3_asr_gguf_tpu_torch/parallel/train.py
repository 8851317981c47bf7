"""Fine-tuning step of the thinker (counterpart of
`qwen3_asr_gguf_tpu/parallel/train.py`): audio encoder -> prompt splice ->
decoder -> cross-entropy -> AdamW, under tensor parallelism on "model" (the
Megatron tiles of `sharding`, with the autograd-aware collectives of
`collectives`) and data parallelism on "data" (each rank takes its share of
the global batch; the gradients are averaged over "data").

Replicated leaves that act on one rank's shard get partial gradients, which
are all-reduced over "model": the decoder's q_norm / k_norm act on the
local heads only. Every other replicated leaf acts on replicated
activations and gets its whole gradient on every rank.

The checkpoint is `torch.save` of the whole (gathered) tensors, the AdamW
moments and the step, restored into any mesh's tiles (orbax, the JAX
package's format, is not used).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import decoder as dec
from ..models import encoder as enc
from ..models.configs import ThinkerConfig
from . import collectives as C
from . import sharding as S

PARTIAL_GRAD_LEAVES = ("q_norm", "k_norm")  # replicated, applied to local heads only


@dataclass
class TrainState:
    params: Any  # {"encoder": ..., "decoder": ...}: this rank's tiles, leaf tensors
    opt_state: torch.optim.AdamW  # holds the moments of `params`' leaves
    step: int


def thinker_param_specs(cfg: ThinkerConfig) -> dict:
    return {"encoder": S.encoder_param_specs(cfg.audio),
            "decoder": S.decoder_param_specs(cfg.text)}


def init_params(cfg: ThinkerConfig, seed: int, device="cpu") -> dict:
    """Whole thinker parameters in the JAX package's `init_params` shapes and
    scale (normal x 0.02; norms and LayerNorm weights 1, biases 0, the
    encoder's positions the sinusoid table), drawn in f32 from a
    `torch.Generator`, as per-layer lists."""
    gen = torch.Generator().manual_seed(seed)

    def fill(name: str, shape: tuple) -> torch.Tensor:
        if name == "pos_embed":
            return torch.from_numpy(enc.sinusoid_positions(*shape))
        if "norm" in name or name in ("ln1_w", "ln2_w", "ln_post_w"):
            return torch.ones(shape)
        if name.endswith("_b"):
            return torch.zeros(shape)
        return torch.randn(shape, generator=gen) * 0.02

    def tree(shapes: dict) -> dict:
        out = {k: fill(k, v) for k, v in shapes.items() if k != "layers"}
        stacked = {k: fill(k, v) for k, v in shapes["layers"].items()}
        n = next(iter(stacked.values())).shape[0]
        out["layers"] = [{k: v[i].clone().to(device) for k, v in stacked.items()}
                         for i in range(n)]
        return {k: (v if k == "layers" else v.to(device)) for k, v in out.items()}

    return {"encoder": tree(enc.init_shapes(cfg.audio)),
            "decoder": tree(dec.init_shapes(cfg.text))}


def _leaves(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _forward_loss(params: dict, cfg: ThinkerConfig, batch: dict, *, tp_group=None,
                  loss_den=None):
    """batch: mel [B, n_mels, Tmel], tokens [B, T] int64, loss_mask [B, T],
    audio_mask [B, T] bool (True where the audio embedding stream is
    spliced). Returns (nll*mask).sum() / max(mask.sum(), 1), with the
    denominator `loss_den` when given (the global batch's mask count under
    data parallelism). The last position never trains (its rolled target
    wraps to tokens[0])."""
    text_cfg = cfg.text
    if tp_group is not None:
        text_cfg = S.local_config(cfg.text, dist.get_world_size(tp_group))
    mel, tokens = batch["mel"], batch["tokens"]
    hidden = enc.conv_frontend(params["encoder"], cfg.audio, mel, tp_group)  # [B, Ta, D]
    audio_embd = enc.backend_transformer(params["encoder"], cfg.audio, hidden,
                                         tp_group=tp_group)
    text_embd = params["decoder"]["embed"][tokens]  # [B, T, D]
    ta = audio_embd.shape[1]
    audio_mask = batch["audio_mask"]
    positions = torch.cumsum(audio_mask.to(torch.int64), dim=-1) - 1
    idx = torch.clamp(positions, 0, ta - 1)[..., None].expand(-1, -1, audio_embd.shape[-1])
    gathered = torch.gather(audio_embd, 1, idx)
    embd = torch.where(audio_mask[..., None], gathered, text_embd)
    logits = []
    for row in embd:  # the decoder prefill takes one sequence
        h, _ = dec.forward_prefill(params["decoder"], text_cfg, row, None, tp_group=tp_group)
        logits.append(dec.lm_logits(params["decoder"], h, tp_group=tp_group))
    logits = torch.stack(logits)  # [B, T, V]
    targets = torch.roll(tokens, -1, dims=-1)
    t_len = tokens.shape[-1]
    mask = batch["loss_mask"].float() * (torch.arange(t_len, device=tokens.device)
                                         < t_len - 1).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    den = mask.sum() if loss_den is None else loss_den
    return (nll * mask).sum() / torch.clamp(den, min=1.0)


def make_train_step(cfg: ThinkerConfig, mesh=None, *, learning_rate: float = 1e-4,
                    weight_decay: float = 0.01, device="cpu"):
    """(init_fn, step_fn). `init_fn(seed)` -> TrainState of this rank's tiles
    (`init_params` cut by `thinker_param_specs`); `step_fn(state, batch)` ->
    (state, loss) for the GLOBAL batch (every rank passes the same one; a
    rank of data coordinate d takes rows [d*B/dp, (d+1)*B/dp)). AdamW with
    betas (0.9, 0.999), eps 1e-8 and decoupled decay on every leaf, as
    `optax.adamw(learning_rate, weight_decay=weight_decay)`. `mesh=None`
    trains in one process."""
    tp_group = S.tp_group(mesh)
    dp_idx, dp = (0, 1) if mesh is None else S.mesh_dim(mesh, "data")
    dp_group = mesh.get_group("data") if dp > 1 else None
    specs = thinker_param_specs(cfg)

    def init_fn(seed: int) -> TrainState:
        params = init_params(cfg, seed, device)
        if mesh is not None:
            params = S.shard_params(mesh, params, specs)
        return new_state(params)

    def new_state(params: dict) -> TrainState:
        leaves = [t.detach().clone().requires_grad_(True) for _, t in _leaves(params)]
        params = _rebuild(params, iter(leaves))
        opt = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        return TrainState(params=params, opt_state=opt, step=0)

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, float]:
        b = batch["tokens"].shape[0]
        if b % dp:
            raise ValueError(f"batch of {b} does not split over data = {dp}")
        rows = slice(dp_idx * (b // dp), (dp_idx + 1) * (b // dp))
        local = {k: v[rows].to(device) for k, v in batch.items()}
        den = None
        if dp_group is not None:
            t_len = batch["tokens"].shape[-1]
            den = (batch["loss_mask"].float()[:, : t_len - 1].sum()).to(device)
        loss = _forward_loss(state.params, cfg, local, tp_group=tp_group, loss_den=den)
        opt = state.opt_state
        opt.zero_grad(set_to_none=False)
        (loss * dp).backward()  # each rank's share of the global mean, averaged below
        for name, leaf in _leaves(state.params):
            if tp_group is not None and name.rsplit(".", 1)[-1] in PARTIAL_GRAD_LEAVES:
                C.all_reduce(leaf.grad, tp_group)
            if dp_group is not None:
                C.all_reduce(leaf.grad, dp_group).div_(dp)
        opt.step()
        value = loss.detach()
        if dp_group is not None:
            value = C.all_reduce(value.clone(), dp_group)
        state.step += 1
        return state, float(value)

    step_fn.new_state = new_state  # a TrainState around given tiles (tests carry weights in)
    return init_fn, step_fn


def _rebuild(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


# --------------------------------------------------------------------------
# checkpoint / resume
# --------------------------------------------------------------------------


def _whole(t: torch.Tensor, spec: tuple, group) -> torch.Tensor:
    """The whole tensor of a tile split on `spec`'s "model" axis."""
    if group is None or S.M not in spec:
        return t.detach().cpu()
    return C.all_gather(t.detach(), group, spec.index(S.M)).cpu()


def save_checkpoint(path: str, state: TrainState, cfg: ThinkerConfig, mesh=None) -> None:
    """Write whole tensors (tiles gathered over "model"), the AdamW moments
    and the step; every rank calls it, rank 0 writes."""
    group = S.tp_group(mesh)
    specs = [s for _, s in _leaves(thinker_param_specs(cfg))]
    names_leaves = _leaves(state.params)
    opt = state.opt_state
    params, exp_avg, exp_avg_sq, steps = {}, {}, {}, {}
    for (name, leaf), spec in zip(names_leaves, specs):
        st = opt.state.get(leaf, {})
        params[name] = _whole(leaf, spec, group)
        if st:
            exp_avg[name] = _whole(st["exp_avg"], spec, group)
            exp_avg_sq[name] = _whole(st["exp_avg_sq"], spec, group)
            steps[name] = float(st["step"])
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save({"params": params, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
                    "opt_steps": steps, "step": state.step}, path)
    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(path: str, template: TrainState, cfg: ThinkerConfig,
                       mesh=None) -> TrainState:
    """The checkpoint's tensors cut into this rank's tiles of `template`
    (a state of `init_fn` on any mesh), moments and step included."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    idx, n = (0, 1) if mesh is None else S.mesh_dim(mesh, S.M)
    specs = [s for _, s in _leaves(thinker_param_specs(cfg))]
    opt = template.opt_state
    with torch.no_grad():
        for (name, leaf), spec in zip(_leaves(template.params), specs):
            leaf.copy_(S.split_leaf(ck["params"][name], spec, idx, n))
            if name in ck["exp_avg"]:
                opt.state[leaf] = {
                    "step": torch.tensor(ck["opt_steps"][name]),
                    "exp_avg": S.split_leaf(ck["exp_avg"][name], spec, idx, n).to(leaf.device),
                    "exp_avg_sq": S.split_leaf(ck["exp_avg_sq"][name], spec, idx,
                                               n).to(leaf.device),
                }
    template.step = int(ck["step"])
    return template


def thinker_batch(cfg: ThinkerConfig, b: int, t_mel: int, t_tok: int, n_audio: int,
                  seed: int = 0) -> dict:
    """A random batch in the dry run's layout: mel N(0, 1), random tokens,
    a random half of the positions in the loss, audio at slots
    1 .. n_audio."""
    rng = np.random.default_rng(seed)
    audio_mask = np.zeros((b, t_tok), dtype=bool)
    audio_mask[:, 1: 1 + n_audio] = True
    return {
        "mel": torch.from_numpy(rng.standard_normal((b, cfg.audio.num_mel_bins, t_mel))
                                .astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(0, cfg.text.vocab_size, (b, t_tok))),
        "loss_mask": torch.from_numpy((rng.random((b, t_tok)) < 0.5).astype(np.float32)),
        "audio_mask": torch.from_numpy(audio_mask),
    }
