"""Generation runtime (counterpart of `qwen3_asr_gguf_tpu/runtime/generate.py`).

- `start_spliced` / `start_spliced_at`: assemble the prompt on the device
  from token ids plus the audio-embedding stream, prefill it (from position
  0, or on top of a reused cache prefix) and sample the first token;
- `decode_block`: up to `block` decode steps with the EOS latch and the
  repetition latch (<= 3 distinct tokens in the last 15), returning the
  tokens fed in;
- `SparseLogitsRunner`: one causal prefill with logits only at requested
  positions (the forced aligner's readout).

Prompts are padded to `prompt_bucket` lengths (padding keys are masked) and
decode attends to a window of the cache rounded up to 256 slots, as in the
JAX package. The KV cache is updated in place.

With a `mesh` (`parallel.sharding.make_mesh`, one process per rank) the
Generator runs tensor-parallel: every rank holds its Megatron tiles of the
unfused weights and a KV cache of kv_heads/tp heads, each layer ends in the
two all-reduces of `models.decoder`, and the vocab-split logits are gathered
before sampling. Sampling stays replicated: every rank samples the same
gathered logits with a generator seeded the same way, so the ranks emit the
same tokens without a broadcast.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import decoder as dec
from ..models.configs import TextDecoderConfig
from ..ops.sampling import sample
from ..parallel.collectives import broadcast_object


@dataclasses.dataclass
class GenState:
    cache: dict
    pos: int  # tokens already in the cache
    last_token: int  # sampled, not yet fed
    generator: torch.Generator
    done: bool


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def prompt_bucket(t: int) -> int:
    """128-token steps up to 1024, then 256 up to 2048, then 512."""
    if t <= 1024:
        return round_up(max(t, 1), 128)
    if t <= 2048:
        return round_up(t, 256)
    return round_up(t, 512)


class Generator:
    def __init__(
        self,
        params: dict,
        cfg: TextDecoderConfig,
        *,
        n_ctx: int = 2048,
        eos_ids: tuple[int, ...] = (151645, 151643),
        cache_dtype=torch.bfloat16,
        block: int = 64,
        dequant_prefill: bool = False,  # prefill on a dense bf16 copy of int4 weights
        fused_mlp: bool | None = None,
        device="cuda",
        mesh=None,
    ):
        """`fused_mlp`: the decode step's MLP through the fused int8 kernel
        (`ops.mlp.fused_mlp_matvec`) where the weights allow it
        (`_mlp_fusable`). None turns it on when the weights are on the card
        and off on the CPU, whose unfused side the goldens come from.

        `mesh`: a `DeviceMesh` ("data", "model") of the initialised world;
        `params` are the whole unfused weights (every rank passes the same),
        cut here into this rank's tiles. On the card every local tile must
        have its kernel (`parallel.sharding.check_local_tiles` raises
        otherwise). Prefill runs on the local tiles too: no dense prefill
        copy is made under a mesh."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.tp_group = None
        self.step_cfg = cfg  # the config of the local tiles the forward runs on
        self._seeds = None
        if mesh is not None:
            params = self._shard(params, mesh)
            dequant_prefill = False
            # one seed stream on every rank: the ranks sample in lockstep
            self._seeds = np.random.default_rng(
                broadcast_object(int(np.random.randint(0, 2**31 - 1))))
        self.params = params
        self.n_ctx = n_ctx
        self.eos_ids = frozenset(int(e) for e in eos_ids)
        self.cache_dtype = cache_dtype
        self.block = block
        self._dequant_prefill = dequant_prefill
        self._prefill_params = None
        if fused_mlp is None:
            fused_mlp = self.device.type == "cuda"
        self.fused_mlp = bool(fused_mlp) and self._mlp_fusable()
        self._layers_list = None

    def _shard(self, params: dict, mesh) -> dict:
        from ..parallel import sharding as S

        if any("qkv_proj" in layer or "gateup_proj" in layer for layer in params["layers"]):
            raise ValueError("sharded inference requires unfused layer weights")
        _, tp = S.mesh_dim(mesh, "model")
        self.tp_group = S.tp_group(mesh)
        self.step_cfg = S.local_config(self.cfg, tp)
        params = dict(params, lm_head=S.pad_head(params["lm_head"], tp))
        params = S.shard_params(mesh, params, S.decoder_param_specs(self.cfg, params))
        S.check_local_tiles(params["layers"], params["lm_head"], self.device.type)
        return params

    @property
    def prefill_params(self) -> dict:
        """Prefill-side weights, derived on first use."""
        if self._prefill_params is None:
            if self._dequant_prefill:
                from ..models.params import dequant_prefill_params

                self._prefill_params = dequant_prefill_params(self.params)
            else:
                self._prefill_params = self.params
        return self._prefill_params

    @property
    def layers_list(self) -> list:
        """The decode step's per-layer weights, derived on first use: with the
        fused MLP each `gateup_proj` is split into gate and up once."""
        if self._layers_list is None:
            layers = self.params["layers"]
            self._layers_list = dec.split_mlp_weights(layers) if self.fused_mlp else layers
        return self._layers_list

    def _mlp_fusable(self) -> bool:
        from ..ops.qtensor import Int8Weight

        layer = self.params["layers"][0]
        gu = layer.get("gateup_proj")
        if not isinstance(gu, Int8Weight):
            return False
        m, d = gu.q.shape[-2] // 2, gu.q.shape[-1]
        return m % 512 == 0 and d % 128 == 0 and isinstance(layer.get("down_proj"), Int8Weight)

    def new_cache(self) -> dict:
        # whole 256-slot tiles at any n_ctx: the decode window (a 256-slot
        # bucket) is then always one the attention kernel takes; positions
        # stay below n_ctx, so the extra slots are never attended to
        return dec.init_cache(self.step_cfg, round_up(self.n_ctx, 256), self.cache_dtype,
                              device=self.device)

    def _rng(self, seed: int | None) -> torch.Generator:
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1) if self._seeds is None
                       else self._seeds.integers(0, 2**31 - 1))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _padded_prompt(self, ids: np.ndarray, audio_mask: np.ndarray, padded_len: int):
        ids_p = np.zeros(padded_len, dtype=np.int64)
        mask_p = np.zeros(padded_len, dtype=bool)
        ids_p[: len(ids)] = ids[:padded_len]
        mask_p[: len(audio_mask)] = audio_mask[:padded_len]
        return (torch.from_numpy(ids_p).to(self.device),
                torch.from_numpy(mask_p).to(self.device))

    def _first_token(self, params, hidden, t, temperature, gen) -> int:
        logits = dec.lm_logits(params, hidden[t - 1], self.cfg.lm_head_dim, self.tp_group)
        return int(sample(logits, gen, temperature))

    def start_spliced(
        self,
        ids: np.ndarray,  # [T] prompt ids (0 at audio slots)
        audio_mask: np.ndarray,  # [T] bool, True where audio embeddings go
        audio_embd: torch.Tensor,  # [Ta, D] encoder output on the device
        *,
        length: int | None = None,
        temperature: float = 0.4,
        seed: int | None = None,
        cache: dict | None = None,
    ) -> GenState:
        """Prefill from position 0 and sample the first token."""
        t = int(ids.shape[0]) if length is None else int(length)
        if t > self.n_ctx:
            raise ValueError(f"prompt of {t} tokens exceeds n_ctx={self.n_ctx}")
        ids_p, mask_p = self._padded_prompt(ids, audio_mask, min(prompt_bucket(t), self.n_ctx))
        gen = self._rng(seed)
        cache = cache if cache is not None else self.new_cache()
        params = self.prefill_params
        embd = dec.splice_prompt(params, ids_p, mask_p, audio_embd)
        hidden, cache = dec.forward_prefill(params, self.step_cfg, embd, cache, length=t,
                                            tp_group=self.tp_group)
        tok = self._first_token(params, hidden, t, temperature, gen)
        return GenState(cache=cache, pos=t, last_token=tok, generator=gen,
                        done=tok in self.eos_ids)

    def start_spliced_at(
        self,
        ids: np.ndarray,  # [T] suffix ids (0 at audio slots)
        audio_mask: np.ndarray,
        audio_embd: torch.Tensor,
        *,
        start: int,  # first position of the suffix; cache[0:start) is reused
        cache: dict,
        length: int | None = None,
        temperature: float = 0.4,
        seed: int | None = None,
    ) -> GenState:
        """Suffix prefill with KV prefix reuse."""
        t = int(ids.shape[0]) if length is None else int(length)
        if start + t > self.n_ctx:
            raise ValueError(f"prompt of {start + t} tokens exceeds n_ctx={self.n_ctx}")
        ids_p, mask_p = self._padded_prompt(
            ids, audio_mask, min(prompt_bucket(t), self.n_ctx - start))
        prefix_window = min(round_up(max(start, 1), 64), self.n_ctx)
        gen = self._rng(seed)
        params = self.prefill_params
        embd = dec.splice_prompt(params, ids_p, mask_p, audio_embd)
        hidden, cache = dec.forward_prefill_at(
            params, self.step_cfg, embd, cache, start, prefix_window=prefix_window, length=t,
            tp_group=self.tp_group)
        tok = self._first_token(params, hidden, t, temperature, gen)
        return GenState(cache=cache, pos=start + t, last_token=tok, generator=gen,
                        done=tok in self.eos_ids)

    def restart_at(self, cache: dict, *, pos: int, last_token: int,
                   seed: int | None = None) -> GenState:
        """Re-seed generation at `pos` (the last prompt position) of an
        existing cache: the next block re-feeds that position's token,
        reproducing the prefill's last logits. The block emits its input
        token, so the caller drops the first emitted entry."""
        return GenState(cache=cache, pos=pos, last_token=int(last_token),
                        generator=self._rng(seed), done=False)

    def decode_block(self, state: GenState, temperature: float = 0.4
                     ) -> tuple[list[int], GenState, bool, bool]:
        """Up to `block` steps -> (tokens fed, state, finished, rep_aborted).
        The tokens exclude a sampled EOS; `finished` is set by EOS, by the
        repetition latch or by a full context."""
        if state.pos + self.block > self.n_ctx:
            return [], state, True, False  # context full
        # attend to the live prefix only, in 256-slot window buckets
        win = round_up(state.pos + self.block, 256)
        layers, final_norm = self.layers_list, self.params["final_norm"]
        emitted: list[int] = []
        tok, pos, done, aborted = state.last_token, state.pos, state.done, False
        while len(emitted) < self.block and not done:
            hidden, _ = dec.forward_step_layers(
                layers, final_norm, self.step_cfg, self.params["embed"][tok], state.cache, pos,
                attn_window=win, fused_mlp=self.fused_mlp, tp_group=self.tp_group,
            )
            logits = dec.lm_logits(self.params, hidden, self.cfg.lm_head_dim, self.tp_group)
            nxt = int(sample(logits, state.generator, temperature))
            emitted.append(tok)
            # repetition latch (<= 3 distinct in the last 15 fed tokens); the
            # engine's host check over the whole stable stream stays
            # authoritative across blocks
            rep = self.block > 15 and len(emitted) > 15 and len(set(emitted[-15:])) <= 3
            aborted |= rep
            done = nxt in self.eos_ids or rep
            tok, pos = nxt, pos + 1
        new_state = GenState(cache=state.cache, pos=pos, last_token=tok,
                             generator=state.generator, done=done)
        return emitted, new_state, done, aborted


class SparseLogitsRunner:
    """Single-prefill sparse-logits readout for the forced aligner: one
    causal prefill, logits only at the requested positions, and for
    `argmax_at` an argmax over the first `limit` classes on the device, so
    only the class indices come back to the host.

    Prompts and position lists are padded to 256-slot buckets as in the JAX
    package. Padding changes no number (padding keys are masked, and padded
    query rows stay finite under the -1e30 mask) but pins which rows exist."""

    def __init__(self, params: dict, cfg: TextDecoderConfig, *, n_ctx: int = 2048,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.n_ctx = n_ctx
        self.device = torch.device(device)

    def _pad_positions(self, positions: np.ndarray) -> torch.Tensor:
        n_pos = round_up(max(len(positions), 1), 256)
        pos_padded = np.zeros(n_pos, dtype=np.int64)
        pos_padded[: len(positions)] = positions
        return torch.from_numpy(pos_padded).to(self.device)

    def _prompt_pad(self, t: int) -> int:
        return min(round_up(max(prompt_bucket(t), 1), 256), self.n_ctx)

    def _logits(self, embd: torch.Tensor, length: int, positions: np.ndarray) -> torch.Tensor:
        hidden, _ = dec.forward_prefill(self.params, self.cfg, embd, None, length=length)
        sel = hidden[self._pad_positions(positions)]  # [n_positions, D]
        return dec.lm_logits(self.params, sel, self.cfg.lm_head_dim)

    def logits_at(self, embd: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """embd [T, D] prompt embeddings (host) -> f32 logits
        [len(positions), lm_head_dim]."""
        t = embd.shape[0]
        pad = self._prompt_pad(t) - t
        if pad:
            embd = np.concatenate([embd, np.zeros((pad, embd.shape[1]), embd.dtype)], axis=0)
        embd_dev = torch.from_numpy(np.ascontiguousarray(embd)).to(
            device=self.device, dtype=self.params["embed"].dtype)
        out = self._logits(embd_dev, t, positions)
        return out[: len(positions)].cpu().numpy()

    def argmax_at(self, ids: np.ndarray, audio_mask: np.ndarray, audio_embd: torch.Tensor,
                  positions: np.ndarray, limit: int) -> np.ndarray:
        """Prompt splice, prefill and restricted argmax on the device ->
        int32 class index per position."""
        t = len(ids)
        padded_len = self._prompt_pad(t)
        ids_p = np.zeros(padded_len, dtype=np.int64)
        ids_p[:t] = ids
        mask_p = np.zeros(padded_len, dtype=bool)
        mask_p[:t] = audio_mask
        embd = dec.splice_prompt(self.params, torch.from_numpy(ids_p).to(self.device),
                                 torch.from_numpy(mask_p).to(self.device), audio_embd)
        logits = self._logits(embd, t, positions)
        out = torch.argmax(logits[:, :limit], dim=-1).to(torch.int32)
        return out[: len(positions)].cpu().numpy()
