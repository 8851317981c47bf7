"""Generation runtime (counterpart of `qwen3_asr_gguf_tpu/runtime/generate.py`).

- `start_spliced` / `start_spliced_at`: assemble the prompt on the device
  from token ids plus the audio-embedding stream, prefill it (from position
  0, or on top of a reused cache prefix) and sample the first token;
  `start_spliced_at_spec` assembles the suffix prompt on the device from the
  previous chunk's emitted-token buffer (`spec_assemble`), so the prefill is
  queued before the host has that chunk's tokens;
- `decode_block_dispatch`: queue up to `block` decode steps with the EOS
  latch and the repetition latch (<= 3 distinct tokens in the last 15) on
  the device, and one copy of the packed `[emitted..., done, aborted]` to
  the host; `collect_block` waits for that copy alone. `decode_block` is the
  two in a row.
- `prefill_cohort`: the batchers' admission prefill, every prompt of a
  cohort in one lanes pass of the decoder and one LM-head call;
- `SparseLogitsRunner`: one causal prefill with logits only at requested
  positions (the forced aligner's readout), and `argmax_at_spec`, which
  builds the aligner's prompt on the device from a block's emitted tokens.

The token, its position, the latches and the emitted buffer stay on the
device, as in the JAX package's `while_loop` block: nothing in a dispatched
block waits for the card. The JAX loop stops at the latch; here the host
stops queueing steps once it sees the latch set, reading the flags that the
queued steps copy to pinned host memory behind events that it only queries
(`DoneWatch`). Steps queued after the latch are no-ops: they hold the
token and the position, emit -1, and write only the slot at the held
position, which no later read sees before it is written again.

Prompts are padded to `prompt_bucket` lengths (padding keys are masked) and
decode attends to a window of the cache rounded up to 256 slots, as in the
JAX package. The KV cache is updated in place.

With a `mesh` (`parallel.sharding.make_mesh`, one process per rank) the
Generator runs tensor-parallel: every rank holds its Megatron tiles of the
unfused weights and a KV cache of kv_heads/tp heads, each layer ends in the
two all-reduces of `models.decoder`, and the vocab-split logits are gathered
before sampling. Sampling stays replicated: every rank samples the same
gathered logits with a generator seeded the same way, so the ranks emit the
same tokens without a broadcast. Under a mesh every block runs all its
steps (`early_exit` off): the ranks' collectives must meet, so no rank may
stop queueing on its own host's timing.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..models import decoder as dec
from ..models.configs import TextDecoderConfig
from ..ops.qtensor import kernel_rows
from ..ops.sampling import sample
from ..parallel.collectives import broadcast_object
from ..utils import profiling

REP_WINDOW = 15  # the repetition latch: <= REP_DISTINCT distinct tokens in the last 15
REP_DISTINCT = 3


class DoneWatch:
    """The host's view of a generation's device `done` latch, read without
    waiting. On the card each recorded latch is copied to pinned host memory
    behind an event, and `seen()` reads the copies whose events have
    completed (`Event.query` never blocks); on the CPU the latch is read
    directly."""

    def __init__(self):
        self._queue: collections.deque = collections.deque()
        self._seen = False

    def record(self, done: torch.Tensor) -> None:
        if self._seen:
            return
        if done.device.type != "cuda":
            self._seen = bool(done)
            return
        host = torch.empty(1, dtype=torch.bool, pin_memory=True)
        host.copy_(done, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(done.device))
        self._queue.append((event, host))

    def seen(self) -> bool:
        while not self._seen and self._queue and self._queue[0][0].query():
            self._seen = bool(self._queue.popleft()[1])
        return self._seen


class HostCopy:
    """A device tensor with its copy to pinned host memory queued behind the
    work that makes it; `fetch()` waits for that copy alone."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.event = None
        if dev.device.type == "cuda":
            self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self.host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev.device))
        else:
            self.host = dev

    @property
    def emitted(self) -> torch.Tensor:
        """A block's emitted-token buffer on the device: packed[:-2]."""
        return self.dev[:-2]

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class GenState:
    cache: dict
    pos: torch.Tensor  # [1] int32 on the device: tokens already in the cache
    last_token: torch.Tensor  # [1] int64 on the device: sampled, not yet fed
    generator: torch.Generator
    done: torch.Tensor  # [1] bool on the device: the EOS / repetition latch
    pos_bound: int  # host bound on pos: exact after a prefill, + block per block
    watch: DoneWatch = dataclasses.field(default_factory=DoneWatch)


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def prompt_bucket(t: int) -> int:
    """128-token steps up to 1024, then 256 up to 2048, then 512."""
    if t <= 1024:
        return round_up(max(t, 1), 128)
    if t <= 2048:
        return round_up(t, 256)
    return round_up(t, 512)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to the card through pinned memory without
    waiting (a copy from pageable memory would stop the host)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefill_cohort(params: dict, cfg: TextDecoderConfig, prompts: list, cache: dict,
                   t_pad: int, *, tp_group=None) -> torch.Tensor:
    """The admission prefill of a cohort (the JAX package's `prefill_stage`
    and `prefill_batch`): `prompts` holds (ids, audio_mask, audio_embd) per
    lane (host arrays of at most `t_pad`, and [Ta, D] on the device). Every
    lane is padded to `t_pad` and spliced, all of them prefill into the
    P-row `cache` at slots [0, t_pad) in one `forward_prefill_lanes` pass,
    and the lanes' last prompt rows take one `lm_logits` call (on the card
    padded to the head kernel's row tiles). Returns the first-token logits
    [P, V] (f32)."""
    p = len(prompts)
    device = prompts[0][2].device
    ids_p = np.zeros((p, t_pad), np.int64)
    mask_p = np.zeros((p, t_pad), bool)
    for lane, (ids, mask, _) in enumerate(prompts):
        ids_p[lane, : len(ids)] = ids
        mask_p[lane, : len(mask)] = mask
    lens = to_device(np.asarray([len(ids) for ids, _, _ in prompts], np.int64), device)
    audio = torch.nn.utils.rnn.pad_sequence([embd for _, _, embd in prompts], batch_first=True)
    x = dec.splice_prompt(params, to_device(ids_p, device), to_device(mask_p, device), audio)
    hidden, _ = dec.forward_prefill_lanes(params, cfg, x, cache, lens, tp_group=tp_group)
    last = hidden[torch.arange(p, device=device), lens - 1]
    if last.is_cuda and p > 1:
        # whole row tiles of the head's kernel (`kernel_rows`: an int4 head
        # takes 8-row tiles), not a dequantized copy of the head per cohort
        rows = kernel_rows(params["lm_head"], p)
        if rows != p:
            last = torch.cat([last, last.new_zeros(rows - p, last.shape[1])])
    return dec.lm_logits(params, last, cfg.lm_head_dim, tp_group)[:p]


def spec_assemble(template_ids: torch.Tensor, emitted: torch.Tensor, *, n_audio: int,
                  bucket: int, rollback: int, max_keep: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The speculative suffix prompt on the device (JAX `_build_spec_assemble`,
    generate.py:569-594): `bucket` ids with the template at `n_audio` and the
    previous block's first n_keep = clip(n_emit - rollback, 0, max_keep)
    emitted tokens after it (`emitted` [block] int64, -1 padded, EOS
    excluded) -> (ids [bucket] int64, length [1] int32 = n_audio + len(
    template) + n_keep), both on the device."""
    dev = emitted.device
    n_t = int(template_ids.shape[0])
    n_emit = (emitted >= 0).sum().view(1).to(torch.int32)
    n_keep = torch.clamp(n_emit - rollback, 0, max_keep)
    ids = torch.zeros(bucket + 1, dtype=torch.int64, device=dev)  # slot `bucket` takes the rest
    ids[n_audio: n_audio + n_t] = template_ids
    ar = torch.arange(emitted.shape[0], device=dev)
    keep = ar < n_keep
    ids.scatter_(0, torch.where(keep, ar + n_audio + n_t, bucket),
                 torch.where(keep, emitted.to(torch.int64), 0))
    return ids[:bucket], n_keep + (n_audio + n_t)


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
        self.eos_dev = torch.tensor(sorted(self.eos_ids), dtype=torch.int64, device=self.device)
        self.cache_dtype = cache_dtype
        self.block = block
        # stop queueing a block's steps once the host sees its latch set
        self.early_exit = mesh is None
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
        return to_device(ids_p, self.device), to_device(mask_p, self.device)

    def _is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        return (tok.view(-1, 1) == self.eos_dev).any(-1)

    def _start(self, params, hidden, length, temperature, gen, cache, pos, pos_bound: int
               ) -> GenState:
        """Sample the first token from the prompt's last row (`length` a host
        int or a [1] device tensor) and wrap the state; nothing is read back."""
        if isinstance(length, torch.Tensor):
            last = hidden.index_select(0, (length - 1).to(torch.int64))[0]
        else:
            last = hidden[length - 1]
        logits = dec.lm_logits(params, last, self.cfg.lm_head_dim, self.tp_group)
        tok = sample(logits, gen, temperature).view(1).to(torch.int64)
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        state = GenState(cache=cache, pos=pos, last_token=tok, generator=gen,
                         done=self._is_eos(tok), pos_bound=pos_bound)
        state.watch.record(state.done)
        return state

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
        return self._start(params, hidden, t, temperature, gen, cache, t, t)

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
        return self._prefill_at(ids_p, mask_p, audio_embd, start, cache, t, start + t,
                                temperature, seed)

    def _prefill_at(self, ids_p, mask_p, audio_embd, start: int, cache: dict, length,
                    pos_bound: int, temperature: float, seed) -> GenState:
        prefix_window = min(round_up(max(start, 1), 64), self.n_ctx)
        gen = self._rng(seed)
        params = self.prefill_params
        embd = dec.splice_prompt(params, ids_p, mask_p, audio_embd)
        hidden, cache = dec.forward_prefill_at(
            params, self.step_cfg, embd, cache, start, prefix_window=prefix_window,
            length=length, tp_group=self.tp_group)
        return self._start(params, hidden, length, temperature, gen, cache, start + length,
                           pos_bound)

    def start_spliced_at_spec(
        self,
        template_ids: np.ndarray,  # [n_t] suffix tokens after the audio span
        emitted: torch.Tensor,  # [block] int64 (-1 padded) from the previous chunk, on the device
        audio_embd: torch.Tensor,  # [Ta, D] this chunk's audio stream
        *,
        n_audio: int,  # audio tokens of the suffix
        start: int,  # cache prefix length
        cache: dict,
        rollback: int,
        max_keep: int,
        temperature: float = 0.4,
        seed: int | None = None,
    ) -> GenState:
        """Speculative suffix prefill (JAX generate.py:596-651): the prompt is
        assembled on the device from the previous chunk's emitted tokens
        (`spec_assemble`), so its length stays on the device too. The caller
        checks its own token accounting afterwards; on a mismatch or an abort
        the cache prefix [0:start) is still valid and a plain
        `start_spliced_at` redoes the chunk."""
        n_t = len(template_ids)
        t_max = n_audio + n_t + max_keep
        if start + t_max > self.n_ctx:
            raise ValueError(f"speculative prompt may exceed n_ctx ({start + t_max})")
        padded_len = min(prompt_bucket(t_max), self.n_ctx - start)
        ids_p, length = spec_assemble(
            to_device(np.asarray(template_ids, np.int64), self.device), emitted,
            n_audio=n_audio, bucket=padded_len, rollback=rollback, max_keep=max_keep)
        mask = np.zeros(padded_len, dtype=bool)
        mask[:n_audio] = True
        return self._prefill_at(ids_p, to_device(mask, self.device), audio_embd, start, cache,
                                length, start + t_max, temperature, seed)

    def restart_at(self, cache: dict, *, pos: int, last_token: int,
                   seed: int | None = None) -> GenState:
        """Re-seed generation at `pos` (the last prompt position) of an
        existing cache: the next block re-feeds that position's token,
        reproducing the prefill's last logits. The block emits its input
        token, so the caller drops the first emitted entry."""
        dev = self.device
        return GenState(cache=cache, pos=torch.full((1,), pos, dtype=torch.int32, device=dev),
                        last_token=torch.full((1,), int(last_token), dtype=torch.int64,
                                              device=dev),
                        generator=self._rng(seed),
                        done=torch.zeros(1, dtype=torch.bool, device=dev), pos_bound=pos)

    def decode_block_dispatch(self, state: GenState, temperature: float = 0.4,
                              pos_bound: int | None = None
                              ) -> tuple[GenState, HostCopy | None]:
        """Queue one block of up to `block` steps without waiting (JAX
        generate.py:729-771) -> (state after the block, its packed
        `[emitted..., done, aborted]` with the copy to the host queued), or
        (state, None) when the context is full. `emitted` holds the tokens
        fed, -1 where no token was (a latched step, or one never queued).
        `pos_bound` (else `state.pos_bound`) sets the 256-slot window bucket
        and the context-full check without reading `pos`. A block queued
        after the latch is set only holds it. One `decode.dispatch` span; the
        steps queued go to the `decode.steps` counter."""
        with profiling.span("decode.dispatch"):
            return self._dispatch(state, temperature, pos_bound)

    def _dispatch(self, state: GenState, temperature: float, pos_bound: int | None
                  ) -> tuple[GenState, HostCopy | None]:
        bound = state.pos_bound if pos_bound is None else int(pos_bound)
        if bound + self.block > self.n_ctx:
            return state, None  # context full
        # attend to the live prefix only, in 256-slot window buckets
        win = round_up(bound + self.block, 256)
        layers, final_norm = self.layers_list, self.params["final_norm"]
        embed = self.params["embed"]
        dev = self.device
        tok, pos, done = state.last_token, state.pos, state.done
        aborted = torch.zeros(1, dtype=torch.bool, device=dev)
        emitted = torch.full((self.block,), -1, dtype=torch.int64, device=dev)
        steps = self.block
        for i in range(self.block):
            if self.early_exit and state.watch.seen():
                steps = i
                break  # the remaining steps would only hold the latch
            hidden, _ = dec.forward_step_layers(
                layers, final_norm, self.step_cfg, embed.index_select(0, tok)[0], state.cache,
                pos, attn_window=win, fused_mlp=self.fused_mlp, tp_group=self.tp_group)
            logits = dec.lm_logits(self.params, hidden, self.cfg.lm_head_dim, self.tp_group)
            nxt = sample(logits, state.generator, temperature).view(1).to(torch.int64)
            live = ~done
            emitted[i: i + 1] = torch.where(live, tok, -1)
            stop = self._is_eos(nxt)
            if self.block > REP_WINDOW and i >= REP_WINDOW:
                # the repetition latch of JAX generate.py:443-460: <= 3
                # distinct tokens among this block's last 15 emitted; the
                # engine's host check over the stable stream stays
                # authoritative across blocks
                win_toks = emitted[i - REP_WINDOW + 1: i + 1]
                eq = win_toks[:, None] == win_toks[None, :]
                first = torch.tril(eq, diagonal=-1).sum(1) == 0
                distinct = (first & (win_toks >= 0)).sum()
                rep = live & (distinct <= REP_DISTINCT)
                aborted = aborted | rep
                stop = stop | rep
            tok = torch.where(live, nxt, tok)
            pos = pos + live.to(torch.int32)
            done = done | stop
            state.watch.record(done)
        profiling.count("decode.steps", steps)
        packed = torch.cat([emitted, done.to(torch.int64), aborted.to(torch.int64)])
        new_state = GenState(cache=state.cache, pos=pos, last_token=tok,
                             generator=state.generator, done=done,
                             pos_bound=bound + self.block, watch=state.watch)
        return new_state, HostCopy(packed)

    @staticmethod
    def collect_block(packed: HostCopy | None) -> tuple[list[int], bool, bool]:
        """(tokens fed, finished, rep_aborted) of a dispatched block: one wait
        for its packed copy. The tokens exclude a sampled EOS; `finished` is
        set by EOS, by the repetition latch or by a full context (None)."""
        if packed is None:
            return [], True, False
        with profiling.span("decode.collect"):
            arr = packed.fetch()
        return [int(t) for t in arr[:-2] if t >= 0], bool(arr[-2]), bool(arr[-1])

    def decode_block(self, state: GenState, temperature: float = 0.4
                     ) -> tuple[list[int], GenState, bool, bool]:
        """Up to `block` steps -> (tokens fed, state, finished, rep_aborted)."""
        new_state, packed = self.decode_block_dispatch(state, temperature)
        toks, finished, aborted = self.collect_block(packed)
        return toks, new_state, finished, aborted


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

    def argmax_at_spec(self, toks: torch.Tensor, cls_tab: torch.Tensor,
                       audio_embd: torch.Tensor, n_audio: int, limit: int,
                       special: tuple[int, int, int], drop_last: int = 0
                       ) -> HostCopy | None:
        """The speculative align prefill (JAX generate.py:852-937), queued
        with no host value from the block: the prompt is built on the device
        from a decode block's emitted buffer `toks` ([block] int64, -1
        padded). Of the valid tokens, the last `drop_last` are left out (the
        rollback trim of a non-final chunk); each remaining token whose
        word class (`cls_tab`, int8 [vocab]: 2 a one-character CJK word, 1
        droppable, 0 host path only) is 2 becomes one `word TS TS` triplet
        after <|audio_start|> AUDIO <|audio_end|> (`special` = (AUDIO_START,
        AUDIO_END, TIMESTAMP)). -> `[ts at each TS slot..., n_words]` int32
        with its copy to the host queued, or None when the longest such
        prompt would not fit n_ctx. The caller holds the result to `align()`'s
        own prompt before trusting it."""
        dev = self.device
        n_slots = int(toks.shape[0])
        if n_audio + 2 + 3 * n_slots > self.n_ctx:
            return None
        total = self._prompt_pad(n_audio + 2 + 3 * n_slots)
        n_pos = round_up(max(2 * n_slots, 1), 256)
        tok_start, tok_end, tok_ts = special
        j = torch.arange(n_slots, device=dev)
        valid = toks >= 0
        used = valid & (j < valid.sum() - drop_last)
        cls = torch.where(used, cls_tab[torch.clamp(toks, min=0)].to(torch.int64), 1)
        keep = cls == 2
        kidx = torch.cumsum(keep.to(torch.int64), 0) - 1  # word slot of each kept token
        n_words = keep.sum()
        prefix = n_audio + 2  # AUDIO_START, the audio rows, AUDIO_END
        ids = torch.zeros(total + 1, dtype=torch.int64, device=dev)  # slot `total` takes the rest
        ids[0], ids[1 + n_audio] = tok_start, tok_end
        live = j < n_words
        slot = prefix + 3 * j
        ts = torch.full_like(j, tok_ts)
        ids.scatter_(0, torch.where(live, slot + 1, total), ts)
        ids.scatter_(0, torch.where(live, slot + 2, total), ts)
        ids.scatter_(0, torch.where(keep, prefix + 3 * kidx, total), toks)
        pos_t = torch.arange(total, device=dev)
        mask = (pos_t >= 1) & (pos_t < 1 + n_audio)
        embd = dec.splice_prompt(self.params, ids[:total], mask, audio_embd)
        hidden, _ = dec.forward_prefill(self.params, self.cfg, embd, None,
                                        length=(prefix + 3 * n_words).view(1))
        k = torch.arange(n_pos, device=dev)
        pos = torch.where(k < 2 * n_words, prefix + 3 * (k // 2) + 1 + (k % 2), 0)
        logits = dec.lm_logits(self.params, hidden[pos], self.cfg.lm_head_dim)
        out = torch.argmax(logits[:, :limit], dim=-1)
        return HostCopy(torch.cat([out, n_words.view(1)]).to(torch.int32))

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
