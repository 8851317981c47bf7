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

A decode step is one body (`Generator._step`) that reads the step index
from a device counter and updates the token, position, latches and emitted
buffer in place. On the card without a mesh the host replays it as one
captured CUDA graph per step (`cuda_graphs`): a graph per (cache, 256-slot
window, greedy or not), captured at the first use of that key, on the
Generator's static buffers and its registered random generator, into which
each block copies its state and out of which it takes the result. The
graphs hold their cache's addresses, so `new_cache` then hands out the
persistent caches of a `CachePool`. The host stays at most `GRAPH_LAG` steps
ahead of the last step the card has finished, which bounds the work queued
after an EOS. Elsewhere the same body runs eagerly.

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
import threading
import time
import weakref

import numpy as np
import torch

from ..models import decoder as dec
from ..models import mla_moe
from ..models.configs import TextDecoderConfig
from ..models.mla_config import is_mla
from ..ops import _build
from ..ops.qtensor import kernel_rows
from ..ops.sampling import sample
from ..parallel.collectives import broadcast_object
from ..utils import profiling

REP_WINDOW = 15  # the repetition latch: <= REP_DISTINCT distinct tokens in the last 15
REP_DISTINCT = 3
# replayed steps the host queues past the last one the card has finished: it
# bounds the steps queued after an EOS or the repetition latch. Against 16, 32
# and a whole 96-step block on an H100, 3 made a 120 s call 3-5% slower where
# no block ended early and 9-40% faster where blocks latched (0.6B and 1.7B)
GRAPH_LAG = 3


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
        self.moe_hists: list = []  # the prefills' routing histograms this block waits behind
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


class PooledCache(dict):
    """A KV cache handed out by a `CachePool`: the slot's tensors, in a dict
    of its own whose collection gives the slot back."""

    slot: int


class CachePool:
    """Persistent KV caches, one per slot, each handed out to one holder at
    a time: a captured decode graph holds its cache's addresses, so the
    caches it replays on must outlive every call. `take()` zeroes a free
    slot's tensors (as a fresh cache) and returns them in a `PooledCache`;
    the slot is free again once nothing holds that dict. `size` is the
    number of slots made: the most that were held at once."""

    def __init__(self, make):
        self._make = make
        self._caches: list[dict] = []
        self._free: list[int] = []
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self._caches)

    def take(self) -> PooledCache:
        with self._lock:
            if self._free:
                slot = min(self._free)
                self._free.remove(slot)
                fresh = False
            else:
                slot, fresh = len(self._caches), True
                self._caches.append(self._make())
        cache = PooledCache(self._caches[slot])
        if not fresh:
            for tensors in cache.values():
                for t in tensors:
                    t.zero_()
        cache.slot = slot
        weakref.finalize(cache, self._give_back, slot)
        return cache

    def owns(self, cache: dict) -> bool:
        """Whether `cache` holds this pool's own tensors of its slot (not a
        copy, nor another pool's slot)."""
        if not isinstance(cache, PooledCache) or cache.slot >= len(self._caches):
            return False
        mine = self._caches[cache.slot]
        return all(cache.get(key) is tensors for key, tensors in mine.items())

    def _give_back(self, slot: int) -> None:
        with self._lock:
            self._free.append(slot)


@dataclasses.dataclass
class StepBuffers:
    """A block's device state, updated in place by each step: the token to
    feed, its position, the EOS / repetition latch, the repetition abort,
    the tokens fed (-1 where none was) and the step index."""

    tok: torch.Tensor  # [1] int64
    pos: torch.Tensor  # [1] int32
    done: torch.Tensor  # [1] bool
    aborted: torch.Tensor  # [1] bool
    emitted: torch.Tensor  # [block] int64
    step: torch.Tensor  # [1] int64

    @classmethod
    def empty(cls, block: int, device) -> "StepBuffers":
        def z(dtype, n=1):
            return torch.zeros(n, dtype=dtype, device=device)

        return cls(z(torch.int64), z(torch.int32), z(torch.bool), z(torch.bool),
                   z(torch.int64, block), z(torch.int64))

    def load(self, state: "GenState") -> None:
        """Start a block from `state` (copies on the device)."""
        self.tok.copy_(state.last_token)
        self.pos.copy_(state.pos)
        self.done.copy_(state.done)
        self.aborted.zero_()
        self.emitted.fill_(-1)
        self.step.zero_()

    def packed(self) -> torch.Tensor:
        """`[emitted..., done, aborted]` (int64), a new tensor."""
        return torch.cat([self.emitted, self.done.to(torch.int64), self.aborted.to(torch.int64)])


class DecodeGraph:
    """One captured decode step and the kernel launches its capture counted
    (`ops._build.capture_tally`), added to the wrappers' counts at each
    replay."""

    def __init__(self, graph, launches: dict):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        _build.add_launches(self.launches)


@dataclasses.dataclass
class GenState:
    cache: dict
    pos: torch.Tensor  # [1] int32 on the device: tokens already in the cache
    last_token: torch.Tensor  # [1] int64 on the device: sampled, not yet fed
    generator: torch.Generator
    done: torch.Tensor  # [1] bool on the device: the EOS / repetition latch
    pos_bound: int  # host bound on pos: exact after a prefill, + block per block
    watch: DoneWatch = dataclasses.field(default_factory=DoneWatch)
    # the MoE prefill's per-layer expert row counts (`HostCopy`), read at the
    # first block's collect
    moe_hists: list = dataclasses.field(default_factory=list)


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
        cuda_graphs: bool = True,
    ):
        """`fused_mlp`: the decode step's MLP through the fused int8 kernel
        (`ops.mlp.fused_mlp_matvec`) where the weights allow it
        (`_mlp_fusable`). None turns it on when the weights are on the card
        and off on the CPU, whose unfused side the goldens come from.

        `cuda_graphs`: replay each decode step as a captured CUDA graph (see
        the module docstring); forced off on the CPU and under a mesh, whose
        ranks' collectives must meet step by step. A graph holds what the
        step called at its capture: this module's `sample` and the decoder's
        functions (`dec.lm_logits`, `ops.attn.gqa_decode_attention`, ...) as
        they were then, and the device buffers they used. So a wrapper of
        any of them (the benchmark's tap of `sample`) is installed before
        the first block is dispatched and outlives the Generator's last
        replay; one installed later is not called by the replays.

        `mesh`: a `DeviceMesh` ("data", "model") of the initialised world;
        `params` are the whole unfused weights (every rank passes the same),
        cut here into this rank's tiles. On the card every local tile must
        have its kernel (`parallel.sharding.check_local_tiles` raises
        otherwise). Prefill runs on the local tiles too: no dense prefill
        copy is made under a mesh."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        # the decoder's forwards: the latent-attention sparse-expert block or Qwen3's
        self.mla = is_mla(cfg)
        self.model = mla_moe if self.mla else dec
        if self.mla and mesh is not None:
            raise NotImplementedError("tensor parallelism does not run the latent-attention "
                                      "sparse-expert decoder (MLAMoEConfig)")
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
        # the repetition latch's window: the last REP_WINDOW slots up to the step index
        self._rep_back = torch.arange(1 - REP_WINDOW, 1, device=self.device)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda" and mesh is None
        self.cache_pool = CachePool(self._fresh_cache) if self.cuda_graphs else None
        # (cache slot, window, greedy, block) -> graph
        self.graphs: dict[tuple, DecodeGraph] = {}
        self._graph_lock = threading.Lock()  # one block at a time on the static buffers
        self._static: dict[int, StepBuffers] = {}  # per block length
        self._temp: torch.Tensor | None = None  # [1] f32: the non-greedy graphs' temperature
        self._graph_rng: torch.Generator | None = None
        self._graph_pool = self._capture_stream = None
        self._lag_events: list = []

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
        """Prefill-side weights, derived on first use (always for the
        sparse-expert decoder: its prefill takes the experts' dense copy)."""
        if self._prefill_params is None:
            if self._dequant_prefill or self.mla:
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
        """A zeroed KV cache: with `cuda_graphs` a free slot of the pool."""
        if self.cuda_graphs:
            return self.cache_pool.take()
        return self._fresh_cache()

    def _fresh_cache(self) -> dict:
        # whole 256-slot tiles at any n_ctx: the decode window (a 256-slot
        # bucket) is then always one the attention kernel takes; positions
        # stay below n_ctx, so the extra slots are never attended to
        return self.model.init_cache(self.step_cfg, round_up(self.n_ctx, 256),
                                     self.cache_dtype, device=self.device)

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

    def _prefill_kw(self, hists: list) -> dict:
        """The prefill's extra arguments: the MoE layers' row counts go to
        `hists`."""
        return {"hists": hists} if self.mla else {}

    def _start(self, params, hidden, length, temperature, gen, cache, pos, pos_bound: int,
               hists: list = ()) -> GenState:
        """Sample the first token from the prompt's last row (`length` a host
        int or a [1] device tensor) and wrap the state; nothing is read back.
        `hists`: the MoE prefill's per-layer expert row counts, copied to the
        host behind the prefill and read at the first block's collect."""
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
        if hists:
            state.moe_hists.append(HostCopy(torch.stack(list(hists))))
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
        hists: list = []
        hidden, cache = self.model.forward_prefill(params, self.step_cfg, embd, cache, length=t,
                                                   tp_group=self.tp_group,
                                                   **self._prefill_kw(hists))
        return self._start(params, hidden, t, temperature, gen, cache, t, t, hists)

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
        hists: list = []
        hidden, cache = self.model.forward_prefill_at(
            params, self.step_cfg, embd, cache, start, prefix_window=prefix_window,
            length=length, tp_group=self.tp_group, **self._prefill_kw(hists))
        return self._start(params, hidden, length, temperature, gen, cache, start + length,
                           pos_bound, hists)

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
        """Queue one block of up to `block` steps without waiting for its
        result (JAX generate.py:729-771) -> (state after the block, its packed
        `[emitted..., done, aborted]` with the copy to the host queued), or
        (state, None) when the context is full. `emitted` holds the tokens
        fed, -1 where no token was (a latched step, or one never queued).
        `pos_bound` (else `state.pos_bound`) sets the 256-slot window bucket
        and the context-full check without reading `pos`. A block queued
        after the latch is set only holds it. Replayed steps are queued at
        most `GRAPH_LAG` ahead of the last one the card has finished, so the
        host returns when the card is that close to the block's end. One
        `decode.dispatch` span; the steps queued go to the `decode.steps`
        counter, those of them replayed as a CUDA graph to
        `decode.graph_replays`."""
        with profiling.span("decode.dispatch"):
            return self._dispatch(state, temperature, pos_bound)

    def _dispatch(self, state: GenState, temperature: float, pos_bound: int | None
                  ) -> tuple[GenState, HostCopy | None]:
        bound = state.pos_bound if pos_bound is None else int(pos_bound)
        if bound + self.block > self.n_ctx:
            return state, None  # context full
        # attend to the live prefix only, in 256-slot window buckets
        win = round_up(bound + self.block, 256)
        if self.cuda_graphs and self.cache_pool.owns(state.cache):
            with self._graph_lock:
                b, steps = self._graphed_block(state, win, temperature)
                packed = b.packed()
                pos, tok, done = b.pos.clone(), b.tok.clone(), b.done.clone()
        else:
            b = StepBuffers.empty(self.block, self.device)
            b.load(state)
            steps = self.block
            for i in range(self.block):
                if self.early_exit and state.watch.seen():
                    steps = i
                    break  # the remaining steps would only hold the latch
                self._step(b, state.cache, win, temperature, state.generator)
                state.watch.record(b.done)
            packed, pos, tok, done = b.packed(), b.pos, b.tok, b.done
        profiling.count("decode.steps", steps)
        new_state = GenState(cache=state.cache, pos=pos, last_token=tok,
                             generator=state.generator, done=done,
                             pos_bound=bound + self.block, watch=state.watch)
        out = HostCopy(packed)
        out.moe_hists, state.moe_hists = state.moe_hists, []
        return new_state, out

    def _step(self, b: StepBuffers, cache: dict, win: int, temperature,
              generator: torch.Generator) -> None:
        """One decode step on `b`, in place, with no host value of the step:
        the token at `b.pos` goes through the decoder (its K/V written at
        `b.pos`), the next one is sampled, the token fed is written to
        `b.emitted` at the step index and the latches are updated. A step
        after the latch holds the token and the position and emits -1.
        `temperature`: a float, or the [1] f32 device tensor of a non-greedy
        graph. The repetition latch (JAX generate.py:443-460): <= 3 distinct
        tokens among this block's last 15 emitted, from its 16th step on; the
        engine's host check over the stable stream stays authoritative
        across blocks."""
        hidden, _ = self.model.forward_step_layers(
            self.layers_list, self.params["final_norm"], self.step_cfg,
            self.params["embed"].index_select(0, b.tok)[0], cache, b.pos, attn_window=win,
            fused_mlp=self.fused_mlp, tp_group=self.tp_group)
        logits = dec.lm_logits(self.params, hidden, self.cfg.lm_head_dim, self.tp_group)
        nxt = sample(logits, generator, temperature).view(1).to(torch.int64)
        live = ~b.done
        b.emitted.index_copy_(0, b.step, torch.where(live, b.tok, -1))
        stop = self._is_eos(nxt)
        if self.block > REP_WINDOW:
            win_toks = b.emitted.index_select(0, torch.clamp(b.step + self._rep_back, min=0))
            eq = win_toks[:, None] == win_toks[None, :]
            first = torch.tril(eq, diagonal=-1).sum(1) == 0
            distinct = (first & (win_toks >= 0)).sum()
            rep = live & (distinct <= REP_DISTINCT) & (b.step >= REP_WINDOW)
            b.aborted.logical_or_(rep)
            stop = stop | rep
        b.tok.copy_(torch.where(live, nxt, b.tok))
        b.pos.add_(live.to(torch.int32))
        b.done.logical_or_(stop)
        b.step.add_(1)

    def _graphed_block(self, state: GenState, win: int, temperature: float
                       ) -> tuple[StepBuffers, int]:
        """A block's steps as replays of the graph of (the state's cache
        slot, `win`, greedy or not, `block`) on the static buffers, capturing
        it at its first use (counter `decode.graph_captures`; steps replayed
        `decode.graph_replays`). The state's random stream is copied into
        the graphs' generator and back, so a state draws the numbers it
        draws eagerly. Inside a `torch.profiler` session a key not yet
        captured runs eagerly. The host queues step i only once the card
        has finished step i - `GRAPH_LAG` (event queries, never a sync).
        -> (the static buffers, steps queued)."""
        if self._graph_rng is None:
            self._temp = torch.zeros(1, dtype=torch.float32, device=self.device)
            self._graph_rng = torch.Generator(device=self.device)
            self._lag_events = [torch.cuda.Event() for _ in range(GRAPH_LAG)]
        if self.block not in self._static:
            self._static[self.block] = StepBuffers.empty(self.block, self.device)
        b = self._static[self.block]
        greedy = temperature <= 0.0
        key = (state.cache.slot, win, greedy, self.block)
        b.load(state)
        if not greedy:
            self._temp.fill_(float(temperature))
        temp = 0.0 if greedy else self._temp
        rng = self._graph_rng
        rng.set_state(state.generator.get_state())
        graph = self.graphs.get(key)
        steps, replays = self.block, 0
        stream = torch.cuda.current_stream(self.device)
        for i in range(self.block):
            if self.early_exit and state.watch.seen():
                steps = i
                break
            lag = self._lag_events[i % GRAPH_LAG]
            if i >= GRAPH_LAG:
                while not lag.query():  # the card is GRAPH_LAG steps behind
                    time.sleep(5e-5)
            if graph is not None:
                graph.replay()
                replays += 1
            elif profiling.profiler_active():
                self._step(b, state.cache, win, temp, rng)
            else:
                graph = self.graphs[key] = self._capture(b, state.cache, win, temp)
            state.watch.record(b.done)
            lag.record(stream)
        state.generator.set_state(rng.get_state())
        profiling.count("decode.graph_replays", replays)
        return b, steps

    def _capture(self, b: StepBuffers, cache: dict, win: int, temperature) -> DecodeGraph:
        """Run one step eagerly on the capture stream (the block's step,
        which warms that stream up, as capture needs), then capture the
        same step into a graph of the shared pool; nothing of the capture
        runs. The graphs' generator is registered with it."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side, main = self._capture_stream, torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._graph_rng)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step(b, cache, win, temperature, self._graph_rng)
            with _build.capture_tally() as launches:
                # thread-local: the align worker may queue work meanwhile
                graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                try:
                    self._step(b, cache, win, temperature, self._graph_rng)
                finally:
                    graph.capture_end()
        main.wait_stream(side)
        profiling.count("decode.graph_captures")
        return DecodeGraph(graph, launches)

    @staticmethod
    def collect_block(packed: HostCopy | None) -> tuple[list[int], bool, bool]:
        """(tokens fed, finished, rep_aborted) of a dispatched block: one wait
        for its packed copy. The tokens exclude a sampled EOS; `finished` is
        set by EOS, by the repetition latch or by a full context (None). The
        MoE prefill's row counts that the block was queued behind (done once
        its copy is) go to the counters `moe.rows` and `moe.rows_hottest`,
        one count of each per MoE layer."""
        if packed is None:
            return [], True, False
        with profiling.span("decode.collect"):
            arr = packed.fetch()
            for hist in packed.moe_hists:
                for row in hist.fetch():
                    profiling.count("moe.rows", int(row.sum()))
                    profiling.count("moe.rows_hottest", int(row.max()))
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
