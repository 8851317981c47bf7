"""Batched multi-request decoding (counterpart of
`qwen3_asr_gguf_tpu/runtime/batched.py`).

Short utterances (one chunk or less) decode together. The batch prefills
into the rows of one KV cache of `round_up(n_ctx, 256)` slots in one lanes
pass of the decoder (`generate.prefill_cohort`: every prompt padded to the
bucket of the longest, each row's padding keys masked) with one LM-head
call for the first tokens, as the JAX package's `prefill_batch` does; then
blocks of `forward_step_rows` run every row at its own position, with
per-row sampling, the EOS latches kept on the device and one device-to-host
fetch per block. Longer inputs go through the engine's chunk pipeline.

The JAX package pads every batch to a fixed width so that XLA compiles its
programs once; eager PyTorch compiles nothing, so that is not needed. A
batch is as wide as its requests, rounded or refused by the weights' kernel
rows (`continuous.batch_rows`), so that no product of a batched step
dequantizes its weight per call on the card.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import decoder as dec
from ..models.mla_config import refuse
from ..ops.sampling import sample_rows
from ..schema import TranscribeResult
from .continuous import batch_rows
from .generate import prefill_cohort, prompt_bucket, round_up

SAMPLE_RATE = 16_000


class BatchedGenerator:
    """Batched prefill and block decode over one row cache."""

    def __init__(self, params, cfg, *, n_ctx: int, eos_ids, block: int = 32,
                 cache_dtype=torch.bfloat16, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.n_ctx = n_ctx
        self.block = block
        self.cache_dtype = cache_dtype
        self.device = torch.device(device)
        self.eos_dev = torch.tensor(sorted(int(e) for e in eos_ids), dtype=torch.int64,
                                    device=self.device)

    def rows(self, b: int) -> int:
        """Rows of a batched step that serves `b` prompts (`batch_rows`:
        rounded up to the kernels' row tiles on the card, or refused)."""
        return batch_rows(b, [*self.params["layers"][0].values(), self.params["lm_head"]],
                          self.device.type == "cuda")

    def prefill(self, ids_list: Sequence[np.ndarray], masks_list: Sequence[np.ndarray],
                audio_embds: Sequence[torch.Tensor], rows: int) -> tuple[dict, torch.Tensor]:
        """(a row cache of `rows` rows and `round_up(n_ctx, 256)` slots, with
        the b prompts prefilled into its first b rows by `prefill_cohort` at
        `min(prompt_bucket(longest), n_ctx)` slots, their first-token logits
        [b, V])."""
        lengths = [len(i) for i in ids_list]
        if max(lengths) > self.n_ctx:
            raise ValueError(f"prompt of {max(lengths)} tokens exceeds n_ctx={self.n_ctx}")
        s_cache = round_up(self.n_ctx, 256)  # whole 256-slot windows at any n_ctx
        caches = dec.init_cache(self.cfg, s_cache, self.cache_dtype, device=self.device,
                                rows=rows)
        lanes = {name: [c[: len(lengths)] for c in cs] for name, cs in caches.items()}
        logits = prefill_cohort(self.params, self.cfg,
                                list(zip(ids_list, masks_list, audio_embds)), lanes,
                                min(prompt_bucket(max(lengths)), self.n_ctx))
        return caches, logits

    def generate(
        self,
        ids_list: Sequence[np.ndarray],
        masks_list: Sequence[np.ndarray],
        audio_embds: Sequence[torch.Tensor],  # [Ta_i, D] on the device
        *,
        temperature: float = 0.4,
        max_new_tokens: int = 512,
        seed: Optional[int] = None,
    ) -> List[List[int]]:
        """Decode a batch of spliced prompts; returns the emitted tokens per
        row (EOS excluded)."""
        b = len(ids_list)
        rows = self.rows(b)
        lengths = [len(i) for i in ids_list]
        params, cfg, dev = self.params, self.cfg, self.device
        caches, logits = self.prefill(ids_list, masks_list, audio_embds, rows)
        s_cache = caches["k"][0].shape[1]

        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rng = torch.Generator(device=dev)
        rng.manual_seed(seed)
        temps = torch.full((rows,), max(temperature, 1e-6), device=dev)
        greedy = torch.full((rows,), temperature <= 0.0, device=dev)
        first, first_done, _ = sample_rows(
            logits, rng, temps[:b], greedy[:b],
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.int64, device=dev), self.eos_dev)
        # rows past b (a rounded-up width) idle at slot 0, latched done
        toks = torch.zeros(rows, dtype=torch.int64, device=dev)
        dones = torch.ones(rows, dtype=torch.bool, device=dev)
        toks[:b], dones[:b] = first, first_done
        poss = torch.tensor(lengths + [0] * (rows - b), device=dev)

        out: List[List[int]] = [[] for _ in range(b)]
        steps = 0
        while steps < max_new_tokens:
            deepest = max(lengths) + steps
            if deepest + self.block > self.n_ctx:
                break
            win = min(s_cache, round_up(deepest + self.block, 256))
            emitted = []
            for _ in range(self.block):
                hidden, _ = dec.forward_step_rows(
                    params["layers"], params["final_norm"], cfg, dec.embed_tokens(params, toks),
                    caches, poss, attn_window=win)
                logits = dec.lm_logits(params, hidden, cfg.lm_head_dim)
                toks, dones, em = sample_rows(logits, rng, temps, greedy, dones, toks,
                                              self.eos_dev)
                emitted.append(em)
                poss = poss + 1
            packed = torch.cat([torch.stack(emitted, dim=1), dones[:, None].to(torch.int64)],
                               dim=1).cpu().numpy()  # one fetch per block
            for r in range(b):
                out[r].extend(int(t) for t in packed[r, :-1] if t >= 0)
            steps += self.block
            if packed[:b, -1].all():
                break
        return [row[:max_new_tokens] for row in out]


class BatchedEngine:
    """Offline batch transcription over a shared engine's weights.

    Single-chunk utterances (<= the engine's chunk_size) decode as one batch
    on the engine's prefill-side weights (dense bf16 for an int4 engine,
    `Int8Weight` for int8, `Q4Weight` for q4_k: the int4 matvec kernels take
    one row); longer inputs go through `engine.asr`.
    """

    def __init__(self, engine, *, block: int = 32):
        refuse(engine.dec_cfg, "BatchedEngine")
        self.engine = engine
        gen = engine.generator
        self.chunk_samples = int(engine.config.chunk_size * SAMPLE_RATE)
        self.gen = BatchedGenerator(
            gen.prefill_params, engine.dec_cfg,
            n_ctx=engine.config.n_ctx,
            eos_ids=engine.thinker.eos_token_ids,
            block=block,
            cache_dtype=gen.cache_dtype,
            device=engine.device,
        )

    def prompts(self, requests: Sequence[tuple]) -> tuple[list, list, list]:
        """(audio, context, language) per row -> (ids, masks, embeddings):
        each audio zero-padded to the full chunk and encoded as the engine
        encodes a chunk; the prompt holds its valid frames only."""
        eng = self.engine
        chunk = self.chunk_samples
        a_full = eng.encoder.valid_tokens(chunk)
        ids_list, mask_list, embds = [], [], []
        for audio, context, language in requests:
            n_valid = eng.encoder.valid_tokens(len(audio))
            if len(audio) < chunk:
                audio = np.pad(audio, (0, chunk - len(audio)))
            embds.append(eng.encoder.encode(audio)[:a_full])
            ids, mask = eng._build_prompt_ids(n_valid, "", context, language)
            ids_list.append(ids)
            mask_list.append(mask)
        return ids_list, mask_list, embds

    def transcribe_batch(
        self,
        audios: Sequence[np.ndarray],
        *,
        context: str = "",
        language: Optional[str] = None,
        temperature: float = 0.0,
        max_new_tokens: Optional[int] = None,
    ) -> List[TranscribeResult]:
        eng = self.engine
        max_new = max_new_tokens or eng.config.max_new_tokens
        t0 = time.time()
        short_idx = [i for i, a in enumerate(audios) if len(a) <= self.chunk_samples]
        long_idx = [i for i in range(len(audios)) if i not in short_idx]
        results: List[Optional[TranscribeResult]] = [None] * len(audios)

        if short_idx:
            token_rows = self.gen.generate(
                *self.prompts([(audios[i], context, language) for i in short_idx]),
                temperature=temperature, max_new_tokens=max_new,
            )
            for i, toks in zip(short_idx, token_rows):
                results[i] = TranscribeResult(text=eng.model.decode(toks), performance={
                    "batched": True, "n_generate": len(toks),
                })

        for i in long_idx:
            results[i] = eng.asr(
                audios[i], context=context, language=language,
                chunk_size_sec=eng.config.chunk_size,
                memory_chunks=eng.config.memory_num,
                temperature=temperature,
            )

        wall = time.time() - t0
        total_audio = sum(len(a) for a in audios) / SAMPLE_RATE
        for r in results:
            if r and r.performance is not None:
                r.performance.setdefault("batch_wall_s", round(wall, 3))
                r.performance.setdefault("batch_audio_s", round(total_audio, 2))
        return results  # type: ignore[return-value]
