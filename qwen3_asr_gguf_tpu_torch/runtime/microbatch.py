"""Server-side micro-batching (counterpart of
`qwen3_asr_gguf_tpu/runtime/microbatch.py`).

Concurrent short transcription requests that arrive within `window_s` of
each other decode together in one `BatchedGenerator` batch, up to
`max_batch` wide. Prompts (context, language) may differ per row, since the
batched generator takes per-row token ids; only the sampling temperature
keys a batch. A request that finds no company runs on the engine alone.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..models.mla_config import refuse
from ..schema import TranscribeResult


@dataclass
class _Pending:
    audio: np.ndarray
    context: str
    language: Optional[str]
    temperature: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[TranscribeResult] = None
    error: Optional[Exception] = None


class MicroBatcher:
    def __init__(self, engine, *, window_s: float = 0.05, max_batch: int = 8):
        from .batched import BatchedEngine

        refuse(engine.dec_cfg, "MicroBatcher")
        self.engine = engine
        self.batched = BatchedEngine(engine)
        self.batched.gen.rows(max_batch)  # a width the kernels cannot take is refused here
        self.window_s = window_s
        self.max_batch = max_batch
        self.chunk_samples = self.batched.chunk_samples
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.n_batches = 0
        self.n_batched_requests = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5.0)

    def eligible(self, audio: np.ndarray) -> bool:
        return len(audio) <= self.chunk_samples

    def submit(
        self,
        audio: np.ndarray,
        *,
        context: str = "",
        language: Optional[str] = None,
        temperature: float = 0.0,
        timeout: float = 600.0,
    ) -> TranscribeResult:
        item = _Pending(audio=audio, context=context, language=language,
                        temperature=temperature)
        with self._lock:
            self._queue.append(item)
        self._wake.set()
        if not item.done.wait(timeout):
            raise TimeoutError("transcription timed out in batch queue")
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    # -- worker --------------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        with self._lock:
            if not self._queue:
                return []
            key = self._queue[0].temperature
            batch = [p for p in self._queue if p.temperature == key][: self.max_batch]
            for p in batch:
                self._queue.remove(p)
            if not self._queue:
                self._wake.clear()
        return batch

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=0.5)
            if self._stop:
                return
            if not self._queue:
                # a submit() racing with _take_batch can leave _wake set with
                # an empty queue; clear it under the lock (re-checking the
                # queue) so this loop blocks instead of spinning
                with self._lock:
                    if not self._queue:
                        self._wake.clear()
                continue
            time.sleep(self.window_s)  # let the batch fill
            batch = self._take_batch()
            if not batch:
                continue
            try:
                if len(batch) == 1:
                    p = batch[0]
                    p.result = self.engine.asr(
                        p.audio, context=p.context, language=p.language,
                        chunk_size_sec=self.engine.config.chunk_size,
                        memory_chunks=self.engine.config.memory_num,
                        temperature=p.temperature,
                    )
                else:
                    results = self._run_batch(batch)
                    for p, r in zip(batch, results):
                        p.result = r
                    self.n_batches += 1
                    self.n_batched_requests += len(batch)
            except Exception as e:  # surfaced to the callers
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.done.set()

    def _run_batch(self, batch: List[_Pending]) -> List[TranscribeResult]:
        eng = self.engine
        rows = self.batched.gen.generate(
            *self.batched.prompts([(p.audio, p.context, p.language) for p in batch]),
            temperature=batch[0].temperature,
            max_new_tokens=eng.config.max_new_tokens,
        )
        return [
            TranscribeResult(
                text=eng.model.decode(toks),
                performance={"batched": True, "n_generate": len(toks)},
            )
            for toks in rows
        ]
