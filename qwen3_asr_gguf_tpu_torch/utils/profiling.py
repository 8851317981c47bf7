"""Tracing, spans and memory observability (counterpart of
`qwen3_asr_gguf_tpu/utils/profiling.py`).

- `trace()`: a torch.profiler session (CUDA activities when a card is
  present) written as a Chrome trace (chrome://tracing, Perfetto) into a
  directory;
- `Stopwatch`: accumulating named host spans, for the engine's stats dict;
- `device_memory_report()`: PyTorch's allocator statistics and the card's
  free and total memory;
- `live_tensor_report()`: the largest live tensors on a device type.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(logdir: str) -> Iterator:
    """Profile the block and write its Chrome trace into `logdir` (made if
    missing) as `trace-<pid>-<ns>.json`; yields the `torch.profiler.profile`.

    Usage:
        with profiling.trace("logs/trace"):
            engine.asr(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class Stopwatch:
    """Accumulating named spans -> engine stats dict."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self.totals)


def device_memory_report(device=None) -> dict:
    """Bytes held by PyTorch's allocator on a CUDA device (from
    `torch.cuda.memory_stats`) and the card's free and total memory (from
    `mem_get_info`); `device` defaults to the current card. {} for any other
    device, or with no card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {"memory_allocated": int(stats.get("allocated_bytes.all.current", 0)),
            "memory_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "max_memory_allocated": int(stats.get("allocated_bytes.all.peak", 0)),
            "mem_free": int(free), "mem_total": int(total)}


def live_tensor_report(top: int = 10, device_type: str = "cuda") -> list[dict]:
    """The `top` largest live tensors on `device_type` (by the garbage
    collector's objects, views counted apart): [{shape, dtype, nbytes}]."""
    import torch

    # type(), not isinstance: the latter reads `__class__`, which some
    # deprecation proxies among the objects answer with a warning
    tensors = [obj for obj in gc.get_objects()
               if issubclass(type(obj), torch.Tensor) and obj.device.type == device_type]
    rows = sorted(tensors, key=lambda t: -t.numel() * t.element_size())[:top]
    return [{"shape": tuple(t.shape), "dtype": str(t.dtype).removeprefix("torch."),
             "nbytes": t.numel() * t.element_size()} for t in rows]
