"""The port's tracer: named spans and counters at the boundaries of its
layers (counterpart of `qwen3_asr_gguf_tpu/utils/profiling.py`).

- `span(name, request=None, device=None)`: a context manager that adds its
  duration (a monotonic clock) to `totals[name]` and one to `counts[name]`,
  always. With `device` a CUDA device it also records a pooled CUDA event
  pair on the current stream; `Span.device_seconds()` reads the stream's
  elapsed time between them after a later host wait that the events
  precede (a block's `collect_block`), and None before the stream has
  reached the end event: it never waits. That is the time the stream took
  to pass the span's work, launches included: where the host launches
  slower than the card runs, it is the host's launch time again, not the
  kernels' busy time. On the CPU a device span is a host span.
- `count(name, n=1)`: a counter, always on.
- Records: while recording is on, every span that ends and every count is
  kept in memory as a `Span` (name, start and end, parent, request id,
  thread) until `clear()` drops it (`records()` reads without dropping).
  Recording is on while a `torch.profiler` session is active in the
  process, and inside `recording()`; a caller that records spans other
  than through `trace()` calls `clear()` once it has read them. Starts and ends are Unix-epoch nanoseconds
  (`time.time_ns`), the clock that `torch.profiler` maps its CUPTI device
  timestamps onto, so spans and kernels share one time line.
- Request ids: a thread's outermost span opens a new one and nested spans
  inherit it; work on another thread passes it as `request=`.
- `attribute_gaps(kernels, records)`: the device's idle time between
  kernels, by the innermost span open on the host meanwhile.
- `trace(logdir)`: the operator's view: a profiler session (CUDA activity on
  a card, CPU activity otherwise) with recording on, written as a Chrome
  trace with the spans as a host track, and `idle_by_span.json` beside it;
  the records it wrote are dropped.
- `device_memory_report()`: PyTorch's allocator statistics and the card's
  free and total memory.

`Tracer` holds totals and counts; the module's `TRACER` is the one the
engine, the streaming transcriber, the generator and the aligner use, and a
`ContinuousBatcher` keeps one of its own for its `stats`. Records of every
tracer go to one store.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

NO_SPAN = "(no span)"
HOST_TRACK_PID = 1 << 30  # the spans' process in `trace()`'s Chrome trace

_records: list = []  # ended spans and counts while recording was on
_recording = [0]  # depth of nested `recording()` blocks, over all threads
_recording_lock = threading.Lock()
_ids = itertools.count(1)  # span and count ids
_requests = itertools.count(1)  # request ids
_local = threading.local()  # .stack: this thread's open spans
_event_pool: dict = {}  # device index -> free timing events


def is_recording() -> bool:
    """Whether spans are recorded now: inside `recording()`, or while a
    `torch.profiler` session is active anywhere in the process (the
    profiler's process-wide flag; the autograd call answers for the
    session's own thread only)."""
    return (_recording[0] > 0 or getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counts inside the block, profiler or not."""
    with _recording_lock:
        _recording[0] += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording[0] -= 1


def records() -> list:
    """The records kept so far, in the order they ended."""
    return list(_records)


def clear() -> None:
    """Drop the records kept so far."""
    del _records[:]


def now_ns() -> int:
    """The records' clock: Unix-epoch nanoseconds."""
    return time.time_ns()


def new_request() -> int:
    """A fresh request id, for work that starts on one thread and goes on
    on another."""
    return next(_requests)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _take_events(index: int) -> list:
    pool = _event_pool.setdefault(index, [])
    events = []
    for _ in range(2):
        try:
            events.append(pool.pop())
        except IndexError:  # pool empty (another thread may have taken the last)
            events.append(torch.cuda.Event(enable_timing=True))
    return events


class Span:
    """One span (or, with `n` set, one count) and, once ended and recorded,
    its record. `seconds` is the duration on the monotonic clock; `start_ns`
    and `end_ns` are on the records' clock (set only when recorded)."""

    __slots__ = ("tracer", "name", "id", "parent", "request", "thread", "start_ns",
                 "end_ns", "seconds", "n", "recorded", "_t0", "_events", "_device_index",
                 "_device_s")

    def __init__(self, tracer, name: str, request=None, device=None):
        self.tracer, self.name, self.request = tracer, name, request
        self.id = self.parent = self.start_ns = self.end_ns = self.n = None
        self.thread = None
        self.seconds = 0.0
        self.recorded = False
        self._events = self._device_s = self._t0 = None
        self._device_index = None
        if device is not None and device is not False:
            dev = torch.device("cuda") if device is True else torch.device(device)
            if dev.type == "cuda":
                self._device_index = (dev.index if dev.index is not None
                                      else torch.cuda.current_device())

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        if self.request is None:
            self.request = parent.request if parent is not None else next(_requests)
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        stack.append(self)
        if is_recording():
            self.recorded = True
            self.thread = threading.get_ident()
            self.start_ns = time.time_ns()
        if self._device_index is not None:
            self._events = _take_events(self._device_index)
            self._events[0].record(torch.cuda.current_stream(self._device_index))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = (time.perf_counter_ns() - self._t0) / 1e9
        self._t0 = None
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device_index))
        _stack().pop()  # `with` blocks close in the order they opened
        self.tracer._add(self.name, self.seconds)
        if self.recorded:
            self.end_ns = time.time_ns()
            _records.append(self)

    def elapsed(self) -> float:
        """Seconds since the span opened (its duration once it has ended)."""
        if self._t0 is None:
            return self.seconds
        return (time.perf_counter_ns() - self._t0) / 1e9

    def device_seconds(self, default=None) -> float | None:
        """The stream's elapsed time between the span's two events (the host
        duration off the card), or `default` while the stream has not
        reached the end event: read it after a host wait that the span's
        work precedes. It never waits."""
        if self._device_s is None:
            if self._events is None:
                return self.seconds
            start, end = self._events
            if not end.query():
                return default
            self._device_s = start.elapsed_time(end) / 1e3
            _event_pool.setdefault(self._device_index, []).extend(self._events)
            self._events = None
        return self._device_s

    def __repr__(self) -> str:
        kind = f"n={self.n}" if self.n is not None else f"{self.seconds:.6f}s"
        return f"Span({self.name!r}, {kind}, id={self.id}, parent={self.parent}, request={self.request})"


class Tracer:
    """Named spans and counters: `totals` (seconds) and `counts` per span
    name, `counters` per counter name; records while recording is on."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def span(self, name: str, request=None, device=None) -> Span:
        """`with tracer.span(name) as s:`; `s.seconds` holds the duration
        once the block has ended. `device` (a torch device, or True for the
        current card) makes it a device span."""
        return Span(self, name, request, device)

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`; recorded as a count under the
        thread's innermost open span while recording is on."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if is_recording():
            rec = Span(self, name)
            stack = _stack()
            parent = stack[-1] if stack else None
            rec.id, rec.n, rec.recorded = next(_ids), n, True
            rec.parent = parent.id if parent is not None else None
            rec.request = parent.request if parent is not None else None
            rec.thread = threading.get_ident()
            rec.start_ns = rec.end_ns = time.time_ns()
            _records.append(rec)

    def add(self, name: str, start_ns: int, end_ns: int | None = None,
            request=None) -> float:
        """A span timed from `start_ns` (the records' clock, `now_ns()`) to
        `end_ns` (default now), which began where no block could hold it
        (a request's wait in a queue, across threads). Returns its seconds."""
        end_ns = time.time_ns() if end_ns is None else end_ns
        seconds = max(end_ns - start_ns, 0) / 1e9
        self._add(name, seconds)
        if is_recording():
            rec = Span(self, name, request)
            rec.id, rec.recorded, rec.seconds = next(_ids), True, seconds
            rec.thread = threading.get_ident()
            rec.start_ns, rec.end_ns = start_ns, end_ns
            _records.append(rec)
        return seconds

    def report(self) -> dict[str, float]:
        return dict(self.totals)


TRACER = Tracer()
span = TRACER.span
count = TRACER.count


def attribute_gaps(kernels: list, spans: list, top: int = 10) -> dict:
    """The device's idle time between `kernels` ([(name, start_us, end_us)],
    as `torch.profiler` reports them) by the span that was innermost on the
    host meanwhile: the latest-opened of the spans open at that instant, on
    any thread. `spans`: records (`records()`); counts are skipped. ->
    {"idle_s": {span name or "(no span)": seconds}, "longest": [[span name,
    seconds], ...] (the `top` longest gaps, each named by the span that
    holds most of it), "busy_s", "window_s"}; the window runs from the
    first kernel's start to the last one's end."""
    ks = sorted((a, b) for _, a, b in kernels if b >= a)
    gaps, busy = [], 0.0
    if ks:
        lo, end = ks[0][0], ks[0][0]
        for a, b in ks:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        window = end - lo
    else:
        window = 0.0
    # elementary intervals of the host's span nesting: between two span
    # edges the innermost open span is fixed
    recs = [r for r in spans if r.n is None and r.start_ns is not None and r.end_ns is not None]
    edges = sorted({r.start_ns / 1e3 for r in recs} | {r.end_ns / 1e3 for r in recs})
    starts = sorted(recs, key=lambda r: (r.start_ns, r.id))
    pieces, open_, si = [], [], 0
    for x0, x1 in zip(edges, edges[1:]):
        while si < len(starts) and starts[si].start_ns / 1e3 <= x0:
            open_.append(starts[si])
            si += 1
        open_ = [r for r in open_ if r.end_ns / 1e3 > x0]
        if open_:
            inner = max(open_, key=lambda r: (r.start_ns, r.id))
            pieces.append((x0, x1, inner.name))
    idle: dict[str, float] = {}
    named = []
    pi = 0
    for g0, g1 in gaps:
        while pi < len(pieces) and pieces[pi][1] <= g0:
            pi += 1
        by: dict[str, float] = {}
        covered, j = 0.0, pi
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                by[name] = by.get(name, 0.0) + d
                covered += d
            j += 1
        if not by or g1 - g0 - covered > 1e-9:
            by[NO_SPAN] = by.get(NO_SPAN, 0.0) + (g1 - g0 - covered)
        for name, d in by.items():
            idle[name] = idle.get(name, 0.0) + d / 1e6
        named.append((max(by, key=by.get), (g1 - g0) / 1e6))
    named.sort(key=lambda g: -g[1])
    return {"idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "longest": [[n, s] for n, s in named[:top]],
            "busy_s": busy / 1e6, "window_s": window / 1e6}


def _profiled_kernels(prof, device_type) -> list:
    """[(name, start_us, end_us)] of a session's events of `device_type`."""
    try:
        return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == device_type]
    except (AttributeError, TypeError):
        return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == device_type]


def _host_track(trace_path: str, spans: list) -> None:
    """Add `spans` to a Chrome trace as a process of their own, one track
    per host thread."""
    with open(trace_path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = HOST_TRACK_PID
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "port spans"}})
    tids: dict = {}
    for r in spans:
        tid = tids.setdefault(r.thread, len(tids) + 1)
        ev = {"ph": "X" if r.n is None else "i", "cat": "port", "name": r.name, "pid": pid,
              "tid": tid, "ts": (r.start_ns - base) / 1e3,
              "args": {"request": r.request, "id": r.id, "parent": r.parent}}
        if r.n is None:
            ev["dur"] = (r.end_ns - r.start_ns) / 1e3
            device_s = r.device_seconds() if r._device_index is not None else None
            if device_s is not None:
                ev["args"]["device_ms"] = device_s * 1e3
        else:
            ev["s"], ev["args"]["n"] = "t", r.n
        events.append(ev)
    for thread, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"thread {thread}"}})
    with open(trace_path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator:
    """Profile the block with the port's spans recorded; yields the
    `torch.profiler.profile`. Writes into `logdir` (made if missing) the
    Chrome trace (chrome://tracing, Perfetto) as `trace-<pid>-<ns>.json`,
    the spans added as a host track, and `idle_by_span.json`: the
    `attribute_gaps` of its kernels (the CPU's operators off the card)
    against its spans. The block's records are dropped once written.

    Usage:
        with profiling.trace("logs/trace"):
            engine.asr(...)
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    os.makedirs(logdir, exist_ok=True)
    n0 = len(_records)
    with recording():
        with profile(activities=activities) as prof:
            yield prof
    spans = _records[n0:]
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _host_track(path, spans)
    kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump(attribute_gaps(_profiled_kernels(prof, kind), spans), f, indent=1)
    del _records[n0:n0 + len(spans)]


def device_memory_report(device=None) -> dict:
    """Bytes held by PyTorch's allocator on a CUDA device (from
    `torch.cuda.memory_stats`) and the card's free and total memory (from
    `mem_get_info`); `device` defaults to the current card. {} for any other
    device, or with no card."""
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
