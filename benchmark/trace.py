"""The traced run's device window: one torch.profiler session (CUDA
activity only) over whole units of the measured window's work, so that the
work the session holds is known: one `asr` call of the file cell, two feeds
of the stream cell (the cell's file says which).

Lessons of the port's profiling kept here:
- a process's first profiler session may record nothing while CUPTI comes
  up: `throwaway` opens and closes one during set-up;
- later sessions in a process lose markers after one past ~126,000 device
  events: a run opens one session after the throwaway and no other. A whole
  `asr` call of the 1.7B holds ~393,000 device events, which one session
  records whole;
- a marker kernel (`torch.cuda._sleep`) is queued at both ends and bounds
  the window; a session that shows kernels but not both markers (the first
  is often missed) is bounded by its first and last kernel instead, which
  the synchronization at both ends of a unit makes the same, and one that
  shows no kernel reports no device metric.

From the kernels between the markers: busy seconds (the union of their
intervals), the window's length, the top device operations by time and
the longest idle gaps, each named by the kernels on either side of it.
"""

from __future__ import annotations

MARKER = "spin_kernel"


def throwaway(torch) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _union(spans: list) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def analyse(kernels: list) -> dict | None:
    """kernels: [(name, start_us, end_us)] of one session, markers included.
    The window runs from the first marker's end to the last one's start;
    without both markers, from the first kernel's start to the last one's
    end (`markers` says which)."""
    marks = sorted(k[1:] for k in kernels if MARKER in k[0])
    others = [k for k in kernels if MARKER not in k[0]]
    if len(marks) >= 2:
        lo, hi = marks[0][1], marks[-1][0]
    elif others:
        lo, hi = min(k[1] for k in others), max(k[2] for k in others)
    else:
        return None
    inside = sorted((max(a, lo), min(b, hi), n) for n, a, b in kernels
                    if MARKER not in n and b > lo and a < hi)
    if not inside or hi <= lo:
        return None
    by_name: dict = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps, end, prev = [], lo, "window start"
    for a, b, n in inside:
        if a > end:
            gaps.append((f"{prev[:60]} -> {n[:60]}", (a - end) / 1e6))
        if b > end:
            end, prev = b, n
    if hi > end:
        gaps.append((f"{prev[:60]} -> window end", (hi - end) / 1e6))
    return {
        "busy_s": _union([(a, b) for a, b, _ in inside]) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "events": len(inside),
        "markers": len(marks),
        "breakdown": {
            "device_ops": [[n[:120], s] for n, s in sorted(by_name.items(),
                                                            key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps, key=lambda g: -g[1])[:10]],
        },
    }


class UnitTrace:
    """One profiler session over whole units of the window's work (an
    `asr` call, a feed): from the start of unit `first` (units counted from
    0 in the window) to the end of unit `first + count - 1`. The driver
    calls `before(i)` and `after(i)` around unit i; it synchronizes after
    each unit, so the card is idle at both ends and the session holds the
    units' device work and nothing else. Read at `close()`, once the
    measured window is over, so that parsing the trace takes no host time
    inside it. `units` is the range traced, once it has been."""

    def __init__(self, torch, first: int, count: int):
        self.torch, self.first, self.last = torch, first, first + count - 1
        self.result: dict | None = None
        self.error: BaseException | None = None
        self.units: range | None = None
        self.n_events = 0
        self._prof = None

    def before(self, i: int) -> None:
        if i != self.first or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        try:
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self.torch.cuda._sleep(1000)
        except BaseException as e:  # reported by the harness; the run goes on
            self.error, self._prof = e, None

    def after(self, i: int) -> None:
        if i != self.last or self._prof is None or self.units is not None:
            return
        try:
            self.torch.cuda._sleep(1000)
            self.torch.cuda.synchronize()
            self._prof.stop()
            self.units = range(self.first, self.last + 1)
        except BaseException as e:
            self.error = e

    def close(self) -> None:
        if self._prof is None or self.units is None or self.error is not None:
            return
        kernels = _device_kernels(self.torch, self._prof)
        self.n_events = len(kernels)
        self.result = analyse(kernels)
        self._prof = None


def _device_kernels(torch, prof) -> list:
    """[(name, start_us, end_us)] of the session's device activity: from
    the profiler's raw events where this PyTorch exposes them (a whole call
    holds ~400,000), else from its parsed events."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    except (AttributeError, TypeError):
        return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == cuda]
