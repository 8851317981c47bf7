"""`qwen3_asr_gguf_tpu_torch.utils.profiling` on the CPU: the tracer's
span totals and counts against the JAX package's `Stopwatch` on the same
spans under one fake clock each, the memory report empty off the card, and a
Chrome trace written by `trace`."""

import json
import time

import torch

from qwen3_asr_gguf_tpu.utils import profiling as jprof
from qwen3_asr_gguf_tpu_torch.utils import profiling as tprof


def _spans(watch_cls, monkeypatch, clock="time", per_second=1.0):
    """A `watch_cls` through three spans (one raising) on a clock that
    advances 0.25 s, 0.5 s and 1.0 s across them: `time.time` for the JAX
    class, the tracer's monotonic `time.perf_counter_ns` for the port's."""
    ticks = iter([10.0, 10.25, 20.0, 20.5, 30.0, 31.0])
    monkeypatch.setattr(time, clock, lambda: type(per_second)(next(ticks) * per_second))
    watch = watch_cls()
    with watch.span("encode"):
        pass
    with watch.span("decode"):
        pass
    try:
        with watch.span("encode"):
            raise RuntimeError("the span still counts")
    except RuntimeError:
        pass
    monkeypatch.undo()
    return watch


def test_stopwatch_equals_the_jax_stopwatch(monkeypatch):
    got = _spans(tprof.Tracer, monkeypatch, "perf_counter_ns", 10**9)
    want = _spans(jprof.Stopwatch, monkeypatch)
    assert got.report() == want.report() == {"encode": 1.25, "decode": 0.5}
    assert got.counts == want.counts == {"encode": 2, "decode": 1}


def test_memory_report_is_empty_off_the_card():
    assert tprof.device_memory_report("cpu") == {}
    assert tprof.device_memory_report(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert tprof.device_memory_report() == {}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.trace(str(logdir)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    files = list(logdir.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") in ("aten::matmul", "aten::mm") for e in events)
