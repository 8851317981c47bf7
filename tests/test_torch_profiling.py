"""`qwen3_asr_gguf_tpu_torch.utils.profiling` on the CPU: `Stopwatch`
against the JAX package's class on the same spans under one fake clock,
the memory report empty off the card, a Chrome trace written by `trace`,
and the live-tensor report's order."""

import json
import time

import torch

from qwen3_asr_gguf_tpu.utils import profiling as jprof
from qwen3_asr_gguf_tpu_torch.utils import profiling as tprof


def _spans(watch_cls, monkeypatch):
    """A Stopwatch of `watch_cls` through three spans (one raising) on a
    clock that advances 0.25 s, 0.5 s and 1.0 s across them."""
    ticks = iter([10.0, 10.25, 20.0, 20.5, 30.0, 31.0])
    monkeypatch.setattr(time, "time", lambda: next(ticks))
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
    got, want = _spans(tprof.Stopwatch, monkeypatch), _spans(jprof.Stopwatch, monkeypatch)
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


def test_live_tensor_report_lists_the_largest_first():
    big, small = torch.zeros(1024, 1024), torch.zeros(3, 5, dtype=torch.int8)
    rows = tprof.live_tensor_report(top=1000, device_type="cpu")
    assert rows[0]["nbytes"] >= big.numel() * 4
    assert {"shape": (1024, 1024), "dtype": "float32", "nbytes": 4 * 1024 * 1024} in rows
    assert {"shape": (3, 5), "dtype": "int8", "nbytes": 15} in rows
    assert [r["nbytes"] for r in rows] == sorted((r["nbytes"] for r in rows), reverse=True)
    assert tprof.live_tensor_report(top=2, device_type="cpu")[:1] == rows[:1]
    if not torch.cuda.is_available():
        assert tprof.live_tensor_report() == []
    del big, small
