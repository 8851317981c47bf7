"""The readers of the port's spans and counters (`benchmark/spans.py` and
the metrics that use it): each reads its value from records and totals
filled by hand, and gives None where there are none, as on a port without
the tracer."""

from __future__ import annotations

import pytest

from benchmark import harness

from .conftest import BENCH

profiling = pytest.importorskip("qwen3_asr_gguf_tpu_torch.utils.profiling")

NEW = ("dispatch_ms_per_step.file", "dispatch_ms_per_step.stream", "encode_ms.file",
       "encode_ms.stream", "prefill_ms.stream", "feed_host_ms.stream", "init_s.file",
       "init_s.stream", "prewarm_s.stream")


def _reader(metric: str):
    return harness.Cell(BENCH, "stream-0.6b-live").reader(metric)


def _rec(name, rid, seconds=0.0, parent=None, request=1, n=None):
    r = profiling.Span(profiling.Tracer(), name, request)
    r.id, r.parent, r.recorded, r.seconds, r.n = rid, parent, True, seconds, n
    r.start_ns = r.end_ns = 0
    return r


def _feed(first: int, request: int, feed_s: float, enc_s: float, prefill_s: float,
          dispatch_s: float, collect_s: float, steps: int) -> list:
    """One feed's records as the port leaves them (ids from `first`)."""
    f, e, p, g, d, c = range(first, first + 6)
    return [
        _rec("stream.prefix", first + 10, 0.001, f, request),
        _rec("engine.encode", e, enc_s, f, request),
        _rec("engine.prompt", first + 11, 0.002, f, request),
        _rec("decode.prefill", p, prefill_s, f, request),
        _rec("decode.steps", first + 12, parent=d, request=request, n=steps),
        _rec("decode.dispatch", d, dispatch_s, g, request),
        _rec("decode.collect", c, collect_s, g, request),
        _rec("engine.generate", g, dispatch_s + collect_s + 0.003, f, request),
        _rec("stream.parse", first + 13, 0.0005, f, request),
        _rec("stream.feed", f, feed_s, None, request),
    ]


@pytest.fixture
def filled(monkeypatch):
    """Two traced feeds, and the always-on totals of one process."""
    recs = (_feed(100, 7, 0.2, 0.010, 0.004, 0.048, 0.030, 16)
            + _feed(200, 8, 0.2, 0.012, 0.006, 0.032, 0.040, 16))
    monkeypatch.setattr(profiling, "_records", recs)
    monkeypatch.setattr(profiling.TRACER, "totals",
                        {"engine.init": 12.5, "stream.prewarm": 3.25, "engine.asr": 9.0})
    return recs


def test_each_reader_reads_the_records(filled):
    got = {m: _reader(m)({}) for m in NEW}
    assert got["dispatch_ms_per_step.stream"] == pytest.approx(1e3 * 0.080 / 32)
    assert got["dispatch_ms_per_step.file"] == got["dispatch_ms_per_step.stream"]
    assert got["encode_ms.stream"] == pytest.approx(11.0)
    assert got["prefill_ms.stream"] == pytest.approx(5.0)
    # the feed less its encode, prefill, dispatch and collect
    assert got["feed_host_ms.stream"] == pytest.approx(
        1e3 * ((0.2 - 0.010 - 0.004 - 0.048 - 0.030) + (0.2 - 0.012 - 0.006 - 0.032 - 0.040)) / 2)
    assert got["init_s.file"] == got["init_s.stream"] == 12.5
    assert got["prewarm_s.stream"] == 3.25


def test_a_prefill_counts_for_its_own_feed_only(filled, monkeypatch):
    recs = filled + [_rec("decode.prefill", 999, 0.100, None, request=99)]
    monkeypatch.setattr(profiling, "_records", recs)
    assert _reader("prefill_ms.stream")({}) == pytest.approx(5.0)


class _Unreached:
    """A CUDA event the stream has not passed yet; waiting on it fails."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("a reader waited for the card")


def test_a_device_span_the_stream_has_not_finished_is_left_out(filled, monkeypatch):
    late = [_rec("engine.encode", 998, 0.500, 100, request=7),
            _rec("decode.prefill", 999, 0.500, 100, request=7)]
    for r in late:
        r._events, r._device_index = [_Unreached(), _Unreached()], 0
    monkeypatch.setattr(profiling, "_records", filled + late)
    assert _reader("encode_ms.stream")({}) == pytest.approx(11.0)
    assert _reader("prefill_ms.stream")({}) == pytest.approx(5.0)


def test_every_reader_gives_none_without_records(monkeypatch):
    monkeypatch.setattr(profiling, "_records", [])
    monkeypatch.setattr(profiling.TRACER, "totals", {})
    assert {m: _reader(m)({}) for m in NEW} == dict.fromkeys(NEW)


def test_every_reader_gives_none_on_a_port_without_the_tracer(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    assert {m: _reader(m)({}) for m in NEW} == dict.fromkeys(NEW)


def test_the_new_metrics_are_in_the_contract():
    import json

    contract = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in contract["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["workloads"] == ["file-1.7b" if name.endswith(".file") else "stream-0.6b-live"]
