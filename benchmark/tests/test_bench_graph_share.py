"""The reader of `graph_step_share.*` (`benchmark/metrics/graph_step_share.py`)
on records filled by hand: the replayed steps over the steps queued, and
None where the port counts no replays (a port without CUDA graphs) or has
no tracer."""

from __future__ import annotations

import json

import pytest

from benchmark import harness

from .conftest import BENCH

profiling = pytest.importorskip("qwen3_asr_gguf_tpu_torch.utils.profiling")

METRICS = ("graph_step_share.file", "graph_step_share.stream")


def _count(name: str, n: int, rid: int):
    r = profiling.Span(profiling.Tracer(), name, 1)
    r.id, r.parent, r.recorded, r.n = rid, None, True, n
    r.start_ns = r.end_ns = 0
    return r


def _read(metric: str):
    return harness.Cell(BENCH, "file-1.7b").reader(metric)({})


@pytest.mark.parametrize("metric", METRICS)
def test_replayed_steps_over_steps(metric, monkeypatch):
    recs = [_count("decode.steps", 96, 1), _count("decode.graph_replays", 96, 2),
            _count("decode.steps", 16, 3), _count("decode.graph_replays", 15, 4)]
    monkeypatch.setattr(profiling, "_records", recs)
    assert _read(metric) == pytest.approx(111 / 112)


@pytest.mark.parametrize("metric", METRICS)
def test_none_without_replay_counts(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_records", [_count("decode.steps", 96, 1)])
    assert _read(metric) is None
    monkeypatch.setattr(profiling, "_records", [])
    assert _read(metric) is None
    monkeypatch.delattr(profiling, "records")
    assert _read(metric) is None


def test_zero_when_no_step_was_replayed(monkeypatch):
    monkeypatch.setattr(profiling, "_records", [_count("decode.steps", 16, 1),
                                                _count("decode.graph_replays", 0, 2)])
    assert _read("graph_step_share.stream") == 0.0


def test_the_metrics_are_in_the_contract():
    contract = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in contract["per_layer"]}
    for name, cell, moves in (("graph_step_share.file", "file-1.7b", "rtf"),
                              ("graph_step_share.stream", "stream-0.6b-live",
                               "stream_chunk_latency_p90_s")):
        m = per_layer[name]
        assert m["source"] == "program_counter" and m["better"] == "higher"
        assert m["layer"] == "decode block and model step" and m["moves"] == moves
        assert m["workloads"] == [cell]
