"""The reader of `encode_graph_share.*` (`benchmark/metrics/encode_graph_share.py`)
on records filled by hand: the replayed encodes over the encodes, and None
where the port counts no encodes (a port without the counters) or has no
tracer."""

from __future__ import annotations

import json

import pytest

from benchmark import harness

from .conftest import BENCH

profiling = pytest.importorskip("qwen3_asr_gguf_tpu_torch.utils.profiling")

CELLS = {"encode_graph_share.file": ("file-1.7b", "rtf"),
         "encode_graph_share.stream": ("stream-0.6b-live", "stream_chunk_latency_p90_s"),
         "encode_graph_share.aligned": ("file-1.7b-aligned", "rtf"),
         "encode_graph_share.moe": ("file-moonlight-a3b", "rtf")}


def _count(name: str, n: int, rid: int):
    r = profiling.Span(profiling.Tracer(), name, 1)
    r.id, r.parent, r.recorded, r.n = rid, None, True, n
    r.start_ns = r.end_ns = 0
    return r


def _read(metric: str):
    return harness.Cell(BENCH, CELLS[metric][0]).reader(metric)({})


@pytest.mark.parametrize("metric", list(CELLS))
def test_one_when_every_encode_replayed(metric, monkeypatch):
    recs = [_count("encode.calls", 1, 1), _count("encode.graph_replays", 1, 2),
            _count("encode.calls", 1, 3), _count("encode.graph_replays", 1, 4),
            _count("decode.steps", 96, 5)]
    monkeypatch.setattr(profiling, "_records", recs)
    assert _read(metric) == 1.0


@pytest.mark.parametrize("metric", list(CELLS))
def test_a_fraction_when_one_ran_eagerly(metric, monkeypatch):
    recs = [_count("encode.calls", 1, i) for i in range(1, 5)]
    recs += [_count("encode.graph_replays", 1, i) for i in range(5, 8)]
    monkeypatch.setattr(profiling, "_records", recs)
    assert _read(metric) == pytest.approx(3 / 4)
    monkeypatch.setattr(profiling, "_records", recs[:4])
    assert _read(metric) == 0.0


@pytest.mark.parametrize("metric", list(CELLS))
def test_none_without_the_counters(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_records", [_count("decode.steps", 96, 1),
                                                _count("decode.graph_replays", 96, 2)])
    assert _read(metric) is None
    monkeypatch.setattr(profiling, "_records", [])
    assert _read(metric) is None
    monkeypatch.delattr(profiling, "records")
    assert _read(metric) is None


def test_the_metrics_are_in_the_contract():
    contract = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in contract["per_layer"]}
    for name, (cell, moves) in CELLS.items():
        m = per_layer[name]
        assert m["source"] == "program_counter" and m["better"] == "higher"
        assert m["layer"] == "audio encoder" and m["moves"] == moves
        assert m["unit"] == "fraction" and m["workloads"] == [cell]
