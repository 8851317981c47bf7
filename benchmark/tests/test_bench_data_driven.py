"""A later change adds a cell, a configuration and a per-layer metric as
files, editing none that is there, and the harness finds each by name."""

from __future__ import annotations

import hashlib

from .conftest import STREAM_PARAMS, TINY_TEXT, config


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_config_and_metric_from_files_only(tiny):
    before = _digests(tiny.bench)
    tiny.add_config(config("tiny-wide", dict(TINY_TEXT, intermediate_size=192)))
    (tiny.bench / "metrics" / "feeds_per_s.py").write_text(
        "def read(ctx):\n"
        "    s = ctx['summary']\n"
        "    return len(s['feed_latencies']) / s['window_s'] if s.get('feed_latencies') else None\n")
    tiny.add_cell("stream-wide", "tiny-wide", "live_stream",
                  dict(STREAM_PARAMS, session_s=6.0), "stream_chunk_latency_p90_s",
                  ["feeds_per_s", "feed_median_s.stream", "mfu.added"])
    after = _digests(tiny.bench)
    assert all(after[p] == d for p, d in before.items())  # nothing there was edited
    out = tiny.run("stream-wide", trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"feeds_per_s", "feed_median_s.stream", "mfu.added"}
    assert out["metrics"]["feeds_per_s"]["value"] > 0
