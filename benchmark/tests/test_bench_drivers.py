"""Each traffic driver end to end at a tiny size on the CPU, through the
harness: set-up, warm-up, window, the reference check, every metric."""

from __future__ import annotations

import pytest

from .conftest import FILE_PARAMS, STREAM_PARAMS, config

FILE_METRICS = ["nondecode_share.file", "decode_ms_per_token.file", "mfu.file"]
STREAM_METRICS = ["feed_median_s.stream", "decode_ms_per_token.stream", "mfu.stream"]
CASES = {
    "file": ("engine_file", FILE_PARAMS, "rtf", FILE_METRICS),
    "stream": ("live_stream", STREAM_PARAMS, "stream_chunk_latency_p90_s", STREAM_METRICS),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_driver_end_to_end(tiny, kind):
    driver, params, e2e, per_layer = CASES[kind]
    tiny.add_config(config("tiny-f32"))
    tiny.add_cell(f"{kind}-tiny", "tiny-f32", driver, params, e2e, per_layer)
    plain = tiny.run(f"{kind}-tiny", trace=False)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in plain["metrics"].values())
    assert plain["attempted"] > 0 and plain["failed"] == 0
    assert plain["checks"]["judged"]["value"] >= 4
    traced = tiny.run(f"{kind}-tiny", trace=True, seed=2**31 + 6)
    assert traced["correct"], traced["checks"]
    # the device metrics need the card; every other reader reads on the CPU
    assert set(traced["metrics"]) == set(per_layer)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_same_seed_same_inputs(tiny, kind):
    """The seed fixes the traffic: two drivers on one seed draw equal audio."""
    import numpy as np

    from benchmark import signals

    a, b = signals.speech(2**31 + 9, 3, 4.0), signals.speech(2**31 + 9, 3, 4.0)
    c = signals.speech(2**31 + 10, 3, 4.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c) and a.shape == c.shape
