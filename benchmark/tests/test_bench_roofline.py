"""The roofline arithmetic against the port's kernel table."""

from __future__ import annotations

from benchmark import roofline

TEXT_17B = {"hidden_size": 2048, "intermediate_size": 6144, "num_heads": 16, "num_kv_heads": 8,
            "head_dim": 128, "num_layers": 28, "vocab_size": 151936}


def test_decode_step_matches_kernel_table():
    """One 1.7B decode step at context 1024: the least time within 5% of the
    kernel table's bounds summed (PERF.md: qkv 1.49, o 0.75, gate_up 4.47,
    down 2.24 and attention at window 1024 1.25 us per layer, the head
    55.48 us), about 0.34 ms; bound by bytes."""
    table_us = 28 * (1.49 + 0.75 + 4.47 + 2.24 + 1.25) + 55.48
    s, by = roofline.decode_step(TEXT_17B, 1024).seconds()
    assert by == "bytes"
    assert abs(s * 1e6 / table_us - 1) < 0.05


def test_pieces_add_up_and_split():
    works = [roofline.decode_step(TEXT_17B, 500), roofline.prefill(TEXT_17B, 600)]
    total, split = roofline.least_seconds(works)
    assert abs(total - sum(w.seconds()[0] for w in works)) < 1e-12
    assert split["bytes"] > 0 and split["operations"] > 0  # a 600-token prefill is compute-bound
