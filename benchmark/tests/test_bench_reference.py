"""The reference against the port at small sizes on the CPU: at f32 the
tokens the port's logits put first are the reference's and its served
tokens lie in the reference's top 100; on the int4 engine (q4_k decoder,
int4 encoder, the re-fitted head) the gap stays small; the faults a
single-stream cell can have (a token altered where it is produced, a step
that leaves its state unchanged) make `correct` false; and each control
reads a wider gap than the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from .conftest import FILE_PARAMS, INT4_TEXT, STREAM_PARAMS, config

DRIVERS = [("engine_file", FILE_PARAMS), ("live_stream", STREAM_PARAMS)]
# more positions to judge: a tiny random model's first tokens are seldom near-ties
LONG_FILE = dict(FILE_PARAMS, max_new_tokens=32, decode_block=32)
LONG_STREAM = dict(STREAM_PARAMS, max_new_tokens=24, decode_block=24)


def test_int4_engine_agrees_with_reference(tiny):
    """At these widths one int8 activation scale spans few values, so the
    port's greedy token parts from the reference's at near-ties of up to
    ~0.12 logits (0 on most samples)."""
    tiny.add_config(config("tiny-int4", INT4_TEXT, precision="int4"))
    tiny.add_cell("file-int4", "tiny-int4", "engine_file", FILE_PARAMS, "rtf", [], gap=0.5)
    out = tiny.run("file-int4", trace=False)
    assert out["correct"], out["checks"]


def _fails(tiny, driver, params) -> dict:
    tiny.add_config(config("tiny-f32"))
    tiny.add_cell("faulty", "tiny-f32", driver, params, "rtf", [])
    out = tiny.run("faulty", trace=False)
    assert not out["correct"]
    return out


@pytest.mark.parametrize("driver,params", DRIVERS)
def test_altered_token_fails(tiny, monkeypatch, driver, params):
    """A fault where tokens are produced: every third sampled token is the
    logits' argmin."""
    from qwen3_asr_gguf_tpu_torch.runtime import generate

    calls = {"n": 0}
    sample = generate.sample

    def altered(logits, gen, temperature, *a, **k):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            return torch.argmin(logits, dim=-1)
        return sample(logits, gen, temperature, *a, **k)

    monkeypatch.setattr(generate, "sample", altered)
    out = _fails(tiny, driver, params)
    assert out["checks"]["gap_widest"]["value"] > out["checks"]["gap_widest"]["limit"]


@pytest.mark.parametrize("driver,params", [("engine_file", LONG_FILE),
                                           ("live_stream", LONG_STREAM)])
def test_step_leaving_its_state_unchanged_fails(tiny, monkeypatch, driver, params):
    """A decode step that writes its key and value into a copy of the
    cache: the cache the next step reads is the one before it."""
    from qwen3_asr_gguf_tpu_torch.models import decoder

    step = decoder.forward_step_layers

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(copy(v) for v in x) if isinstance(x, (list, tuple)) else x

    def stale(layers, final_norm, cfg, embd, cache, pos, **k):
        return step(layers, final_norm, cfg, embd, {n: copy(v) for n, v in cache.items()},
                    pos, **k)

    monkeypatch.setattr(decoder, "forward_step_layers", stale)
    out = _fails(tiny, driver, params)
    assert out["checks"]["gap_widest"]["value"] > out["checks"]["gap_widest"]["limit"]


def test_tap_matches_served_runs():
    from benchmark import tap

    argmax = np.array([5, 6, 7, 8, 9, 10])
    sampled = np.array([1, 2, 3, 4, 2, 3])
    assert tap.firsts([9, 2, 3, 4], argmax, sampled) == [None, 6, 7, 8]
    assert tap.firsts([9, 3, 9], argmax, sampled) == [None, None, None]


@pytest.mark.parametrize("mode", ["fp8", "int4dec"])
def test_control_reads_wider_than_port(tiny, mode):
    """Each control at the port's prompts and served tokens: its gap is
    positive where the f32 port's is 0."""
    from benchmark import checkpoint, harness, tap
    from benchmark.reference.check import Reference, numbers

    tiny.add_config(config("tiny-f32"))
    tiny.add_cell("ctl", "tiny-f32", "engine_file", dict(LONG_FILE, sample_calls=8), "rtf", [])
    cell = harness.Cell(tiny.bench, "ctl")
    ckpt, _ = checkpoint.ensure(cell.config, tiny.root / "cache" / "ckpt", "cpu")
    rec = tap.ArgmaxTap("cpu", capacity=4096)
    rec.install()
    try:
        drv = cell.driver_class()(cell, ckpt, 2**31 + 1, "cpu")
        drv.setup()
        rec.reset()
        drv.run(1.0)
        argmax, sampled, _ = rec.read()
    finally:
        rec.remove()
    jobs = drv.jobs(np.random.default_rng(0))
    drv.close()
    for j in jobs:
        j["firsts"] = tap.firsts(j["served"], argmax, sampled)
    ref = Reference(ckpt, cell.config, "cpu")
    prog = numbers([ref.gaps(j, keep=True) for j in jobs])
    ctl = Reference(ckpt, cell.config, "cpu", control=mode)
    control = numbers([ctl.control_gaps(j) for j in jobs])
    assert prog["judged"] > 0 and prog["gap_widest"] == 0.0
    assert control["gap_widest"] > 0.0 and control["gap_mean"] > 0.0
