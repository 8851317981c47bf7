"""The port's tracer (`qwen3_asr_gguf_tpu_torch.utils.profiling`): spans,
counters, records and request ids; recording inside a profiler session and
inside `recording()`; `attribute_gaps` on synthetic kernels; `trace()`'s
Chrome trace and `idle_by_span.json`; and the spans the engine, the
streaming transcriber and the continuous batcher open, on a tiny CPU
checkpoint.

The file imports no JAX. Its `cuda`-marked test (the spans and the device
kernels on one clock) runs on the card with

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher
from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber
from qwen3_asr_gguf_tpu_torch.schema import ASREngineConfig
from qwen3_asr_gguf_tpu_torch.utils import profiling

SR = 16_000


@pytest.fixture
def one_torch_thread():
    """One torch thread while a whole engine runs (the test lane runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_records():
    """The record store emptied before and after the test."""
    profiling.clear()
    yield
    profiling.clear()


def _named(recs, name):
    return [r for r in recs if r.name == name and r.n is None]


def _rec(name, start_us, end_us, rid, parent=None, request=1):
    """A record made by hand, on the records' clock (ns)."""
    r = profiling.Span(profiling.Tracer(), name, request)
    r.id, r.parent, r.recorded = rid, parent, True
    r.start_ns, r.end_ns = int(start_us * 1e3), int(end_us * 1e3)
    r.seconds = (end_us - start_us) / 1e6
    return r


# -- the tracer alone ----------------------------------------------------------


def test_nesting_parents_self_time_and_request_ids(fresh_records):
    tracer = profiling.Tracer()
    with profiling.recording():
        with tracer.span("outer") as outer:
            with tracer.span("child") as child:
                with tracer.span("grandchild") as grand:
                    time.sleep(0.002)
            with tracer.span("child"):
                time.sleep(0.001)
        with tracer.span("next") as nxt:
            pass
        seen = {}

        def other():
            with tracer.span("worker", request=outer.request) as w:
                with tracer.span("worker.part") as part:
                    pass
            seen["w"], seen["part"] = w, part

        th = threading.Thread(target=other)
        th.start()
        th.join()
    recs = profiling.records()
    assert [r.name for r in recs] == ["grandchild", "child", "child", "outer", "next",
                                      "worker.part", "worker"]
    assert outer.parent is None and child.parent == outer.id and grand.parent == child.id
    assert {r.request for r in recs if r.name != "next"} == {outer.request}
    assert nxt.request != outer.request and nxt.parent is None
    assert seen["part"].parent == seen["w"].id and seen["w"].parent is None
    assert seen["w"].thread != outer.thread
    children = [r for r in recs if r.parent == outer.id]
    self_time = outer.seconds - sum(r.seconds for r in children)
    assert 0 <= self_time < outer.seconds
    assert grand.seconds >= 0.002 and child.seconds >= grand.seconds
    assert outer.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns <= outer.end_ns
    assert tracer.counts == {"outer": 1, "child": 2, "grandchild": 1, "next": 1, "worker": 1,
                             "worker.part": 1}


def test_totals_and_counters_are_kept_with_recording_off(fresh_records):
    assert not profiling.is_recording()
    tracer = profiling.Tracer()
    for _ in range(3):
        with tracer.span("a") as a:
            time.sleep(0.001)
        tracer.count("steps", 4)
    tracer.count("steps")
    q = tracer.add("queue", profiling.now_ns() - 2_000_000)
    assert profiling.records() == []
    assert tracer.counts == {"a": 3, "queue": 1} and tracer.counters == {"steps": 13}
    assert tracer.totals["a"] >= 0.003 and a.seconds >= 0.001 and not a.recorded
    assert tracer.totals["queue"] == q and 0.002 <= q < 1.0
    assert tracer.report() == tracer.totals


def test_threads_lose_no_span_count_or_record(fresh_records):
    """Sixteen threads on one tracer, switching every microsecond: every
    span, count and record lands, and each thread's spans nest under its
    own outermost span and request."""
    import sys

    tracer, n_threads, n_spans = profiling.Tracer(), 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with tracer.span("outer"):
                for _ in range(n_spans):
                    with tracer.span("inner"):
                        tracer.count("n", 2)

        with profiling.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracer.counts == {"outer": n_threads, "inner": n_threads * n_spans}
    assert tracer.counters == {"n": 2 * n_threads * n_spans}
    recs = profiling.records()
    assert len(recs) == n_threads * (1 + 2 * n_spans)
    outers = {r.id: r for r in recs if r.name == "outer"}
    inners = {r.id: r for r in recs if r.name == "inner"}
    assert len({r.request for r in outers.values()}) == n_threads
    for r in inners.values():
        owner = outers[r.parent]
        assert (r.request, r.thread) == (owner.request, owner.thread)
    assert all(inners[r.parent].request == r.request for r in recs if r.name == "n")


def test_recording_is_on_inside_a_cpu_profiler_session_on_every_thread(fresh_records):
    got = {}

    def other():
        got["on"] = profiling.is_recording()
        with profiling.span("thread.span"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        got["main"] = profiling.is_recording()
        with profiling.span("main.span"):
            profiling.count("main.count", 2)
        th = threading.Thread(target=other)
        th.start()
        th.join()
    with profiling.span("after"):
        pass
    assert got == {"main": True, "on": True}
    names = [r.name for r in profiling.records()]
    assert names == ["main.count", "main.span", "thread.span"]
    count = profiling.records()[0]
    assert count.n == 2 and count.parent == profiling.records()[1].id
    assert not profiling.is_recording()


def test_recording_switch_nests_and_clear_drops_the_records(fresh_records):
    with profiling.recording():
        with profiling.recording():
            assert profiling.is_recording()
        assert profiling.is_recording()
        with profiling.span("inside"):
            pass
    assert not profiling.is_recording()
    with profiling.span("outside"):
        pass
    assert [r.name for r in profiling.records()] == ["inside"]
    profiling.clear()
    assert profiling.records() == []


def test_device_span_on_the_cpu_is_a_host_span(fresh_records):
    with profiling.span("dev", device=torch.device("cpu")) as s:
        time.sleep(0.001)
    assert s.device_seconds() == s.seconds >= 0.001


class _FakeEvent:
    """A CUDA timing event's interface; `reached` stands for the stream
    having passed it. Waiting on it fails the test."""

    def __init__(self, ms=0.0):
        self.reached, self.ms = False, ms

    def query(self):
        return self.reached

    def synchronize(self):
        raise AssertionError("a device span waited for the card")

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_seconds_never_waits_for_the_card(fresh_records):
    """Before the stream has reached a device span's end event the span
    gives its `default` (None unless given) and keeps its events; once the
    event is reached it gives the events' elapsed time."""
    s = _rec("dev", 0, 5, 1)
    start, end = _FakeEvent(1.0), _FakeEvent(4.5)
    s._events, s._device_index = [start, end], 0
    assert s.device_seconds() is None
    assert s.device_seconds(s.seconds) == s.seconds
    end.reached = True
    assert s.device_seconds() == pytest.approx(3.5e-3)
    assert s._events is None and profiling._event_pool[0][-2:] == [start, end]
    del profiling._event_pool[0][-2:]


@pytest.mark.parametrize("case", ["nested", "partial", "threads"])
def test_attribute_gaps_names_each_idle_stretch_by_its_innermost_span(case):
    # kernels busy [0, 10], [20, 30], [35, 50], [60, 70] us: gaps 10-20, 30-35, 50-60
    kernels = [("k", 0, 10), ("k", 20, 30), ("k2", 35, 50), ("marker", 60, 70)]
    if case == "nested":
        spans = [_rec("call", 0, 70, 1), _rec("dispatch", 8, 22, 2, parent=1)]
        want = {"dispatch": 10e-6, "call": 15e-6}
        longest = [["dispatch", 10e-6], ["call", 10e-6], ["call", 5e-6]]
    elif case == "partial":
        # a span opens half way through the first gap; the last gap has none
        spans = [_rec("prompt", 14, 32, 1)]
        want = {"(no span)": 17e-6, "prompt": 8e-6}
        longest = [["prompt", 10e-6], ["(no span)", 10e-6], ["(no span)", 5e-6]]
    else:
        # two threads' spans open over one gap: the later-opened one is innermost
        spans = [_rec("main", 0, 70, 1), _rec("align", 12, 18, 2, request=1),
                 _rec("count", 12, 12, 3)]
        spans[-1].n = 1
        want = {"main": 19e-6, "align": 6e-6}
        longest = [["align", 10e-6], ["main", 10e-6], ["main", 5e-6]]
    out = profiling.attribute_gaps(kernels, spans)
    assert out["idle_s"] == pytest.approx(want, abs=1e-12)
    assert sum(out["idle_s"].values()) == pytest.approx(25e-6)
    assert [g[0] for g in out["longest"]] == [g[0] for g in longest]
    assert [g[1] for g in out["longest"]] == pytest.approx([g[1] for g in longest])
    assert out["busy_s"] == pytest.approx(45e-6) and out["window_s"] == pytest.approx(70e-6)
    assert profiling.attribute_gaps([], spans)["idle_s"] == {}


def test_trace_writes_the_spans_into_the_chrome_trace_and_idle_by_span(tmp_path, fresh_records):
    logdir = tmp_path / "trace"
    with profiling.recording(), profiling.span("before"):
        pass
    with profiling.trace(str(logdir)) as prof:
        with profiling.span("port.outer"):
            with profiling.span("port.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.005)
            torch.ones(8) + 1
    assert prof is not None
    files = list(logdir.glob("trace-*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    events = doc["traceEvents"]
    assert any(e.get("name") in ("aten::matmul", "aten::mm") for e in events)
    mine = [e for e in events if e.get("pid") == profiling.HOST_TRACK_PID and e["ph"] == "X"]
    assert {e["name"] for e in mine} == {"port.outer", "port.inner"}
    outer = next(e for e in mine if e["name"] == "port.outer")
    mm = next(e for e in events if e.get("name") in ("aten::matmul", "aten::mm"))
    assert outer["ts"] <= mm["ts"] <= outer["ts"] + outer["dur"]
    idle = json.loads((logdir / "idle_by_span.json").read_text())
    assert set(idle) == {"idle_s", "longest", "busy_s", "window_s"}
    assert idle["idle_s"].get("port.outer", 0) >= 0.004  # the sleep between operators
    assert [r.name for r in profiling.records()] == ["before"]  # its own written, then dropped


# -- the port's spans ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_trace")
    make_synthetic_checkpoint(str(d), "tiny", quant="f16", seed=0)
    return str(d)


def _engine(model_dir, **kw):
    cfg = ASREngineConfig(model_dir=model_dir, llm_fn="qwen3_asr_llm.f16.gguf", precision="f32",
                          chunk_size=2.0, n_ctx=512, verbose=False,
                          **{"max_new_tokens": 8, "decode_block": 8, **kw})
    return QwenASREngine(cfg, device="cpu")


def _audio(seconds, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)).astype(
        np.float32)


def _count_steps(monkeypatch):
    """Count the decode steps that run (`forward_step_layers` calls)."""
    steps, inner = [0], dec.forward_step_layers

    def counted(*a, **k):
        steps[0] += 1
        return inner(*a, **k)

    monkeypatch.setattr(dec, "forward_step_layers", counted)
    return steps


@pytest.mark.usefixtures("one_torch_thread")
def test_engine_init_spans_and_init_seconds(tiny_dir, fresh_records):
    with profiling.recording():
        engine = _engine(tiny_dir)
    recs = profiling.records()
    (init,) = _named(recs, "engine.init")
    children = [r.name for r in recs if r.parent == init.id]
    assert children == ["engine.init.encoder", "engine.init.decoder", "engine.init.generator"]
    assert engine.init_seconds == init.seconds > 0


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flow", ["pipelined", "synchronous"])
def test_engine_asr_spans_counts_and_performance(tiny_dir, flow, fresh_records, monkeypatch):
    """One `asr` call of three chunks: the named spans nest under
    `engine.asr`, `decode.steps` counts the steps that ran, the token counts
    are the chunks' own, and `decode_time` is the sum of the
    `engine.generate` spans (the pipelined flow: its block's queueing plus
    its collect, per chunk)."""
    engine = _engine(tiny_dir, decode_block=8 if flow == "pipelined" else 4)
    chunks = []
    collect, safe = engine._collect_chunk, engine._safe_decode

    def collect_rec(*a, **k):
        chunks.append(collect(*a, **k))
        return chunks[-1]

    def safe_rec(*a, **k):
        res, cache = safe(*a, **k)
        chunks.append(res)
        return res, cache

    engine._collect_chunk, engine._safe_decode = collect_rec, safe_rec
    audio = _audio(5.0)
    off = engine.asr(audio, context="", language="English", chunk_size_sec=2.0,
                     temperature=0.0)
    del chunks[:]
    steps = _count_steps(monkeypatch)
    with profiling.recording():
        res = engine.asr(audio, context="", language="English", chunk_size_sec=2.0,
                         temperature=0.0)
    recs = profiling.records()
    (call,) = _named(recs, "engine.asr")
    assert {r.request for r in recs} == {call.request}
    by_id = {r.id: r for r in recs}
    parent = {r.name: by_id[r.parent].name for r in recs if r.parent is not None}
    assert parent["engine.encode"] == parent["engine.prompt"] == "engine.asr"
    assert parent["decode.prefill"] == parent["engine.generate"] == "engine.asr"
    assert parent["decode.dispatch"] == parent["decode.collect"] == "engine.generate"
    assert parent["decode.steps"] == "decode.dispatch"
    assert len(_named(recs, "engine.encode")) == 3 and len(_named(recs, "decode.prefill")) == 3
    assert sum(r.n for r in recs if r.name == "decode.steps") == steps[0] > 0
    perf = res.performance
    assert set(perf) == {"prefill_time", "decode_time", "prefill_tokens", "decode_tokens",
                         "wait_time", "encode_time", "align_enc_time", "align_dec_time"}
    assert res.text == off.text and len(chunks) == 3
    assert perf["decode_tokens"] == off.performance["decode_tokens"] == sum(
        c.n_generate for c in chunks)
    assert perf["prefill_tokens"] == off.performance["prefill_tokens"] == sum(
        c.n_prefill for c in chunks)
    gens = _named(recs, "engine.generate")
    assert len(gens) == (6 if flow == "pipelined" else 3)
    assert perf["decode_time"] == pytest.approx(sum(r.seconds for r in gens), rel=1e-12)
    # per chunk: the span that queued its block and the one that read it
    # (one span for both in the synchronous flow)
    kids = {g.id: {r.name for r in recs if r.parent == g.id} for g in gens}
    queued = [g.seconds for g in gens if "decode.dispatch" in kids[g.id]]
    read = [g.seconds for g in gens if "decode.dispatch" not in kids[g.id]]
    want = (np.add(queued, read).tolist() if flow == "pipelined" else queued)
    assert [c.t_generate for c in chunks] == pytest.approx(want, rel=1e-12)
    encodes = _named(recs, "engine.encode")
    assert perf["encode_time"] == pytest.approx(sum(r.device_seconds() for r in encodes))
    assert perf["wait_time"] == pytest.approx(sum(r.seconds for r in encodes))
    assert perf["prefill_time"] == pytest.approx(
        sum(r.device_seconds() for r in _named(recs, "decode.prefill")))


@pytest.mark.usefixtures("one_torch_thread")
def test_streaming_feed_spans(tiny_dir, fresh_records, monkeypatch):
    engine = _engine(tiny_dir)
    st = StreamingTranscriber(engine, chunk_size_sec=2.0, unfixed_chunk_num=1,
                              unfixed_token_num=2, language="English")
    before = profiling.TRACER.totals.get("stream.prewarm", 0.0)
    st.prewarm(max_sec=2.0)
    assert profiling.TRACER.totals["stream.prewarm"] > before
    state = st.init_state()
    audio = _audio(4.0, seed=1)
    st.feed(state, audio[:2 * SR])
    steps = _count_steps(monkeypatch)
    with profiling.recording():
        st.feed(state, audio[2 * SR:])
    recs = profiling.records()
    (feed,) = _named(recs, "stream.feed")
    assert feed.parent is None and {r.request for r in recs} == {feed.request}
    direct = [r.name for r in recs if r.parent == feed.id]
    assert direct == ["stream.prefix", "engine.encode", "stream.prefix", "engine.prompt",
                      "decode.prefill", "engine.generate", "stream.parse"]
    by_id = {r.id: r for r in recs}
    assert {by_id[r.parent].name for r in _named(recs, "decode.dispatch")} == {"engine.generate"}
    assert sum(r.n for r in recs if r.name == "decode.steps") == steps[0] > 0
    inner = sum(r.seconds for r in recs if r.parent == feed.id and r.n is None)
    assert inner <= feed.seconds


@pytest.mark.usefixtures("one_torch_thread")
def test_continuous_batcher_stats_and_queue_span(tiny_dir, fresh_records):
    """`stats` keeps its keys, read from the batcher's own tracer; each
    request's wait before admission is a `serve.queue` record under its
    request id, and its latency a `serve.request` one."""
    engine = _engine(tiny_dir)
    cb = ContinuousBatcher(engine, max_batch=2, block=4)
    try:
        with profiling.recording():
            res = cb.submit(_audio(1.5), language="English", temperature=0.0)
        stats = cb.stats
    finally:
        cb.close()
    assert set(stats) == {"admitted", "completed", "active_rows", "queued", "t_admit",
                          "t_admit_enc", "t_admit_prefill", "t_scatter", "t_dispatch",
                          "t_fetch", "n_blocks", "n_cohorts"}
    assert stats["completed"] == 1 and stats["n_blocks"] >= 1
    assert stats["t_admit"] >= stats["t_admit_enc"] > 0 and stats["t_dispatch"] > 0
    recs = profiling.records()
    (queue,) = _named(recs, "serve.queue")
    (request,) = _named(recs, "serve.request")
    assert queue.request == request.request and queue.start_ns == request.start_ns
    assert res.performance["latency_s"] == request.seconds >= queue.seconds
    (admit,) = _named(recs, "serve.admit")
    assert admit.request == queue.request
    assert {r.request for r in _named(recs, "serve.admit.encode")} == {queue.request}
    assert {r.request for r in _named(recs, "serve.dispatch")} == {cb._trace_id}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_and_device_kernels_share_one_clock(cuda, fresh_records):
    """Between two marker kernels, a span around a 20 ms host sleep under a
    CUDA-only profiler session: recording is on during the session, and
    `attribute_gaps` puts at least 90% of the gap between the markers on
    that span. A device span's events time a kernel of known length, and
    are not waited for before the card has passed them."""
    with profile(activities=[ProfilerActivity.CUDA]):  # a first session may record nothing
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    profiling.clear()
    seen = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        seen["recording"] = profiling.is_recording()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        with profiling.span("host.sleep"):
            time.sleep(0.02)
        with profiling.span("device.sleep", device=cuda) as dev:
            torch.cuda._sleep(2_000_000)
        seen["early"] = dev.device_seconds()
        torch.cuda.synchronize()
    assert seen["recording"] and not profiling.is_recording()
    assert seen["early"] is None
    kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    marks = sorted(k for k in kernels if "spin" in k[0] or "sleep" in k[0])
    assert len(marks) >= 2, kernels
    first, second = marks[0], marks[1]
    gap_us = second[1] - first[2]
    out = profiling.attribute_gaps([first, second], profiling.records())
    assert gap_us >= 20_000
    assert out["idle_s"].get("host.sleep", 0.0) >= 0.9 * 0.02, (out, gap_us)
    assert out["idle_s"].get("host.sleep", 0.0) <= gap_us / 1e6 + 1e-9
    assert 0.5 * (second[2] - second[1]) / 1e6 <= dev.device_seconds() <= 2 * (
        second[2] - second[1]) / 1e6
