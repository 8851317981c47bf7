"""A configuration's architecture module: a configuration that names none
reaches today's writer, taps and reference unchanged; a new architecture
added as files reaches the harness's verdict with its own writer, taps,
reference and numbers; and `qwen3_asr_aligned`, the forced aligner as the
engine's third stage, is judged against a plain reference that agrees with
the port's aligner, through a tap that holds what the aligner served."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from .conftest import FILE_PARAMS, INT4_TEXT, TINY_AUDIO, TINY_TEXT, config

SEED = 2**31 + 1
# a chunk's stable run long enough to be found once in the window's record
ALIGNED_PARAMS = dict(FILE_PARAMS, max_new_tokens=16, decode_block=16)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def aligned_config(name: str, precision: str = "f32") -> dict:
    text = dict(INT4_TEXT if precision == "int8" else TINY_TEXT, classify_num=96)
    cfg = config(name)
    cfg["architecture"] = "qwen3_asr_aligned"
    cfg["aligner"] = {"source": "test", "weights_seed": 1, "precision": precision, "n_ctx": 512,
                      "model": {"audio": dict(TINY_AUDIO, output_dim=text["hidden_size"]),
                                "text": text}}
    return cfg


def add_aligned_cell(tiny, name: str = "al", precision: str = "f32", params: dict = None,
                     **limits) -> None:
    tiny.add_config(aligned_config("tiny-al", precision))
    tiny.add_cell(name, "tiny-al", "engine_file_aligned", params or ALIGNED_PARAMS, "rtf",
                  ["align_ms_per_chunk.aligned", "mfu.aligned", "decode_ms_per_token.aligned"])
    path = tiny.bench / "workloads" / f"{name}.json"
    spec = json.loads(path.read_text())
    spec["limits"].update({"align_gap_widest": 1e-3, "min_align_judged": 8, **limits})
    path.write_text(json.dumps(spec))


def drive(cell, ckpt, seconds: float = 1.0) -> tuple[list, object]:
    """A window of `cell`'s traffic with its architecture's taps: the
    sampled jobs, filled, and the driver (closed)."""
    taps = cell.arch.taps("cpu")
    for tap in taps:
        tap.install()
    try:
        drv = cell.driver_class()(cell, ckpt, SEED, "cpu")
        drv.setup()
        drv.warm()
        for tap in taps:
            tap.reset()
        drv.run(seconds)
        records = [tap.read() for tap in taps]
    finally:
        for tap in reversed(taps):
            tap.remove()
    jobs = drv.jobs(np.random.default_rng(0))
    for tap, record in zip(taps, records):
        tap.fill(jobs, record)
    drv.close()
    return jobs, drv


# -- a configuration that names no architecture --------------------------------


def test_default_architecture_writes_todays_checkpoint_bytes(tiny):
    from benchmark import checkpoint, harness

    tiny.add_config(config("tiny-f32"))
    tiny.add_cell("file-tiny", "tiny-f32", "engine_file", FILE_PARAMS, "rtf", [])
    cell = harness.Cell(tiny.bench, "file-tiny")
    assert cell.arch.__name__ == "bench_arch_qwen3_asr"
    via_arch, written = cell.arch.checkpoint(cell.config, tiny.root / "a", "cpu")
    direct, _ = checkpoint.ensure(cell.config, tiny.root / "b", "cpu")
    assert written and _digests(via_arch) == _digests(direct)
    assert cell.arch.checkpoint(cell.config, tiny.root / "a", "cpu") == (via_arch, False)


def test_default_architecture_reads_todays_gaps(tiny):
    """The harness's judge through the architecture gives the numbers that
    `reference/check.py` gives the same jobs directly."""
    from benchmark import harness
    from benchmark.reference.check import Reference, numbers

    tiny.add_config(config("tiny-f32"))
    tiny.add_cell("file-tiny", "tiny-f32", "engine_file", dict(FILE_PARAMS, sample_calls=3),
                  "rtf", [])
    cell = harness.Cell(tiny.bench, "file-tiny")
    ckpt, _ = cell.arch.checkpoint(cell.config, tiny.root / "cache", "cpu")
    jobs, _ = drive(cell, ckpt)
    got = harness.judge(cell.arch, ckpt, cell.config, jobs, "cpu")
    ref = Reference(ckpt, cell.config, "cpu")
    want = numbers([ref.gaps(j) for j in jobs if j["served"]])
    assert got == dict(want, prompt_mismatches=0) and got["judged"] > 0
    checks, correct = harness.verdict(got, cell.spec["limits"], cell.arch.FIXED)
    assert list(checks) == ["gap_widest", "prompt_mismatches", "judged"] and correct


# -- a new architecture, as files only ----------------------------------------

TOY = '''
"""A toy architecture over qwen3_asr's model: its own writer (a marker file
beside the checkpoint), its own tap (counts sampled tokens), its own
reference (a number of its own per job) and its own numbers."""

from benchmark import checkpoint as writer
from benchmark.architectures import qwen3_asr as base
from qwen3_asr_gguf_tpu_torch.runtime import generate

CONTROLS = ()
FIXED = {"toy_mismatches": 0}


def checkpoint(cfg, cache_root, device):
    def write(d):
        writer.write_model(d, cfg["model"], int(cfg["weights_seed"]), device)
        (d / "toy.txt").write_text("written by the toy writer")
    return writer.ensure(cfg, cache_root, device, write=write, keys=("model", "toy"))


class Counter:
    def __init__(self, device):
        self.n = 0
    def install(self):
        self.inner = generate.sample
        def sample(*a, **k):
            self.n += 1
            return self.inner(*a, **k)
        generate.sample = sample
    def remove(self):
        generate.sample = self.inner
    def reset(self):
        self.n = 0
    def read(self):
        return self.n
    def fill(self, jobs, n):
        for job in jobs:
            job["toy_samples"] = n
        return f"{n} samples"


def taps(device):
    return base.taps(device) + [Counter(device)]


class Judge:
    def __init__(self, ckpt, cfg, device, control=None):
        self.ckpt = ckpt
    def judge(self, job, keep=False):
        ok = job["toy_samples"] > 0 and (self.ckpt / "toy.txt").exists()
        return {"toy": len(job["served"])} if ok else {"miss": 1}
    def control(self, job):
        return {}


def reference(ckpt, cfg, device, control=None):
    return Judge(ckpt, cfg, device, control)


def numbers(results):
    n = sum(r.get("toy", 0) for r in results)
    return {"toy_tokens": n, "toy_judged": len(results),
            "toy_mismatches": sum(r.get("miss", 0) for r in results)}
'''


@pytest.mark.parametrize("limit,correct", [(10_000, True), (1, False)])
def test_new_architecture_from_files_only(tiny, limit, correct):
    """No file that is there is edited: the harness finds the architecture
    by the configuration's name for it, and the verdict compares its
    numbers by the cell's limits, its fixed numbers and its `min_` count."""
    before = _digests(tiny.bench)
    (tiny.bench / "architectures" / "toy.py").write_text(TOY)
    cfg = dict(config("tiny-toy"), architecture="toy", toy=1)
    tiny.add_config(cfg)
    tiny.add_cell("toy-cell", "tiny-toy", "engine_file", FILE_PARAMS, "rtf", [])
    path = tiny.bench / "workloads" / "toy-cell.json"
    spec = json.loads(path.read_text())
    spec["limits"] = {"toy_tokens": limit, "min_toy_judged": 2}
    path.write_text(json.dumps(spec))
    after = _digests(tiny.bench)
    assert all(after[p] == d for p, d in before.items())
    out = tiny.run("toy-cell", trace=False)
    assert list(out["checks"]) == ["toy_tokens", "toy_mismatches", "toy_judged"]
    assert out["checks"]["toy_mismatches"]["value"] == 0
    assert out["checks"]["toy_judged"]["value"] >= 2
    assert out["correct"] is correct
    assert (tiny.root / "cache" / "ckpt" / "tiny-toy" / "toy.txt").exists()


# -- the forced aligner --------------------------------------------------------


def _aligner_ckpt(tiny, precision: str):
    from benchmark import harness

    add_aligned_cell(tiny, precision=precision)
    cell = harness.Cell(tiny.bench, "al")
    ckpt, _ = cell.arch.checkpoint(cell.config, tiny.root / "cache", "cpu")
    return cell, ckpt


def _port_aligner(ckpt, precision: str):
    from qwen3_asr_gguf_tpu_torch.runtime.aligner import QwenForcedAligner
    from qwen3_asr_gguf_tpu_torch.schema import AlignerConfig

    return QwenForcedAligner(AlignerConfig(
        model_dir=str(ckpt / "aligner"), encoder_fn="qwen3_asr_encoder.safetensors",
        llm_fn="qwen3_asr_llm.q4_k.gguf", n_ctx=512, precision=precision), device="cpu")


def _text(ckpt, n: int) -> tuple[list, str]:
    from benchmark.checkpoint import cjk_token_ids
    from benchmark.reference.check import tokenizer

    tok = tokenizer(ckpt / "aligner")
    ids = cjk_token_ids(tok)[7:7 + n]
    return ids, tok.decode(ids)


def test_aligner_reference_words_split_as_the_aligner_does():
    from qwen3_asr_gguf_tpu_torch.text import align_text

    from benchmark.reference.aligner import words

    for text in ["你好，世界!", "hello  wörld's 42x", "a中b 文,c", "  ", "。，", "x—y z"]:
        assert words(text) == align_text.tokenize(text, "Chinese"), text


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_aligner_reference_agrees_with_port(tiny, precision):
    """`align()` on seeded random weights at a tiny size, read through the
    tap, against the reference: at f32 every slot's class is the
    reference's best (gap 0); at int8 the port's products on the CPU take
    int8 activations (one scale per row), so a class may part from the
    reference's at a near-tie, by less than the float8 control does."""
    from benchmark import signals
    from benchmark.architectures import qwen3_asr_aligned as arch
    from benchmark.reference import prompts
    from benchmark.reference.aligner import Aligner, words
    from benchmark.reference.check import tokenizer

    cell, ckpt = _aligner_ckpt(tiny, precision)
    al_cfg = cell.config["aligner"]
    tap = arch.AlignTap("cpu")
    tap.install()
    try:
        port = _port_aligner(ckpt, precision)
        clip = signals.speech(SEED, 0, 7.3)
        s, e = 3_200, len(clip)
        _, text = _text(ckpt, 40)
        port.align(clip[s:e], text, language="Chinese", precomputed_key=(1, s, e))
        record = tap.read()
    finally:
        tap.remove()
    job = {"kind": "align", "path": "align", "key": (1, s, e), "text": text}
    tap.fill([job], record)
    rec = job["port"]
    ref = Aligner(ckpt / "aligner", al_cfg, "cpu")
    tok = tokenizer(ckpt / "aligner")
    word_tokens = [tok.encode(w, allow_special=False) for w in words(text)]
    n_audio = prompts.rows_of(e - s)
    post, _ = ref.prompt(n_audio, word_tokens)
    classes = arch.port_alignment(rec, n_audio, post, len(word_tokens))
    assert classes is not None and len(classes) == 80
    logits = ref.logits(clip[s:e], n_audio, word_tokens)[:, : ref.window]

    def gaps(chosen) -> float:
        chosen = torch.as_tensor(chosen)
        return float((logits.amax(-1) - logits.gather(1, chosen[:, None])[:, 0]).max())

    port = gaps(classes)
    controls = [gaps(Aligner(ckpt / "aligner", al_cfg, "cpu", control=mode).logits(
        clip[s:e], n_audio, word_tokens)[:, : ref.window].argmax(-1)) for mode in arch.CONTROLS]
    if precision == "f32":
        assert port == 0.0
    else:
        assert all(port < c for c in controls), (port, controls)


def test_tap_holds_what_align_and_the_speculative_path_served(tiny):
    """The classes the tap records are the ones each path's result was made
    from (its word times are the classes, repaired and scaled by 80 ms), and
    the speculative path reads the classes `align()` reads for the same
    window and text."""
    from qwen3_asr_gguf_tpu_torch.text import align_text

    from benchmark import signals
    from benchmark.architectures import qwen3_asr_aligned as arch

    _, ckpt = _aligner_ckpt(tiny, "f32")
    tap = arch.AlignTap("cpu")
    tap.install()
    try:
        port = _port_aligner(ckpt, "f32")
        port.build_word_cls_table()
        clip = signals.speech(SEED, 1, 6.0)
        ids, text = _text(ckpt, 7)
        key = (3, 0, len(clip))
        port.pre_encode(clip, key=key)
        toks = torch.tensor(ids + [ids[0], ids[1]] + [-1] * 7, dtype=torch.int64)
        port.spec_align_start(toks, key=key, language="Chinese", drop_last=2)
        spec = port.spec_align_collect(ids, text, "Chinese", 0.0, key=key)
        plain = port.align(clip, text, language="Chinese", precomputed_key=key)
        record = tap.read()
    finally:
        tap.remove()
    assert spec is not None and spec.performance.get("speculative") == 1.0
    jobs = [{"kind": "align", "path": p, "key": key, "text": text} for p in ("spec", "align")]
    tap.fill(jobs, record)
    got = {}
    for job, res in zip(jobs, (spec, plain)):
        rec = job["port"]
        classes = rec["classes"] if rec["path"] == "align" else rec["out"][: 2 * len(ids)]
        ms = np.asarray(align_text.fix_timestamps(list(classes)), dtype=np.float64) * 80.0
        times = [t for item in res.items for t in (item.start_time, item.end_time)]
        assert np.allclose(times, ms / 1000.0), job["path"]
        got[job["path"]] = list(classes)
    assert got["spec"] == got["align"]
    assert [r["path"] for r in record] == ["spec", "taken", "align"]


def test_aligned_cell_end_to_end(tiny):
    """The aligned cell through the harness on the CPU: every alignment of
    the sampled call judged, each slot's class the reference's best at f32,
    and the per-layer metrics that read on the CPU."""
    add_aligned_cell(tiny)
    out = tiny.run("al", trace=False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rtf", "setup_s"} and out["failed"] == 0
    checks = out["checks"]
    assert list(checks) == ["gap_widest", "align_gap_widest", "prompt_mismatches",
                            "align_mismatches", "judged", "align_judged"]
    assert checks["align_gap_widest"]["value"] == 0.0 and checks["align_judged"]["value"] >= 8
    traced = tiny.run("al", trace=True, seed=SEED + 5)
    assert traced["correct"], traced["checks"]
    # the spans are recorded under the card's profiler alone
    assert set(traced["metrics"]) == {"mfu.aligned", "decode_ms_per_token.aligned"}


@pytest.mark.parametrize("path", ["argmax_at", "argmax_at_spec"])
def test_altered_class_fails(tiny, monkeypatch, path):
    """A fault where the aligner's answer is produced: every class one
    step later on one of the two readouts."""
    from qwen3_asr_gguf_tpu_torch.runtime import generate

    inner = getattr(generate.SparseLogitsRunner, path)

    def altered(*a, **k):
        out = inner(*a, **k)
        if path == "argmax_at":
            return (out + 1) % 90
        out.dev[:-1] = (out.dev[:-1] + 1) % 90
        out.host = out.dev
        return out

    monkeypatch.setattr(generate.SparseLogitsRunner, path, altered)
    add_aligned_cell(tiny, params=dict(ALIGNED_PARAMS, sample_calls=100))  # every call
    out = tiny.run("al", trace=False)
    assert not out["correct"]
    assert out["checks"]["align_gap_widest"]["value"] > out["checks"]["align_gap_widest"]["limit"]


def test_missing_alignment_is_a_mismatch(tiny, monkeypatch):
    """A chunk whose alignment never comes (the engine degrades it to no
    word times when the aligner raises) counts as failed and mismatched."""
    from qwen3_asr_gguf_tpu_torch.runtime import aligner

    def broken(*a, **k):
        raise RuntimeError("aligner fault")

    monkeypatch.setattr(aligner.QwenForcedAligner, "align", broken)
    monkeypatch.setattr(aligner.QwenForcedAligner, "spec_align_collect", lambda *a, **k: None)
    add_aligned_cell(tiny)
    out = tiny.run("al", trace=False)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    assert out["checks"]["align_mismatches"]["value"] > 0


def test_classify_prefill_counts_the_head_at_the_slots_alone():
    from benchmark import roofline

    t = dict(INT4_TEXT, classify_num=96)
    a = roofline.classify_prefill(t, 300, 40, weight_bytes=1.0)
    b = roofline.classify_prefill(t, 300, 41, weight_bytes=1.0)
    layers, head = roofline.decoder_params(t)
    assert b.flops - a.flops == pytest.approx(2.0 * head)
    assert b.bytes - a.bytes == pytest.approx(4 * 96)
    one = roofline.classify_prefill(t, 300, 1)
    whole = roofline.prefill(t, 300)  # the head at the last token, every token's logits
    assert one.flops == pytest.approx(whole.flops) and one.bytes < whole.bytes
