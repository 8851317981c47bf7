"""Port parity for the engine's 3-stage pipeline and the device decode block:

- the device block (`Generator.decode_block_dispatch` / `collect_block`)
  against the host-latched loop it replaced, and its repetition latch
  against the JAX `decode_block`;
- `spec_assemble` against the JAX `_spec_assemble_jit`;
- the pipelined engine (one block per chunk: speculative chunk dispatch)
  against the port's synchronous flow and the JAX pipelined engine, and its
  abort and mismatch recoveries;
- the speculative align (word-class table, `argmax_at_spec`,
  `spec_align_collect`) against the JAX aligner and `align()`;
- the batcher's 1-deep block pipeline against the unpipelined batcher.

All greedy, on the CPU, at the `tiny` / `kernel-512` sizes.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.runtime.aligner import QwenForcedAligner as JaxAligner
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu.runtime.generate import Generator as JaxGenerator
from qwen3_asr_gguf_tpu.schema import AlignerConfig, ASREngineConfig
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import decoder as tdec
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.ops.sampling import sample
from qwen3_asr_gguf_tpu_torch.runtime.aligner import QwenForcedAligner
from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher
from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator, spec_assemble

from test_torch_engine import KERNEL_PRESET, _audio, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LLM = "qwen3_asr_llm.f16.gguf"
ALIGNER_LLM = "qwen3_aligner_llm.f16.gguf"


@pytest.fixture(scope="module")
def f32_dir(tmp_path_factory):
    """The checkpoints of tests/test_golden.py (ASR model and aligner)."""
    d = tmp_path_factory.mktemp("pipeline_f32")
    make_synthetic_checkpoint(str(d), "tiny", quant="f16", seed=0)
    make_synthetic_checkpoint(str(d), "tiny", quant="f16", aligner=True, seed=1)
    return str(d)


@pytest.fixture(scope="module")
def kernel_dir(tmp_path_factory):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    d = tmp_path_factory.mktemp("pipeline_kernel")
    make_synthetic_checkpoint(str(d), "kernel-512", quant="q4_k", seed=0)
    return str(d)


# --------------------------------------------------------------------------
# the device block
# --------------------------------------------------------------------------


def _host_block(gen, cache, pos: int, tok: int, done: bool):
    """The host-latched block the device block replaced: one step per token
    with the host int token and position, the EOS and repetition latches in
    Python -> (tokens fed, pos, tok, done, aborted)."""
    emitted, aborted = [], False
    g = torch.Generator()
    while len(emitted) < gen.block and not done:
        hidden, _ = tdec.forward_step_layers(
            gen.layers_list, gen.params["final_norm"], gen.step_cfg, gen.params["embed"][tok],
            cache, pos, attn_window=tdec_window(gen, pos))
        nxt = int(sample(tdec.lm_logits(gen.params, hidden, gen.cfg.lm_head_dim), g, 0.0))
        emitted.append(tok)
        rep = gen.block > 15 and len(emitted) > 15 and len(set(emitted[-15:])) <= 3
        aborted |= rep
        done = nxt in gen.eos_ids or rep
        tok, pos = nxt, pos + 1
    return emitted, pos, tok, done, aborted


def tdec_window(gen, pos: int) -> int:
    return (pos + gen.block + 255) // 256 * 256


def _prompt(cfg, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
    return ids, np.zeros(n, bool), torch.zeros((1, cfg.hidden_size))


def _port_generator(model_dir, **kw):
    cfg, params, _ = tP.load_decoder_gguf(f"{model_dir}/{LLM}", precision="f32", device="cpu")
    return Generator(tP.fuse_layer_weights(params), cfg, n_ctx=256, cache_dtype=torch.float32,
                     device="cpu", **kw)


def _eos_at(model_dir, ids, mask, audio, k: int) -> tuple[tuple, int]:
    """((eos,), j): the first token of the greedy stream at an index j >= k
    that does not occur before it, as the only EOS id, so a block stops
    after feeding j tokens."""
    long = _port_generator(model_dir, eos_ids=(), block=24)
    st = long.start_spliced(ids, mask, audio, temperature=0.0, seed=0)
    stream, *_ = _host_block(long, st.cache, st.pos_bound, int(st.last_token), False)
    j = next(j for j in range(k, len(stream)) if stream[j] not in stream[:j])
    return (stream[j],), j


@pytest.mark.parametrize("eos_at", [None, 11])
def test_device_block_equals_the_host_latched_loop(f32_dir, eos_at):
    """Three blocks of 8 greedy steps: the same tokens, `finished`,
    `aborted` and final position as the host loop, and the KV cache's
    [0:pos) bit-equal; with `eos_at`, a token the host loop feeds from the
    12th on (in block 2 or 3) is made an EOS id, so both stop there."""
    ids, mask, audio = _prompt(TC.PRESETS["tiny"].text, 40, 0)
    eos_ids = () if eos_at is None else _eos_at(f32_dir, ids, mask, audio, eos_at)[0]
    gen = _port_generator(f32_dir, eos_ids=eos_ids, block=8)
    st = gen.start_spliced(ids, mask, audio, temperature=0.0, seed=0)
    cache_ref = copy.deepcopy(st.cache)
    pos, tok, done = st.pos_bound, int(st.last_token), bool(st.done)
    for _ in range(3):
        want, pos, tok, done, aborted = _host_block(gen, cache_ref, pos, tok, done)
        got, st, finished, got_aborted = gen.decode_block(st, 0.0)
        assert got == want and finished == done and got_aborted == aborted
        assert int(st.pos) == pos and int(st.last_token) == tok
    assert done == (eos_at is not None)
    for name in ("k", "v"):
        for a, b in zip(st.cache[name], cache_ref[name]):
            assert torch.equal(a[:pos], b[:pos])


def test_a_block_after_the_latch_holds_it(f32_dir):
    """A block queued after a finished block (as the pipelines queue one
    before reading the last): with `early_exit` off every step runs latched,
    emits nothing, holds the token and the position, and changes no cache
    slot below the position; with it on (the CPU reads the latch at once)
    no step runs."""
    ids, mask, audio = _prompt(TC.PRESETS["tiny"].text, 30, 1)
    eos_ids, j = _eos_at(f32_dir, ids, mask, audio, 9)
    assert j < 16
    gen = _port_generator(f32_dir, eos_ids=eos_ids, block=8)
    st = gen.start_spliced(ids, mask, audio, temperature=0.0, seed=0)
    _, st, finished, _ = gen.decode_block(st, 0.0)
    assert not finished
    toks, st, finished, _ = gen.decode_block(st, 0.0)
    assert finished and len(toks) == j - 8  # the EOS sampled inside block 2
    pos, tok = int(st.pos), int(st.last_token)
    before = copy.deepcopy(st.cache)
    steps = []
    inner = tdec.forward_step_layers

    def counting(*a, **k):
        steps.append(1)
        return inner(*a, **k)

    tdec.forward_step_layers = counting
    try:
        gen.early_exit = False
        st2, packed = gen.decode_block_dispatch(st, 0.0)
        assert len(steps) == gen.block
        assert gen.collect_block(packed) == ([], True, False)
        assert (packed.emitted == -1).all()
        gen.early_exit = True
        st3, packed = gen.decode_block_dispatch(st2, 0.0)
        assert len(steps) == gen.block and gen.collect_block(packed) == ([], True, False)
    finally:
        tdec.forward_step_layers = inner
    assert int(st2.pos) == int(st3.pos) == pos and int(st3.last_token) == tok
    for name in ("k", "v"):
        for a, b in zip(st3.cache[name], before[name]):
            assert torch.equal(a[:pos], b[:pos])


def test_repetition_latch_at_the_jax_step(f32_dir):
    """A head whose only nonzero row is token 7 makes the greedy stream
    repeat one or two tokens: the device latch (<= 3 distinct among the last
    15 emitted, from step 15) sets `aborted` after the same 16 tokens as the
    JAX `decode_block` on the same weights."""
    path = f"{f32_dir}/{LLM}"
    jcfg, jparams, _ = jP.load_decoder_gguf(path, precision="f32")
    jparams = jP.fuse_layer_weights(jparams)
    head = np.zeros(np.asarray(jparams["lm_head"]).shape, np.float32)
    head[7] = 1.0
    jparams["lm_head"] = jnp.asarray(head)
    jgen = JaxGenerator(jparams, jcfg, n_ctx=256, eos_ids=(), cache_dtype=jnp.float32, block=20)
    gen = _port_generator(f32_dir, eos_ids=(), block=20)
    gen.params["lm_head"] = torch.from_numpy(head)
    ids, mask, audio = _prompt(gen.cfg, 24, 2)
    jst = jgen.start_spliced(ids, mask, jnp.asarray(audio.numpy()), temperature=0.0, seed=0)
    want, _, jfinished = jgen.decode_block(jst, 0.0)
    st = gen.start_spliced(ids, mask, audio, temperature=0.0, seed=0)
    got, _, finished, aborted = gen.decode_block(st, 0.0)
    assert got == [int(t) for t in want] and len(got) == 16
    assert finished and jfinished and aborted


# --------------------------------------------------------------------------
# the speculative suffix prompt
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_emit,rollback,max_keep", [
    (8, 0, 12),  # every emitted token kept
    (8, 3, 12),  # the rollback trim
    (5, 3, 12),  # -1 padding after 5 tokens
    (12, 0, 6),  # clipped by max_keep
    (2, 3, 12),  # fewer tokens than the rollback: none kept
])
def test_spec_assemble_equals_jax(n_emit, rollback, max_keep):
    rng = np.random.default_rng(n_emit * 10 + rollback)
    emitted = np.full(12, -1, np.int64)
    emitted[:n_emit] = rng.integers(0, 5000, size=n_emit)
    template = rng.integers(1, 5000, size=9).astype(np.int32)
    n_audio, bucket = 23, 128
    jfn = JaxGenerator._build_spec_assemble(None)
    want_ids, want_len = jfn(jnp.asarray(template), jnp.asarray(emitted.astype(np.int32)),
                             n_audio, len(template), bucket, rollback, max_keep)
    ids, length = spec_assemble(torch.from_numpy(template.astype(np.int64)),
                                torch.from_numpy(emitted), n_audio=n_audio, bucket=bucket,
                                rollback=rollback, max_keep=max_keep)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert int(length) == int(want_len) == n_audio + 9 + min(max(n_emit - rollback, 0), max_keep)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------


def _engine_config(model_dir, llm_fn=LLM, precision="f32", **kw):
    return ASREngineConfig(model_dir=model_dir, llm_fn=llm_fn, precision=precision,
                           chunk_size=2.0, n_ctx=512, verbose=False, max_new_tokens=8,
                           decode_block=8, **kw)


def _recorded_run(engine, audio, seed: int, **kw):
    """(text, per-chunk stable tokens, prefill_tokens, decode_tokens, result)
    of one greedy call; chunks decoded on the synchronous path are recorded
    through `_safe_decode`, pipelined ones through `_collect_chunk`."""
    chunks = []
    inner_safe, inner_collect = engine._safe_decode, engine._collect_chunk

    def safe(*a, **k):
        res, cache = inner_safe(*a, **k)
        chunks.append(("safe", list(res.stable_tokens), False))
        return res, cache

    def collect(*a, **k):
        res = inner_collect(*a, **k)
        chunks.append(("collect", list(res.stable_tokens), res.is_aborted))
        return res

    engine._safe_decode, engine._collect_chunk = safe, collect
    try:
        np.random.seed(seed)
        res = engine.asr(audio, context="", language="English", chunk_size_sec=2.0,
                         memory_chunks=1, **{"temperature": 0.0, **kw})
    finally:
        engine._safe_decode, engine._collect_chunk = inner_safe, inner_collect
    final = [toks for _, toks, aborted in chunks if not aborted]
    return res.text, final, res.performance["prefill_tokens"], \
        res.performance["decode_tokens"], chunks


def _pipelined_and_sync(cfg, audio, seed, **kw):
    pipe = QwenASREngine(cfg, device="cpu")
    sync = QwenASREngine(dataclasses.replace(cfg, pipelined_dispatch=False), device="cpu")
    return _recorded_run(pipe, audio, seed, **kw), _recorded_run(sync, audio, seed, **kw)


def test_pipelined_engine_equals_sync_and_jax_on_f32(f32_dir):
    """7 s in 2 s chunks, one block per chunk: the pipelined port, the
    synchronous port and the pipelined JAX engine give the same text,
    per-chunk stable tokens and token counts; the pipelined port read
    chunks 1-3 from their speculative dispatch."""
    cfg = _engine_config(f32_dir)
    audio = _audio(7.0, 520.0)
    pipe, sync = _pipelined_and_sync(cfg, audio, 7)
    assert pipe[:4] == sync[:4]
    assert len(pipe[1]) == 4 and sum(map(len, pipe[1])) > 0
    assert [c[0] for c in pipe[4]] == ["collect"] * 4  # no chunk fell back
    jax_run = _recorded_run(JaxEngine(cfg), audio, 7)
    assert jax_run[:4] == pipe[:4]


def test_pipelined_engine_equals_sync_and_jax_on_kernel_shapes(kernel_dir):
    """The int4 engine (the q4_k kernels' plain versions) on `kernel-512`:
    pipelined and synchronous port and the pipelined JAX engine (its q4_k
    kernels in Pallas interpret mode) equal."""
    cfg = _engine_config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", "int4")
    audio = _audio(7.0, 440.0)
    pipe, sync = _pipelined_and_sync(cfg, audio, 11)
    assert pipe[:4] == sync[:4] and len(pipe[1]) == 4
    assert [kind for kind, _, _ in pipe[4]] == ["collect"] * 4
    assert _recorded_run(JaxEngine(cfg), audio, 11)[:4] == pipe[:4]


def test_pipelined_abort_recovers(f32_dir):
    """JAX test_pipelined_abort_recovers: chunk 0's pipelined result is
    marked aborted, so the queued chunk 1 is dropped and chunk 0 redone from
    its full prompt at temperature + 0.3. At temperature -0.3 both attempts
    are greedy, so the text equals the synchronous flow's."""
    cfg = _engine_config(f32_dir)
    audio = _audio(5.0, 520.0)
    pipe = QwenASREngine(cfg, device="cpu")
    calls, inner = {"n": 0}, pipe._collect_chunk

    def poisoned(pend, rollback_num, is_last):
        res = inner(pend, rollback_num, is_last)
        calls["n"] += 1
        if calls["n"] == 1:
            res.is_aborted = True
        return res

    pipe._collect_chunk = poisoned
    got = _recorded_run(pipe, audio, 3, temperature=-0.3)
    sync = QwenASREngine(dataclasses.replace(cfg, pipelined_dispatch=False), device="cpu")
    want = _recorded_run(sync, audio, 3, temperature=-0.3)
    assert calls["n"] >= 2 and got[3] > 0
    assert got[0] == want[0] and got[1] == want[1]


def test_pipelined_mismatch_falls_back(f32_dir):
    """JAX test_pipelined_mismatch_falls_back: at n_ctx 120 the speculative
    prompt can keep only a clipped tail (max_keep), so with rollback 0 the
    host keeps more stable tokens than it; the queued chunk is dropped and
    redone on its header prefix, and the text equals the synchronous flow's."""
    cfg = dataclasses.replace(_engine_config(f32_dir), n_ctx=120)
    audio = _audio(3.5, 520.0)
    pipe = QwenASREngine(cfg, device="cpu")
    calls = {"_dispatch_chunk": 0, "_dispatch_chunk_spec": 0}
    for name in calls:
        def counted(*a, _inner=getattr(pipe, name), _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        setattr(pipe, name, counted)
    got = _recorded_run(pipe, audio, 5, rollback_num=0)
    sync = QwenASREngine(dataclasses.replace(cfg, pipelined_dispatch=False), device="cpu")
    want = _recorded_run(sync, audio, 5, rollback_num=0)
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) == 2
    # chunk 1 was queued speculatively, dropped (8 stable tokens, room for
    # 6), and queued again from the host's prompt
    assert calls == {"_dispatch_chunk": 2, "_dispatch_chunk_spec": 1}


# --------------------------------------------------------------------------
# the speculative align
# --------------------------------------------------------------------------


def _align_cfg(model_dir):
    return AlignerConfig(model_dir=model_dir, llm_fn=ALIGNER_LLM, precision="f32", n_ctx=512)


@pytest.fixture(scope="module")
def aligners(f32_dir):
    jal, tal = JaxAligner(_align_cfg(f32_dir)), QwenForcedAligner(_align_cfg(f32_dir), device="cpu")
    return jal, tal


def test_word_cls_table_equals_jax(aligners):
    jal, tal = aligners
    want, got = jal.build_word_cls_table(), tal.build_word_cls_table()
    np.testing.assert_array_equal(got, want)
    assert (got == 2).sum() > 50 and (got == 1).sum() > 0


@pytest.mark.parametrize("drop_last", [0, 3])
def test_argmax_at_spec_equals_jax(aligners, drop_last):
    """`[ts..., n_words]` of the device-built align prompt (f32 aligner),
    from an emitted buffer of CJK, punctuation and other tokens, -1 padded."""
    jal, tal = aligners
    tab = tal.build_word_cls_table()
    cjk = [t for t in range(len(tab)) if tab[t] == 2]
    other = [t for t in range(len(tab)) if tab[t] == 0][:2]
    punct = [t for t in range(len(tab)) if tab[t] == 1][:2]
    toks = np.full(16, -1, np.int64)
    seq = cjk[:4] + punct[:1] + other[:1] + cjk[4:8] + punct[1:]
    toks[: len(seq)] = seq
    rng = np.random.default_rng(drop_last)
    audio = rng.standard_normal((32, tal.dec_cfg.hidden_size)).astype(np.float32)
    special = (tal.ID_AUDIO_START, tal.ID_AUDIO_END, tal.ID_TIMESTAMP)
    want = jal.runner.argmax_at_spec(jnp.asarray(toks.astype(np.int32)),
                                     jnp.asarray(tab), jnp.asarray(audio), 17, 4000, special,
                                     drop_last=drop_last)
    got = tal.runner.argmax_at_spec(torch.from_numpy(toks), torch.from_numpy(tab),
                                    torch.from_numpy(audio), 17, 4000, special,
                                    drop_last=drop_last)
    np.testing.assert_array_equal(got.fetch(), np.asarray(want))
    assert int(got.fetch()[-1]) == len([t for t in seq[: len(seq) - drop_last] if tab[t] == 2])


def _cjk_and_punct(tal):
    tab = tal.build_word_cls_table()
    tok = tal.tokenizer
    cjk = [t for t in range(len(tab)) if tab[t] == 2][:8]
    punct = tok.encode(", ", allow_special=False)
    assert all(tab[t] == 1 for t in punct)  # ascii punctuation and space: droppable
    return tok, cjk, punct


@pytest.mark.parametrize("drop", [0, 3])
def test_spec_align_collect_equals_align(aligners, drop):
    """The speculative align's items equal `align()`'s within 1e-6 s, with
    the buffer's last `drop` tokens trimmed on the device (a non-final
    chunk's rollback)."""
    _, a = aligners
    tok, cjk, punct = _cjk_and_punct(a)
    emitted = cjk[:3] + punct + cjk[3:8]
    stable = emitted[: len(emitted) - drop]
    text = tok.decode(stable)
    audio = _audio(1.2)
    key = ("spec", drop, len(audio))
    a.pre_encode(audio, key=key)
    buf = np.full(16, -1, np.int64)
    buf[: len(emitted)] = emitted
    a.spec_align_start(torch.from_numpy(buf), key=key, language="Chinese", drop_last=drop)
    got = a.spec_align_collect(stable, text, "Chinese", 1.0, key=key)
    assert got is not None and got.performance.get("speculative") == 1.0
    assert a._pre is None  # the taken result drops the window
    want = a.align(audio, text, language="Chinese", offset_sec=1.0)
    assert [i.text for i in got.items] == [i.text for i in want.items] and got.items
    for g, w in zip(got.items, want.items):
        assert abs(g.start_time - w.start_time) < 1e-6 and abs(g.end_time - w.end_time) < 1e-6


def test_spec_align_mismatch_returns_none_and_keeps_the_window(aligners):
    """A text whose words are not the buffer's class-2 characters: None, and
    the pre-encoded window stays for `align()`, which takes it."""
    _, a = aligners
    tok, cjk, _ = _cjk_and_punct(a)
    audio = _audio(1.2)
    key = ("mismatch", 0, len(audio))
    a.pre_encode(audio, key=key)
    buf = np.full(16, -1, np.int64)
    buf[:5] = cjk[:5]
    a.spec_align_start(torch.from_numpy(buf), key=key, language="Chinese")
    text = tok.decode(cjk[:4])  # one word short
    assert a.spec_align_collect(cjk[:5], text, "Chinese", 0.0, key=key) is None
    assert a._pre is not None and a._pre[0] == key
    res = a.align(audio, text, language="Chinese", offset_sec=0.0, precomputed_key=key)
    assert a._pre is None and [i.text for i in res.items] == [tok.decode([t]) for t in cjk[:4]]


def test_pipelined_engine_items_equal_the_sync_engines(f32_dir):
    """With the aligner: the pipelined engine (align worker, speculative
    aligns of chunk 0 and the last chunk) gives the synchronous engine's
    text and items; 5 s in 2 s chunks, CJK text ("Chinese")."""
    cfg = _engine_config(f32_dir, enable_aligner=True, align_config=_align_cfg(f32_dir))
    audio = _audio(5.0, 550.0)
    results = []
    for pipelined in (True, False):
        eng = QwenASREngine(dataclasses.replace(cfg, pipelined_dispatch=pipelined),
                            device="cpu")
        taken = []
        inner = eng.aligner.spec_align_collect

        def collect(*a, **k):
            out = inner(*a, **k)
            taken.append(out is not None)
            return out

        eng.aligner.spec_align_collect = collect
        np.random.seed(13)
        res = eng.asr(audio, context="", language="Chinese", chunk_size_sec=2.0,
                      temperature=0.0)
        items = [(i.text, i.start_time, i.end_time) for i in res.alignment.items]
        results.append((res.text, items, taken))
    (p_text, p_items, p_taken), (s_text, s_items, s_taken) = results
    assert p_text == s_text and p_items == s_items and p_items
    assert any(p_taken) and not s_taken


# --------------------------------------------------------------------------
# the batcher's block pipeline
# --------------------------------------------------------------------------


def _batcher_tokens(engine, audios, pipeline: bool, eos=None):
    class Recording(ContinuousBatcher):
        def _retire(self, row_idx):
            self.seen.append(list(self.rows[row_idx].tokens))
            super()._retire(row_idx)

    cb = Recording(engine, max_batch=2, block=4, max_new_tokens=12)
    cb.seen, cb.pipeline = [], pipeline
    if eos is not None:
        cb.eos = frozenset([eos])
        cb.eos_dev = torch.tensor([eos])
    try:
        texts = [cb.submit(a, language="English", temperature=0.0).text for a in audios]
    finally:
        cb.close()
    return texts, cb.seen, cb.stats["n_blocks"]


def test_pipelined_batcher_equals_the_unpipelined(f32_dir):
    """One request at a time, so each row's tokens are its own: the same
    transcripts and tokens with and without the 1-deep block pipeline, in as
    many blocks (the block that would only run past the budget is not
    queued); then a token of block 2 made an EOS id stops the row at the
    same token in both (the pipelined flow queued block 3 before reading
    block 2: the device's chained latch holds the row there)."""
    engine = QwenASREngine(_engine_config(f32_dir), device="cpu")
    audios = [_audio(1.5, 440.0), _audio(1.0, 660.0)]
    want = _batcher_tokens(engine, audios, False)
    got = _batcher_tokens(engine, audios, True)
    assert got[:2] == want[:2] and all(len(t) == 12 for t in want[1])
    assert got[2] == want[2]  # no block queued past the rows' budgets
    stream = want[1][0]
    eos = next(t for i, t in enumerate(stream) if i >= 5 and t not in stream[:i])
    stop = stream.index(eos)
    want_eos = _batcher_tokens(engine, audios[:1], False, eos)
    got_eos = _batcher_tokens(engine, audios[:1], True, eos)
    assert got_eos[:2] == want_eos[:2]
    assert want_eos[1][0] == stream[:stop]  # the tokens fed before the EOS
    assert got_eos[2] == want_eos[2] + 1  # the one block queued ahead, latched
