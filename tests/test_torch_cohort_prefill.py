"""The cohort-batched admission prefill on the CPU: the port's
`ContinuousBatcher._stage_cohort` and `BatchedGenerator.prefill` (both
through `runtime.generate.prefill_cohort`, one `forward_prefill_lanes` pass
and one LM-head call per cohort) against the JAX package's
`ContinuousBatcher._prefill_stage` and `BatchedGenerator._prefill`
(`prefill_batch`), and against the port's single-lane prefill.

The cohort mixes lengths: a 2 s chunk-0 prompt, a lane of a few tokens, a
second chunk that carries the first chunk's audio and tokens, and a lane of
exactly the cohort's padded length `t_pad`. Engines: the f32 `tiny` one
with f32 KV, and the int4 `kernel-512` one (dense bf16 prefill weights)
with bf16 and with int8 KV. Tolerances scale with the largest |value| of
the reference: F32_REL of it for the f32 engine; for the int4 engine's bf16
activations BF16_REL of it against the port's single-lane prefill (the
bound chip_smoke.py holds the card to) and JAX_BF16_ULPS bf16 ulps of it
against the JAX package (two frameworks round every activation after their
own sum orders; the worst seen is 2 ulps). Greedy first tokens equal.
"""

import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.runtime.batched import BatchedEngine as JaxBatchedEngine
from qwen3_asr_gguf_tpu.runtime.continuous import ContinuousBatcher as JaxBatcher
from qwen3_asr_gguf_tpu.runtime.engine import QwenASREngine as JaxEngine
from qwen3_asr_gguf_tpu_torch import QwenASREngine
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.runtime import generate as G
from qwen3_asr_gguf_tpu_torch.runtime.batched import BatchedEngine
from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher, _Request

from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import KERNEL_PRESET, _audio, _config

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_REL = 1e-5  # of max|ref|: f32 engine, sums in other orders
BF16_REL = 1e-2  # of max|ref|: bf16 activations, the port against itself
JAX_BF16_ULPS = 4  # bf16 ulps of max|ref|: bf16 activations, the port against JAX
ENGINES = ["tiny-f32", "int4-bf16kv", "int4-int8kv"]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16")
    return d


@pytest.fixture(scope="module")
def kernel_dir(tmp_path_factory):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    d = str(tmp_path_factory.mktemp("cohort_kernel"))
    make_synthetic_checkpoint(d, "kernel-512", quant="q4_k", seed=1)
    return d


def _engine_config(name, tiny_dir, kernel_dir):
    if name == "tiny-f32":
        return _config(tiny_dir, "qwen3_asr_llm.f16.gguf", "f32")
    kv = name.split("-")[1].removesuffix("kv")
    return _config(kernel_dir, "qwen3_asr_llm.q4_k.gguf", "int4", kv_cache_dtype=kv)


def _ulp_bound(ulps: int):
    """`ulps` bf16 ulps at max|ref| (8 significant bits)."""
    return lambda want: ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


@pytest.fixture(scope="module", params=ENGINES)
def engines(request, tiny_dir, kernel_dir):
    """(port engine, JAX engine, bounds): the bounds map a reference array
    to the absolute tolerance against the JAX package and against the
    port's single-lane prefill."""
    cfg = _engine_config(request.param, tiny_dir, kernel_dir)
    if request.param == "tiny-f32":
        bounds = {"jax": lambda want: F32_REL * np.abs(want).max(),
                  "single": lambda want: F32_REL * np.abs(want).max()}
    else:
        bounds = {"jax": _ulp_bound(JAX_BF16_ULPS),
                  "single": lambda want: BF16_REL * np.abs(want).max()}
    return QwenASREngine(cfg, device="cpu"), JaxEngine(cfg), bounds


@pytest.fixture(scope="module")
def tiny_engine(tiny_dir):
    return QwenASREngine(_engine_config("tiny-f32", tiny_dir, None), device="cpu")


def _cohort_prompts(cb) -> list:
    """[(ids, audio_mask, audio_embd)] of the four lanes: a 2 s chunk-0
    prompt and the second chunk of a 3.5 s input (carrying chunk 0's audio
    feature and 5 tokens), both built by the batcher; 3 text tokens around 2
    audio slots; and a lane of exactly `t_pad` tokens, 40 of them audio."""
    eng = cb.engine
    d = eng.dec_cfg.hidden_size
    first = _Request(audio=_audio(2.0, 330.0), context="", language="English",
                     temperature=0.0)
    second = _Request(audio=_audio(3.5, 550.0), context="", language="English",
                      temperature=0.0, n_chunks=2)
    chunk0 = cb._chunk_audio(second)
    cur0 = cb._encode([chunk0])[0]
    second.mem_feature = cur0[: eng.encoder.valid_tokens(len(chunk0))]
    second.mem_tokens = [11, 12, 13, 14, 15]
    second.chunk_idx = 1
    built = []
    for req in (first, second):
        chunk = cb._chunk_audio(req)
        built.append(cb._build_admission(req, chunk, cb._encode([chunk])[0]))
    rng = np.random.default_rng(8)
    dtype = built[0][2].dtype
    few = (np.array([1, 2, 0, 0, 3]), np.array([False, False, True, True, False]),
           torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32) * 0.1).to(dtype))
    t_pad = G.prompt_bucket(max(len(ids) for ids, _, _ in built))
    ids = rng.integers(1, 60, t_pad)
    mask = np.zeros(t_pad, bool)
    mask[8:48] = True
    ids[mask] = 0
    full = (ids, mask, torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32)
                                        * 0.1).to(dtype))
    return [built[0], few, built[1], full]


def _stage(cb, prompts, monkeypatch):
    """`cb._stage_cohort` on requests whose prompts are `prompts` ->
    (cohort, the logits of its LM-head call)."""
    reqs = [_Request(audio=_audio(1.0, 440.0), context="", language="English",
                     temperature=0.0) for _ in prompts]
    by_req = {id(r): p for r, p in zip(reqs, prompts)}
    monkeypatch.setattr(cb, "_build_admission", lambda req, chunk, cur: by_req[id(req)])
    heads, inner = [], dec.lm_logits
    monkeypatch.setattr(dec, "lm_logits", lambda *a, **k: heads.append(inner(*a, **k))
                        or heads[-1])
    cohort = cb._stage_cohort(reqs)
    monkeypatch.setattr(dec, "lm_logits", inner)
    assert len(heads) == 1
    return cohort, heads[0]


def _padded(prompts, t_pad):
    """The JAX programs' inputs: ids and masks [P, t_pad], audio [P, Ta, D]
    zero-padded, lengths [P]."""
    p = len(prompts)
    ids = np.zeros((p, t_pad), np.int32)
    masks = np.zeros((p, t_pad), bool)
    a_pad = max(int(e.shape[0]) for _, _, e in prompts)
    audio = np.zeros((p, a_pad, prompts[0][2].shape[1]), np.float32)
    for i, (ids_i, mask_i, embd) in enumerate(prompts):
        ids[i, : len(ids_i)] = ids_i
        masks[i, : len(mask_i)] = mask_i
        audio[i, : embd.shape[0]] = embd.float().numpy()
    return ids, masks, audio, np.array([len(i) for i, _, _ in prompts], np.int32)


def _jax_logits(jax_engine, ids, masks, audio, lens, t_pad):
    """First-token logits of the JAX prefill body (`one` of `prefill_stage`,
    `prefill_one` of `prefill_batch`) vmapped over the lanes."""
    import jax

    from qwen3_asr_gguf_tpu.models import decoder as jdec

    cfg, kv = jax_engine.dec_cfg, jax_engine.generator.cache_dtype

    def one(params, i, m, a, n):
        embd = jdec.splice_prompt(params, i, m, a)
        hidden, _ = jdec.forward_prefill(params, cfg, embd, jdec.init_cache(cfg, t_pad, kv),
                                         length=n)
        last = jax.lax.dynamic_index_in_dim(hidden, n - 1, axis=0, keepdims=False)
        return jdec.lm_logits(params, last, cfg.lm_head_dim)

    run = jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, 0)))
    return np.asarray(run(jax_engine.generator.prefill_params, ids, masks, audio, lens),
                      np.float32)


def _kv_rows(cache, l, lane, n):
    """Layer l's K and V rows [0:n) of a lane as f32 numpy (dequantized
    from an int8 cache)."""
    out = []
    for name in ("k", "v"):
        x = np.asarray(cache[name][l][lane][:n], np.float32)
        if f"{name}_s" in cache:
            x = x * np.asarray(cache[f"{name}_s"][l][lane][:n], np.float32)[..., None]
        out.append(x)
    return out


def _close(got, want, bound, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=float(bound(want)), err_msg=what)


def _check_against(cache, logits, toks, ref_cache, ref_logits, ref_toks, lens, layers, bound):
    for lane, n in enumerate(lens):
        for l in range(layers):
            for name, got, want in zip("kv", _kv_rows(cache, l, lane, n),
                                       _kv_rows(ref_cache, l, lane, n)):
                _close(got, want, bound, f"lane {lane} layer {l} {name}")
    _close(logits, ref_logits, bound, "first-token logits")
    assert list(toks) == list(ref_toks) == list(ref_logits.argmax(-1))


def _torch_cache(cache) -> dict:
    return {name: [t.float().numpy() for t in ts] for name, ts in cache.items()}


def _jax_cache(cache) -> dict:
    return {name: [np.asarray(t, np.float32) for t in ts] for name, ts in cache.items()}


def test_staging_matches_the_jax_prefill_stage(engines, monkeypatch):
    """`_stage_cohort` against JAX `ContinuousBatcher._prefill_stage` on the
    same prompts: staged KV rows [0:len) of every lane and layer and the
    first-token logits within the engine's tolerance, greedy first tokens
    equal."""
    import jax
    import jax.numpy as jnp

    port, jax_engine, bounds = engines
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    try:
        prompts = _cohort_prompts(cb)
        cohort, logits = _stage(cb, prompts, monkeypatch)
    finally:
        cb.close()
    lens = [len(ids) for ids, _, _ in prompts]
    assert cohort.t_pad == lens[-1] == G.prompt_bucket(max(lens)) and min(lens) == 5
    ids, masks, audio, lens_np = _padded(prompts, cohort.t_pad)
    jcb = JaxBatcher(jax_engine, max_batch=4, block=4)
    try:
        p = len(prompts)
        staged, toks, _ = jcb._prefill_stage(
            jcb.params, jnp.asarray(ids), jnp.asarray(masks), jnp.asarray(audio),
            jnp.asarray(lens_np), jax.random.split(jax.random.key(0), p),
            jnp.full((p,), 1e-6, jnp.float32), jnp.ones((p,), bool), cohort.t_pad)
    finally:
        jcb.close()
    _check_against(_torch_cache(cohort.staged), logits.numpy(), cohort.toks.tolist(),
                   _jax_cache(staged), _jax_logits(jax_engine, ids, masks, audio, lens_np,
                                                   cohort.t_pad),
                   np.asarray(toks).tolist(), lens, port.dec_cfg.num_layers, bounds["jax"])


def test_batched_prefill_matches_the_jax_prefill_batch(engines):
    """`BatchedGenerator.prefill` against JAX `BatchedGenerator._prefill`
    (`prefill_batch`) on the same prompts: the row cache's [0:len) rows,
    the first-token logits and the greedy first tokens."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_gguf_tpu.models import decoder as jdec

    port, jax_engine, bounds = engines
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    try:
        prompts = _cohort_prompts(cb)
    finally:
        cb.close()
    gen = BatchedEngine(port, block=8).gen
    ids_list, masks_list, embds = zip(*prompts)
    caches, logits = gen.prefill(ids_list, masks_list, embds, rows=len(prompts))
    t_pad = G.prompt_bucket(max(len(i) for i in ids_list))
    ids, masks, audio, lens = _padded(prompts, t_pad)
    jgen = JaxBatchedEngine(jax_engine, block=8).gen
    p = len(prompts)
    jcaches = jax.jit(jax.vmap(lambda _: jdec.init_cache(jgen.cfg, jgen.n_ctx,
                                                         jgen.cache_dtype)))(jnp.arange(p))
    jcaches, toks, _ = jgen._prefill(
        jgen.params, jnp.asarray(ids), jnp.asarray(masks), jnp.asarray(audio),
        jnp.asarray(lens), jcaches, jax.vmap(jax.random.key)(jnp.arange(p, dtype=jnp.uint32)),
        jnp.float32(1e-6), True)
    _check_against(_torch_cache(caches), logits.numpy(), logits.argmax(-1).tolist(),
                   _jax_cache(jcaches), _jax_logits(jax_engine, ids, masks, audio, lens, t_pad),
                   np.asarray(toks).tolist(), list(lens), port.dec_cfg.num_layers,
                   bounds["jax"])


def _single_lanes(engine, prompts, kv_dtype):
    """The port's single-lane prefill of each prompt (`forward_prefill` at
    the prompt's own bucket, as the engine runs it) -> (caches, logits)."""
    gen = engine.generator
    params, cfg = gen.prefill_params, gen.step_cfg
    caches, logits = [], []
    for ids, mask, embd in prompts:
        n = len(ids)
        ids_p, mask_p = gen._padded_prompt(ids, mask, G.prompt_bucket(n))
        cache = dec.init_cache(cfg, G.prompt_bucket(n), kv_dtype, rows=1)
        lane = {name: [c[0] for c in cs] for name, cs in cache.items()}
        hidden, _ = dec.forward_prefill(params, cfg, dec.splice_prompt(params, ids_p, mask_p, embd),
                                        lane, length=n)
        caches.append(cache)
        logits.append(dec.lm_logits(params, hidden[n - 1], cfg.lm_head_dim))
    return caches, torch.stack(logits)


def test_cohort_equals_the_single_lane_prefill(engines):
    """Every lane of one cohort prefill against the port's single-lane
    prefill of its prompt (the lane-by-lane staging this replaces): KV rows
    [0:len) and logits within the engine's tolerance, argmax equal."""
    port, _, bounds = engines
    cb = ContinuousBatcher(port, max_batch=4, block=4)
    try:
        prompts = _cohort_prompts(cb)
    finally:
        cb.close()
    gen, kv = port.generator, cb.kv_dtype
    t_pad = G.prompt_bucket(max(len(ids) for ids, _, _ in prompts))
    cache = dec.init_cache(gen.step_cfg, t_pad, kv, rows=len(prompts))
    logits = G.prefill_cohort(gen.prefill_params, gen.step_cfg, prompts, cache, t_pad)
    singles, want = _single_lanes(port, prompts, kv)
    for lane, (ids, _, _) in enumerate(prompts):
        for l in range(gen.step_cfg.num_layers):
            for name, got, ref in zip("kv", _kv_rows(_torch_cache(cache), l, lane, len(ids)),
                                      _kv_rows(_torch_cache(singles[lane]), l, 0, len(ids))):
                _close(got, ref, bounds["single"], f"lane {lane} layer {l} {name}")
    _close(logits.numpy(), want.numpy(), bounds["single"], "first-token logits")
    assert logits.argmax(-1).tolist() == want.argmax(-1).tolist()


@pytest.mark.parametrize("per_group", [1, 3])
def test_lane_groups_are_bit_equal_to_one_group(tiny_engine, per_group, monkeypatch):
    """A score budget of `per_group` lanes splits the 4-lane cohort into
    several attention groups (counted: one attention call per group and
    layer); hidden rows and the cache equal the one-group pass bit for bit."""
    cb = ContinuousBatcher(tiny_engine, max_batch=4, block=4)
    try:
        prompts = _cohort_prompts(cb)
    finally:
        cb.close()
    gen = tiny_engine.generator
    cfg, params = gen.step_cfg, gen.prefill_params
    t_pad = G.prompt_bucket(max(len(ids) for ids, _, _ in prompts))
    ids, masks, embds = zip(*prompts)
    ids, masks = (torch.from_numpy(np.stack([np.pad(a, (0, t_pad - len(a))) for a in arrs]))
                  for arrs in (ids, masks))
    x = dec.splice_prompt(params, ids, masks,
                          torch.nn.utils.rnn.pad_sequence(embds, batch_first=True))
    lens = torch.tensor([len(ids) for ids, _, _ in prompts])

    def run():
        cache = dec.init_cache(cfg, t_pad, torch.float32, rows=len(prompts))
        return dec.forward_prefill_lanes(params, cfg, x, cache, lens)

    assert len(dec.lane_groups(len(prompts), cfg.num_heads, t_pad)) == 1
    want, want_cache = run()
    calls, inner = [], dec._gqa_attention
    monkeypatch.setattr(dec, "_gqa_attention", lambda q, *a: calls.append(q.shape[0])
                        or inner(q, *a))
    monkeypatch.setattr(dec, "PREFILL_SCORE_BYTES", per_group * cfg.num_heads * t_pad ** 2 * 4)
    groups = dec.lane_groups(len(prompts), cfg.num_heads, t_pad)
    got, got_cache = run()
    assert [g.stop - g.start for g in groups] == ([1, 1, 1, 1] if per_group == 1 else [3, 1])
    assert calls == [g.stop - g.start for g in groups] * cfg.num_layers
    assert torch.equal(got, want)
    for name in want_cache:
        assert all(torch.equal(a, b) for a, b in zip(got_cache[name], want_cache[name]))


def _counting(monkeypatch, names):
    """Record, in order, the calls of the decoder functions `names`."""
    seen = []
    for name in names:
        inner = getattr(dec, name)
        monkeypatch.setattr(dec, name, lambda *a, _n=name, _f=inner, **k: seen.append(_n)
                            or _f(*a, **k))
    return seen


def test_one_lanes_pass_and_one_head_per_cohort_and_batch(tiny_engine, monkeypatch):
    """Three requests staged as one cohort make one `forward_prefill_lanes`
    pass, no single-lane prefill and one `lm_logits` call; a batch of three
    prompts in `BatchedGenerator.generate` makes the same two calls before
    its first rows step."""
    names = ("forward_prefill", "forward_prefill_lanes", "lm_logits", "forward_step_rows")
    cb = ContinuousBatcher(tiny_engine, max_batch=4, block=4)
    try:
        reqs = [_Request(audio=_audio(s, f), context="", language="English", temperature=0.0)
                for s, f in ((2.0, 330.0), (1.0, 440.0), (1.5, 550.0))]
        seen = _counting(monkeypatch, names)
        cohort = cb._stage_cohort(reqs)
        assert seen == ["forward_prefill_lanes", "lm_logits"]
        assert cohort.staged["k"][0].shape[0] == 3 and cohort.toks.shape == (3,)
    finally:
        cb.close()
    be = BatchedEngine(tiny_engine, block=4)
    inputs = be.prompts([(_audio(s, f), "", "English") for s, f in ((2.0, 330.0), (1.0, 440.0),
                                                                   (1.5, 550.0))])
    seen.clear()
    rows = be.gen.generate(*inputs, temperature=0.0, max_new_tokens=4)
    assert seen[:3] == ["forward_prefill_lanes", "lm_logits", "forward_step_rows"]
    assert "forward_prefill" not in seen and seen.count("forward_prefill_lanes") == 1
    assert len(rows) == 3


def test_an_overflowing_prompt_fails_alone_in_its_cohort(tiny_engine):
    """Of a cohort of two, the request whose prompt exceeds n_ctx (a long
    context) fails with ValueError; the other stages as a cohort of one."""
    cb = ContinuousBatcher(tiny_engine, max_batch=4, block=4)
    try:
        long_ctx = _Request(audio=_audio(1.0, 330.0), context="word " * 600, language="English",
                            temperature=0.0)
        ok = _Request(audio=_audio(1.0, 440.0), context="", language="English",
                      temperature=0.0)
        cohort = cb._stage_cohort([long_ctx, ok])
    finally:
        cb.close()
    assert isinstance(long_ctx.error, ValueError) and long_ctx.done_evt.is_set()
    assert ok.error is None and not ok.done_evt.is_set()
    assert len(cohort.reqs) == 1 and cohort.reqs[0] is ok and cohort.staged["k"][0].shape[0] == 1
    assert cohort.t_pad == G.prompt_bucket(cohort.lens[0])
