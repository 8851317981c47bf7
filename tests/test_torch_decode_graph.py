"""The decode step replayed as a CUDA graph (`runtime/generate.py`).

On the CPU: the one step body (`Generator._step`: the step index, the
token, the position and the latches in device buffers, updated in place)
against the Python-indexed loop it replaced; the cache pool; the sampler's
device temperature against the float one; the launch tally of a capture.

On the card (marked `cuda`, skipped elsewhere; no JAX import, so
`python -m pytest tests/test_torch_decode_graph.py -m cuda --noconftest -q`
runs there): graph against eager (`cuda_graphs=False`) bit for bit on
random int4 weights at the 0.6B widths, over two blocks at two window
buckets, greedy and at 0.4 and 1.0, with an EOS sampled mid-block and with a
tripped repetition latch; a re-seeded state, the captures of a second pass,
the launch counts of replays, the int8 KV cache and the fused int8 MLP.
"""

import copy
import dataclasses
import gc

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.models import params as P
from qwen3_asr_gguf_tpu_torch.models.configs import TextDecoderConfig
from qwen3_asr_gguf_tpu_torch.ops import _build, sampling
from qwen3_asr_gguf_tpu_torch.runtime.generate import (
    REP_DISTINCT, REP_WINDOW, CachePool, Generator, PooledCache, StepBuffers, round_up)
from qwen3_asr_gguf_tpu_torch.utils import profiling

TINY = TextDecoderConfig(vocab_size=512, hidden_size=48, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=16, intermediate_size=96)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _python_indexed_block(gen, state, temperature, generator):
    """The block loop before the step body: the host's step index `i`
    writes `emitted[i]` and gates the repetition latch; every step runs.
    -> (emitted, done, aborted, pos, tok)."""
    win = round_up(state.pos_bound + gen.block, 256)
    tok, pos, done = state.last_token, state.pos, state.done
    aborted = torch.zeros(1, dtype=torch.bool)
    emitted = torch.full((gen.block,), -1, dtype=torch.int64)
    for i in range(gen.block):
        hidden, _ = dec.forward_step_layers(
            gen.layers_list, gen.params["final_norm"], gen.step_cfg,
            gen.params["embed"].index_select(0, tok)[0], state.cache, pos, attn_window=win)
        logits = dec.lm_logits(gen.params, hidden, gen.cfg.lm_head_dim)
        nxt = sampling.sample(logits, generator, temperature).view(1).to(torch.int64)
        live = ~done
        emitted[i: i + 1] = torch.where(live, tok, -1)
        stop = gen._is_eos(nxt)
        if gen.block > REP_WINDOW and i >= REP_WINDOW:
            win_toks = emitted[i - REP_WINDOW + 1: i + 1]
            eq = win_toks[:, None] == win_toks[None, :]
            first = torch.tril(eq, diagonal=-1).sum(1) == 0
            distinct = (first & (win_toks >= 0)).sum()
            rep = live & (distinct <= REP_DISTINCT)
            aborted = aborted | rep
            stop = stop | rep
        tok = torch.where(live, nxt, tok)
        pos = pos + live.to(torch.int32)
        done = done | stop
    return emitted, done, aborted, pos, tok


def _tiny_generator(cfg=TINY, **kw):
    params = P.from_jax_params(np_init_like(dec.init_shapes(TINY), 0))
    return Generator(P.fuse_layer_weights(params), cfg, n_ctx=256, cache_dtype=torch.float32,
                     device="cpu", **kw)


def _start(gen, n: int, temperature: float, seed: int):
    ids = np.random.default_rng(seed).integers(1, TINY.vocab_size, size=n).astype(np.int32)
    return gen.start_spliced(ids, np.zeros(n, bool), torch.zeros(1, TINY.hidden_size),
                             temperature=temperature, seed=seed)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", ["plain", "rep_trip", "eos"])
@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_step_body_equals_the_python_indexed_loop(case, temperature):
    """Two blocks of 24 steps (every step queued: `early_exit` off) give
    the loop's emitted tokens, latches, aborts, position and token, bit for
    bit. `rep_trip`: a head of three classes, so the repetition latch trips
    at step 16; `eos`: a token the loop feeds at step 6 or later, unseen
    before, is made the EOS id."""
    cfg = dataclasses.replace(TINY, classify_num=3) if case == "rep_trip" else TINY
    eos_ids = ()
    if case == "eos":
        probe = _tiny_generator(eos_ids=(), block=24)
        st = _start(probe, 20, temperature, 3)
        stream = _python_indexed_block(probe, st, temperature, st.generator)[0].tolist()
        j = next(j for j in range(6, len(stream)) if stream[j] not in stream[:j])
        eos_ids = (stream[j],)
    gen = _tiny_generator(cfg, eos_ids=eos_ids, block=24)
    gen.early_exit = False
    st = _start(gen, 20, temperature, 3)
    ref = dataclasses.replace(st, cache=copy.deepcopy(st.cache))
    g_ref = torch.Generator().set_state(st.generator.get_state())
    blocks = []
    for _ in range(2):
        emitted, done, aborted, pos, tok = _python_indexed_block(gen, ref, temperature, g_ref)
        st, packed = gen.decode_block_dispatch(st, temperature)
        assert torch.equal(packed.dev, torch.cat([emitted, done.long(), aborted.long()]))
        assert torch.equal(st.pos, pos) and torch.equal(st.last_token, tok)
        assert torch.equal(st.done, done)
        ref = dataclasses.replace(ref, pos=pos, last_token=tok, done=done,
                                  pos_bound=ref.pos_bound + gen.block)
        blocks.append(packed.dev)
    first, second = blocks
    if case == "rep_trip":  # latched at the 16th step; the next block holds the latch
        assert first[-1] == 1 and first[-2] == 1
        assert (first[:16] >= 0).all() and (first[16:-2] == -1).all()
        assert (second[:-2] == -1).all() and second[-2] == 1 and second[-1] == 0
    if case == "eos":
        assert bool(done) and not bool(first[-1])
    assert torch.equal(st.generator.get_state(), g_ref.get_state())


def test_step_body_reads_the_step_index_on_the_device():
    """`_step` on buffers started mid-block (step index 15, the latch's
    first step) writes slot 15, gates the repetition latch there and moves
    the index, the position and the token in place."""
    gen = _tiny_generator(dataclasses.replace(TINY, classify_num=1), eos_ids=(), block=24)
    st = _start(gen, 10, 0.0, 1)
    b = StepBuffers.empty(gen.block, "cpu")
    b.load(st)
    b.emitted[:15] = 0  # one distinct token so far
    b.step.fill_(15)
    tok0, pos0 = int(b.tok), int(b.pos)
    gen._step(b, st.cache, 256, 0.0, st.generator)
    assert int(b.step) == 16 and int(b.pos) == pos0 + 1 and int(b.emitted[15]) == tok0
    assert bool(b.aborted) and bool(b.done) and int(b.tok) == 0  # one class: token 0
    assert (b.emitted[16:] == -1).all()


def test_cache_pool_hands_out_a_slot_once_and_takes_it_back():
    made = []

    def make():
        made.append({"k": [torch.zeros(4)], "v": [torch.zeros(4)]})
        return made[-1]

    pool = CachePool(make)
    a = pool.take()
    b = pool.take()
    assert isinstance(a, PooledCache) and (a.slot, b.slot) == (0, 1) and pool.size == 2
    a["k"][0].fill_(3.0)
    keep = a
    del a
    gc.collect()
    c = pool.take()  # slot 0 is still held through `keep`
    assert c.slot == 2 and pool.size == 3
    del keep, c
    gc.collect()
    d = pool.take()  # slots 0 and 2 are free again: the lowest first
    e = pool.take()
    assert (d.slot, e.slot) == (0, 2) and pool.size == 3
    del e
    assert float(d["k"][0].abs().sum()) == 0.0  # handed out zeroed, as a fresh cache
    assert d["k"][0] is made[0]["k"][0]  # the slot's own tensors
    assert pool.owns(d) and not pool.owns(copy.deepcopy(d)) and not pool.owns(dict(d))
    assert not CachePool(make).owns(d)  # another pool's slot 0


def test_graphs_stay_off_on_the_cpu():
    gen = _tiny_generator(eos_ids=(), block=8, cuda_graphs=True)
    assert not gen.cuda_graphs and gen.cache_pool is None
    cache = gen.new_cache()
    assert not isinstance(cache, PooledCache) and cache["k"][0].shape[0] == 256


@pytest.mark.parametrize("temperature", [0.05, 0.4, 0.7, 1.0, 1.3])
def test_sampling_with_a_tensor_temperature_equals_the_float(temperature):
    """The [1] f32 temperature a graph reads draws what the float draws,
    from the same generator state: 200 draws over fresh logits."""
    g_f, g_t = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    t = torch.tensor([temperature], dtype=torch.float32)
    x = torch.Generator().manual_seed(int(temperature * 100))
    for _ in range(200):
        logits = torch.randn(1000, generator=x) * 3.0
        assert int(sampling.sample(logits, g_f, temperature)) == int(
            sampling.sample(logits, g_t, t))
    assert torch.equal(g_f.get_state(), g_t.get_state())
    vals = torch.randn(1, 50, generator=x)
    assert torch.equal(sampling._scaled_as_float(vals, t), vals / max(temperature, 1e-6))


def test_sampling_with_a_tensor_temperature_never_goes_greedy():
    """A tensor temperature takes the chain even at 0 (clamped to 1e-6,
    which all but picks the argmax); the host picks greedy by the float."""
    logits = torch.randn(300, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    tok = sampling.sample(logits, g, torch.zeros(1))
    assert int(tok) == int(torch.argmax(logits))
    assert not torch.equal(g.get_state(), before)  # it drew
    assert int(sampling.sample(logits, g, 0.0)) == int(torch.argmax(logits))


def test_capture_tally_counts_launches_at_replay():
    def wrapper():
        _build.count_launch(wrapper)

    wrapper.launches = 0
    wrapper()
    with _build.capture_tally() as tally:
        wrapper()
        wrapper()
    assert wrapper.launches == 1 and tally == {wrapper: 2}
    for _ in range(3):
        _build.add_launches(tally)
    assert wrapper.launches == 7
    wrapper()
    assert wrapper.launches == 8


def test_profiler_active_inside_a_session():
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.profiler_active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.profiler_active() and profiling.is_recording()
    assert not profiling.profiler_active()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

WIDTHS_0P6B = TextDecoderConfig(vocab_size=151936, hidden_size=1024, num_layers=4, num_heads=16,
                                num_kv_heads=8, head_dim=128, intermediate_size=3072)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _int4_params(cfg, device, seed: int = 0) -> dict:
    """Random int4 (q4_k, matvec layout) decoder weights at `cfg`'s widths,
    fused as the engine fuses them; bf16 embed, f32 norms, the head padded to
    1024-row multiples as the loader pads it."""
    from qwen3_asr_gguf_tpu_torch.formats import quants as q
    from qwen3_asr_gguf_tpu_torch.ops import q4k

    rng = np.random.default_rng(seed)

    def dense(n, k):
        return (rng.standard_normal((n, k)) * 0.02).astype(np.float32)

    def w(n, k, multiple=512):
        parts = q4k.pad_rows(*q4k.pack_q4k_mxu(q.pack_q4_direct(dense(n, k))), multiple=multiple)
        return q4k.Q4KWeight.from_numpy(*parts, device=device)

    d, hd, m = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    ones = torch.ones(d, device=device)
    layers = [{
        "attn_norm": ones, "mlp_norm": ones,
        "q_norm": torch.ones(hd, device=device), "k_norm": torch.ones(hd, device=device),
        "qkv_proj": w((cfg.num_heads + 2 * cfg.num_kv_heads) * hd, d),
        "o_proj": w(d, cfg.num_heads * hd), "gateup_proj": w(2 * m, d), "down_proj": w(d, m),
    } for _ in range(cfg.num_layers)]
    return {"embed": torch.from_numpy(dense(cfg.vocab_size, d)).to(device, torch.bfloat16),
            "layers": layers, "final_norm": ones,
            "lm_head": w(cfg.vocab_size, d, multiple=1024)}


def _card_generator(params, cfg, device, graphs: bool, **kw):
    """A 32-step Generator on the card; no EOS id unless given (a random
    head may sample the real ones)."""
    kw = {"cache_dtype": torch.bfloat16, "block": 32, "eos_ids": (), "dequant_prefill": True,
          **kw}
    return Generator(params, cfg, n_ctx=1024, device=device, cuda_graphs=graphs, **kw)


def _card_start(gen, n: int, temperature: float, seed: int):
    ids = np.random.default_rng(seed).integers(1, gen.cfg.vocab_size, size=n).astype(np.int32)
    audio = torch.zeros(1, gen.cfg.hidden_size, device=gen.device, dtype=torch.bfloat16)
    return gen.start_spliced(ids, np.zeros(n, bool), audio, temperature=temperature, seed=seed)


def _blocks(gen, st, temperature: float, n: int = 2) -> list:
    """n consecutive blocks from `st` -> [(packed, pos, done, last_token)]."""
    out = []
    for _ in range(n):
        st, packed = gen.decode_block_dispatch(st, temperature)
        out.append((packed.fetch().copy(), int(st.pos), bool(st.done), int(st.last_token)))
    return out


def _same(a: list, b: list) -> bool:
    """Two `_blocks` results bit for bit."""
    return len(a) == len(b) and all(np.array_equal(x[0], y[0]) and x[1:] == y[1:]
                                    for x, y in zip(a, b))


def _counter(name: str) -> int:
    return profiling.TRACER.counters.get(name, 0)


# prompt lengths whose decode windows are the 256- and the 512-slot buckets
PROMPTS = (60, 300)


def _pass(gen, temperatures, seed: int = 5) -> dict:
    got = {}
    for n in PROMPTS:
        for t in temperatures:
            got[n, t] = _blocks(gen, _card_start(gen, n, t, seed + n), t)
            gc.collect()  # the states' caches back to the pool
    return got


@pytest.mark.cuda
def test_graph_blocks_equal_eager_bit_for_bit(cuda):
    """Greedy, 0.4 and 1.0 (the graph of 0.4) over two blocks at two window
    buckets: `packed`, pos, done and the token are the eager path's; 1.0
    adds no capture to 0.4's, a second pass none at all, and the pool holds
    one cache at a time."""
    cfg = WIDTHS_0P6B
    params = _int4_params(cfg, cuda)
    eager = _card_generator(params, cfg, cuda, graphs=False)
    graph = _card_generator(params, cfg, cuda, graphs=True)
    assert graph.cuda_graphs and not eager.cuda_graphs
    temps = (0.0, 0.4, 1.0)
    want = _pass(eager, temps)
    c0, r0 = _counter("decode.graph_captures"), _counter("decode.graph_replays")
    s0 = _counter("decode.steps")
    got = _pass(graph, temps)
    assert got.keys() == want.keys()
    for key in want:
        assert _same(got[key], want[key]), key
    captures = _counter("decode.graph_captures") - c0
    assert captures == len(PROMPTS) * 2  # greedy and not, at each window
    # every step queued but the first of each key (greedy blocks stop at their latch)
    assert _counter("decode.graph_replays") - r0 == _counter("decode.steps") - s0 - captures
    assert graph.cache_pool.size == 1
    c1 = _counter("decode.graph_captures")
    again = _pass(graph, temps)
    assert all(_same(again[key], got[key]) for key in got)
    assert _counter("decode.graph_captures") == c1


@pytest.mark.cuda
def test_graph_replays_count_the_kernels_launches(cuda):
    """A replayed block adds its kernels' launches per step, as eager steps
    do: kernels 1 and 2 and the decode attention, per layer and the head."""
    from qwen3_asr_gguf_tpu_torch.ops import attn, q4k

    cfg = WIDTHS_0P6B
    gen = _card_generator(_int4_params(cfg, cuda, 1), cfg, cuda, graphs=True)
    st = _card_start(gen, 60, 0.4, 2)
    names = (q4k.q4k_matvec, q4k.q4k_matvec_normed, attn.gqa_decode_attention)
    before = [w.launches for w in names]
    steps0 = _counter("decode.steps")
    _blocks(gen, st, 0.4)
    torch.cuda.synchronize()
    steps = _counter("decode.steps") - steps0
    per_step = (2 * cfg.num_layers + 1, 2 * cfg.num_layers, cfg.num_layers)
    assert steps == 2 * gen.block
    assert [w.launches - b for w, b in zip(names, before)] == [n * steps for n in per_step]


@pytest.mark.cuda
def test_graph_eos_mid_block_and_early_exit(cuda):
    """An EOS id the stream samples mid-block: both paths latch there, emit
    -1 after, and the block queued behind holds the latch; the graph host
    stops queueing once it sees the latch, with no more than the lag past
    the card."""
    cfg = WIDTHS_0P6B
    params = _int4_params(cfg, cuda, 2)
    probe = _card_generator(params, cfg, cuda, graphs=False, eos_ids=())
    stream = _blocks(probe, _card_start(probe, 60, 0.4, 9), 0.4, 1)[0][0][:-2].tolist()
    j = next(j for j in range(5, len(stream) - 4) if stream[j] not in stream[:j])
    runs = []
    for graphs in (False, True):
        gen = _card_generator(params, cfg, cuda, graphs=graphs, eos_ids=(stream[j],))
        steps0 = _counter("decode.steps")
        runs.append(_blocks(gen, _card_start(gen, 60, 0.4, 9), 0.4))
        runs[-1].append(_counter("decode.steps") - steps0)
    (e1, e2, _), (g1, g2, g_steps) = runs
    assert _same([e1, e2], [g1, g2])
    assert g1[0][:j].tolist() == stream[:j] and (g1[0][j:-2] == -1).all() and g1[0][-2] == 1
    assert (g2[0][:-2] == -1).all() and g2[1] == g1[1]
    assert g_steps < 2 * 32  # the host stopped queueing


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_graph_repetition_latch(cuda, temperature):
    """A head of three classes trips the repetition latch at step 16 on both
    paths, with the same packed result."""
    cfg = dataclasses.replace(WIDTHS_0P6B, classify_num=3)
    params = _int4_params(WIDTHS_0P6B, cuda, 3)
    outs = []
    for graphs in (False, True):
        gen = _card_generator(params, cfg, cuda, graphs=graphs)
        outs.append(_blocks(gen, _card_start(gen, 60, temperature, 4), temperature))
    assert _same(*outs)
    first = outs[1][0][0]
    assert first[-1] == 1 and first[-2] == 1 and (first[:16] >= 0).all()
    assert (first[16:-2] == -1).all()


@pytest.mark.cuda
def test_a_reseeded_state_replays_the_eager_draws(cuda):
    """Two states from the same seed on the graph path, and one on the
    eager path: the same draws, and the first token (sampled eagerly) with
    them."""
    cfg = WIDTHS_0P6B
    params = _int4_params(cfg, cuda, 4)
    graph = _card_generator(params, cfg, cuda, graphs=True)
    eager = _card_generator(params, cfg, cuda, graphs=False)
    a = _blocks(graph, _card_start(graph, 60, 0.4, 21), 0.4)
    gc.collect()
    b = _blocks(graph, _card_start(graph, 60, 0.4, 21), 0.4)
    c = _blocks(eager, _card_start(eager, 60, 0.4, 21), 0.4)
    assert _same(a, b) and _same(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8_kv", "fused_mlp"])
def test_graph_captures_the_other_steps(cuda, variant):
    """The int8-KV step (plain attention on a dequantized window) and the
    fused int8 MLP (a cooperative launch) capture, and replay bit-equal to
    eager."""
    from qwen3_asr_gguf_tpu_torch.ops import mlp
    from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq

    cfg = dataclasses.replace(WIDTHS_0P6B, vocab_size=8192)
    if variant == "int8_kv":
        params, kw = _int4_params(cfg, cuda, 5), {"cache_dtype": torch.int8}
    else:
        dense = P.from_jax_params(np_init_like(dec.init_shapes(cfg), 5), device=cuda)
        dense["layers"] = [{k: (tq.to_int8(v) if v.ndim == 2 else v) for k, v in layer.items()}
                           for layer in dense["layers"]]
        dense["lm_head"] = tq.to_int8(dense["lm_head"])
        dense["embed"] = dense["embed"].to(torch.bfloat16)
        params, kw = P.fuse_layer_weights(dense), {"dequant_prefill": False}
    outs, fused = [], []
    for graphs in (False, True):
        gen = _card_generator(params, cfg, cuda, graphs=graphs, **kw)
        fused.append(gen.fused_mlp)
        launches = mlp.fused_mlp_matvec.launches
        outs.append(_blocks(gen, _card_start(gen, 60, 0.4, 6), 0.4))
        fused.append(mlp.fused_mlp_matvec.launches - launches)
    assert _same(*outs)
    if variant == "fused_mlp":
        assert fused == [True, cfg.num_layers * 64, True, cfg.num_layers * 64]


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.05, 0.4, 0.7, 1.0, 1.3])
def test_card_tensor_temperature_draws_equal_the_float(cuda, temperature):
    """On the card the device temperature scales the top 50 to the float's
    bits (PyTorch divides by a host scalar through its reciprocal there) and
    draws the same tokens from the same generator state."""
    g_f = torch.Generator(device=cuda).manual_seed(7)
    g_t = torch.Generator(device=cuda).manual_seed(7)
    t = torch.tensor([temperature], dtype=torch.float32, device=cuda)
    x = torch.Generator(device=cuda).manual_seed(int(temperature * 100))
    for _ in range(100):
        logits = torch.randn(151936, generator=x, device=cuda) * 3.0
        vals = torch.topk(logits, 50).values[None]
        assert torch.equal(sampling._scaled_as_float(vals, t), vals / max(temperature, 1e-6))
        assert torch.equal(sampling.sample(logits, g_f, temperature),
                           sampling.sample(logits, g_t, t))
    assert torch.equal(g_f.get_state(), g_t.get_state())


@pytest.mark.cuda
def test_graph_path_is_sync_free(cuda):
    """Once captured, a replayed block queues nothing that waits for the
    card (`torch.cuda.set_sync_debug_mode("error")`), its lag wait
    included."""
    cfg = WIDTHS_0P6B
    gen = _card_generator(_int4_params(cfg, cuda, 6), cfg, cuda, graphs=True)
    _blocks(gen, _card_start(gen, 60, 0.4, 1), 0.4, 1)
    gc.collect()
    st = _card_start(gen, 60, 0.4, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st2, packed = gen.decode_block_dispatch(st, 0.4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(gen.collect_block(packed)[0]) == gen.block
