"""`qwen3_asr_gguf_tpu_torch.parallel` on the CPU: Megatron tiles, the
tensor-parallel Generator, the tile check, sequence-parallel encode, the
TP batcher and the dry run, in gloo worlds of spawned ranks
(`parallel.launch.spawn`, a `file://` rendezvous under each test's
tmp_path). Bounds: tiles dequantize bit-equal to the dense slice; greedy
tokens exact; SP encode within atol 2e-5, rtol 1e-4 (the JAX dry run's)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu_torch.formats import quants as q
from qwen3_asr_gguf_tpu_torch.models import configs as tconfigs
from qwen3_asr_gguf_tpu_torch.ops import q4k
from qwen3_asr_gguf_tpu_torch.ops.qtensor import (Int8Weight, Q4Weight, dequant_int8,
                                                  dequant_q4, to_int8)
from qwen3_asr_gguf_tpu_torch.parallel import dryrun as D
from qwen3_asr_gguf_tpu_torch.parallel import launch
from qwen3_asr_gguf_tpu_torch.parallel import sharding as S

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def world_of_one(tmp_path):
    """An initialised gloo world of this one process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'world1'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _spawn(tmp_path, fn, world, *args):
    return launch.spawn(fn, world, init_file=str(tmp_path / "rendezvous"), args=args)


# -- tiles ---------------------------------------------------------------------


def _weights(kind: str, n: int, k: int):
    """(container, its dense f32 value) of a seeded [n, k] weight."""
    w = (np.random.default_rng(n * 7 + k).standard_normal((n, k)) * 0.1).astype(np.float32)
    if kind == "dense":
        t = torch.from_numpy(w)
        return t, t
    if kind == "int8":
        c = to_int8(torch.from_numpy(w))
        return c, dequant_int8(c, torch.float32)
    if kind == "q4":
        c = Q4Weight.from_packed(q.pack_q4_direct(w))
        return c, dequant_q4(c, torch.float32)
    c = q4k.Q4KWeight.from_numpy(*q4k.pack_q4k_mxu(q.pack_q4_direct(w)))
    return c, q4k.dequant_mxu(c, torch.float32)


def _dequant(c):
    if isinstance(c, q4k.Q4KWeight):
        return q4k.dequant_mxu(c, torch.float32)
    if isinstance(c, Q4Weight):
        return dequant_q4(c, torch.float32)
    if isinstance(c, Int8Weight):
        return dequant_int8(c, torch.float32)
    return c


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("spec", [("model", None), (None, "model")], ids=["column", "row"])
@pytest.mark.parametrize("kind", ["dense", "int8", "q4", "q4k"])
def test_local_tile_dequantizes_to_the_dense_slice(kind, spec, tp):
    """Every rank's tile of every container equals the same slice of the
    dense weight bit for bit (a `Q4Weight` K split repacks its nibbles at
    the local K; a `Q4KWeight`'s K split takes whole superblocks)."""
    n, k = 1024, 2048
    w, dense = _weights(kind, n, k)
    axis = spec.index("model")
    for r in range(tp):
        tile = S.split_leaf(w, spec, r, tp)
        want = dense.narrow(axis, r * dense.shape[axis] // tp, dense.shape[axis] // tp)
        assert torch.equal(_dequant(tile), want), (kind, spec, r)
    if kind == "q4" and axis == 1:  # the repack is not a column slice of `packed`
        tile = S.split_leaf(w, spec, 1, tp)
        assert not torch.equal(tile.packed, w.packed[:, k // (2 * tp): k // tp])


@pytest.mark.parametrize("tp", [2, 4])
def test_decoder_specs_cut_every_leaf(tp):
    """The spec table covers every decoder leaf: column weights split N,
    row weights K, norms and the embed stay whole (shared, not copied), the
    padded head splits into whole 2*BN-row vocab tiles."""
    cfg = dataclasses.replace(D.toy_config(tp).text)
    params = D.decoder_weights("f32", cfg, 0)
    params["lm_head"] = S.pad_head(params["lm_head"], tp)
    local = S.shard_tree(params, S.decoder_param_specs(cfg), 1, tp)
    layer, whole = local["layers"][0], params["layers"][0]
    assert layer["q_proj"].shape == (whole["q_proj"].shape[0] // tp, whole["q_proj"].shape[1])
    assert layer["down_proj"].shape == (whole["down_proj"].shape[0],
                                        whole["down_proj"].shape[1] // tp)
    assert layer["q_norm"] is whole["q_norm"] and local["embed"] is params["embed"]
    head = D.decoder_weights("int4", dataclasses.replace(cfg, vocab_size=1000,
                                                         hidden_size=512), 0)["lm_head"]
    padded = S.pad_head(head, tp)
    assert padded.shape[0] % (2 * q4k.BN * tp) == 0
    assert torch.equal(q4k.dequant_mxu(padded, torch.float32)[head.shape[0]:],
                       torch.zeros(padded.shape[0] - head.shape[0], 512))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_cache_specs_give_the_local_cache(dtype):
    """A rank's tile of the whole KV cache under `decoder_cache_specs` has
    the shapes of the cache `local_config` allocates (kv heads over tp)."""
    from qwen3_asr_gguf_tpu_torch.models import decoder as dec

    cfg = D.flagship_text(4096)
    whole = dec.init_cache(cfg, 256, dtype)
    local = dec.init_cache(S.local_config(cfg, 2), 256, dtype)
    tile = S.shard_tree(whole, S.decoder_cache_specs(cfg, dtype), 1, 2)
    assert tile.keys() == local.keys()
    for name in local:
        assert [t.shape for t in tile[name]] == [t.shape for t in local[name]]


def test_int4_tp_supported_agrees_with_the_jax_rule():
    from qwen3_asr_gguf_tpu.models import configs as jconfigs
    from qwen3_asr_gguf_tpu.parallel.sharding import int4_tp_supported as jax_rule

    grid = 0
    for name in ("qwen3-asr-1.7b", "qwen3-asr-0.6b", "tiny"):
        for heads, kv, inter in ((16, 8, 6144), (16, 16, 2048), (12, 4, 3072), (4, 2, 96)):
            for tp in (1, 2, 3, 4, 8):
                base = tconfigs.PRESETS[name].text
                tcfg = dataclasses.replace(base, num_heads=heads, num_kv_heads=kv,
                                           intermediate_size=inter)
                jcfg = jconfigs.TextDecoderConfig(**dataclasses.asdict(tcfg))
                assert S.int4_tp_supported(tcfg, tp) == jax_rule(jcfg, tp), (tcfg, tp)
                grid += 1
    assert grid == 60


def test_tile_check_refuses_dense_routes_on_the_card():
    """At tp = 4 the 1.7B k_proj / v_proj tiles are N = 256: no q4_k kernel
    takes them, and the check names the tile and the rule (the JAX rule
    passes that width). At tp = 2 every tile passes; on the CPU nothing is
    refused."""
    cfg = dataclasses.replace(D.flagship_text(4096), num_layers=1)
    assert S.int4_tp_supported(cfg, 4)
    params = D.decoder_weights("int4", dataclasses.replace(cfg, vocab_size=512), 0)
    for tp, fails in ((2, False), (4, True)):
        padded = dict(params, lm_head=S.pad_head(params["lm_head"], tp))
        local = S.shard_tree(padded, S.decoder_param_specs(cfg), 0, tp)
        S.check_local_tiles(local["layers"], local["lm_head"], "cpu")
        if fails:
            with pytest.raises(ValueError, match=r"layer 0 k_proj: local q4_k tile N=256 K=2048"):
                S.check_local_tiles(local["layers"], local["lm_head"], "cuda")
        else:
            S.check_local_tiles(local["layers"], local["lm_head"], "cuda")
    bad = Q4Weight(packed=torch.zeros(8, 16, dtype=torch.uint8), scale=torch.zeros(8, 1),
                   minv=torch.zeros(8, 1))  # K = 32: not whole 64-wide halves
    with pytest.raises(ValueError, match="lm_head: local int4 tile N=8 K=32"):
        S.check_local_tiles([], bad, "cuda")


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="torchrun"):
        S.make_mesh({"model": 2})


# -- decode ---------------------------------------------------------------------


def _jax_tokens(kind, cfg, seed, prompt_seed, n_audio=16, t=24):
    """The JAX package's single-device greedy tokens on the same weights."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_gguf_tpu.models.configs import TextDecoderConfig
    from qwen3_asr_gguf_tpu.ops.pallas_q4k import Q4KMXUWeight
    from qwen3_asr_gguf_tpu.runtime.generate import Generator
    from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
    from qwen3_asr_gguf_tpu_torch.models import decoder as tdec

    if kind == "int4":
        tree = D.int4_tree(cfg, seed)
        conv = lambda v: (Q4KMXUWeight(*(jnp.asarray(a) for a in v))  # noqa: E731
                          if isinstance(v, D.Q4KParts) else jnp.asarray(v))
        params = {k: ({n: conv(x) for n, x in v.items()} if k == "layers" else conv(v))
                  for k, v in tree.items()}
    else:
        params = jax.tree.map(jnp.asarray, np_init_like(tdec.init_shapes(cfg), seed))
    jcfg = TextDecoderConfig(**dataclasses.asdict(cfg))
    ids, mask, embd = D.spliced_prompt(cfg, prompt_seed, n_audio=n_audio, t=t)
    gen = Generator(params, jcfg, n_ctx=128, block=8, cache_dtype=jnp.float32)
    st = gen.start_spliced(ids.astype(np.int32), mask, jnp.asarray(embd.numpy()),
                           temperature=0.0, seed=5)
    toks, _, _ = gen.decode_block(st, temperature=0.0)
    return [int(x) for x in toks]


DECODE_CASES = {
    "toy-f32": ("f32", D.toy_config(2).text, 1, 1, 16, 24),
    "toy-int4": ("int4", dataclasses.replace(D.flagship_text(512), hidden_size=512, num_heads=16,
                                             num_kv_heads=16, intermediate_size=2048), 7, 8,
                 12, 20),
    "1.7b-heads-vocab4096-f32": ("f32", D.flagship_text(4096), 2, 3, 16, 24),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_tp_decode_equals_single_process_and_jax(case, tmp_path):
    """tp = 2 greedy tokens (both ranks, which emit the same) equal the
    port's single-process Generator and the JAX single-device Generator on
    the same weights; packed int4 tiles stay packed (no int8 remap)."""
    kind, cfg, seed, pseed, n_audio, t = DECODE_CASES[case]
    outs = _spawn(tmp_path, D.tp_tokens, 2, kind, cfg, seed, pseed, n_audio, t)
    single = D.generator_tokens(D.decoder_weights(kind, cfg, seed), cfg,
                                D.spliced_prompt(cfg, pseed, n_audio=n_audio, t=t))
    assert outs[0]["tokens"] == outs[1]["tokens"] == single and len(single) == 8
    assert single == _jax_tokens(kind, cfg, seed, pseed, n_audio, t)


def test_two_all_reduces_per_layer_and_one_gather(tmp_path):
    """Counted on the wrapped collectives of each rank: the prefill and each
    of the block's 8 decode steps run 2 all-reduces per layer (o_proj and
    down_proj) and one all-gather (the vocab tiles of the logits)."""
    cfg = D.toy_config(2).text
    outs = _spawn(tmp_path, D.tp_tokens, 2, "f32", cfg, 1, 1, 16, 24, True)
    passes = 1 + 8
    for o in outs:
        assert o["counts"] == {"all_reduce": 2 * cfg.num_layers * passes,
                               "all_gather": passes}


def test_cohort_prefill_two_all_reduces_per_layer_and_one_gather(tmp_path):
    """One cohort prefill of three lanes (`generate.prefill_cohort`) at tp =
    2, counted as above: two all-reduces per layer for the whole cohort and
    one all-gather for its first-token logits, which equal the
    single-process cohort's within atol = rtol = 1e-5 (f32; the partial
    products are summed in another order)."""
    cfg = D.toy_config(2).text
    outs = _spawn(tmp_path, D.tp_cohort, 2, cfg, 1, 1)
    single = D.cohort_logits(D.decoder_weights("f32", cfg, 1), cfg, 1)
    assert single.shape == (len(D.COHORT_LANES), cfg.vocab_size)
    for o in outs:
        assert o["counts"] == {"all_reduce": 2 * cfg.num_layers, "all_gather": 1}
        torch.testing.assert_close(o["logits"], single, atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_tp_decode_at_the_full_vocab(tmp_path):
    """The 1.7B decoder's shape at 2 layers with its 151,936-token vocab
    (the JAX dry run's check; heavy on the CPU, also run on the card)."""
    cfg = D.flagship_text()
    outs = _spawn(tmp_path, D.tp_tokens, 2, "f32", cfg, 2, 3)
    single = D.generator_tokens(D.decoder_weights("f32", cfg, 2), cfg, D.spliced_prompt(cfg, 3))
    assert outs[0]["tokens"] == outs[1]["tokens"] == single


# -- sequence-parallel encode ------------------------------------------------------


def _sp_world(rank, world, n_tokens):
    from qwen3_asr_gguf_tpu_torch.models import encoder as enc
    from qwen3_asr_gguf_tpu_torch.parallel import train as T

    cfg = dataclasses.replace(D.toy_config(2), audio=dataclasses.replace(
        D.toy_config(2).audio, attention_mode="windowed"))
    params = T.init_params(cfg, 4)["encoder"]
    hidden = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (n_tokens, cfg.audio.d_model)) * 0.1).astype(np.float32))
    S.make_mesh({"model": world})
    import torch.distributed as dist

    whole = enc.backend_transformer(params, cfg.audio, hidden)
    split = enc.backend_transformer(params, cfg.audio, hidden, sp_group=dist.group.WORLD)
    return whole, split


@pytest.mark.parametrize("n_tokens", [8 * 52, 5 * 52 + 17], ids=["8-windows", "tail"])
def test_sp_windowed_encode_equals_one_process(n_tokens, tmp_path):
    """Windows split over 2 ranks (a tail window with its key mask; a window
    count that does not split evenly pads whole masked windows)."""
    for whole, split in _spawn(tmp_path, _sp_world, 2, n_tokens):
        assert split.shape == whole.shape == (n_tokens, 32)
        torch.testing.assert_close(split, whole, atol=2e-5, rtol=1e-4)


# -- TP batcher and the dry run -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    d = str(tmp_path_factory.mktemp("tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16")
    return d


def _batcher_world(rank, world, model_dir, kv):
    return D.batcher_texts(model_dir, {"model": world}, kv_cache_dtype=kv)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tp_batcher_transcripts_equal_one_process(kv, tiny_dir, tmp_path):
    """Two greedy requests through the lockstep TP ContinuousBatcher at
    tp = 2 give the single-process batcher's transcripts (f32 engine; the
    int8 KV cache split on kv heads too)."""
    one = D.batcher_texts(tiny_dir, kv_cache_dtype=kv)
    got = _spawn(tmp_path, _batcher_world, 2, tiny_dir, kv)
    assert got[1] is None and got[0] == one and len(one) == 2


def test_dryrun_prints_its_summary_at_four_ranks():
    out = subprocess.run([sys.executable, "-m", "qwen3_asr_gguf_tpu_torch.parallel.dryrun", "4",
                          "--flag-vocab", "4096"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh(data=2, model=2), loss ")
    for part in ("TP infer == single-device (8 greedy tokens)",
                 "1.7B-shaped (16h/8kv/hd128/vocab4096, 2L) TP infer == single-device (8 tokens)",
                 "packed-int4 TP decode == single-device (8 tokens, no int8 remap)",
                 "sequence-parallel windowed encode == single-device (4 windows over model=2)",
                 "TP ContinuousBatcher rows decode == single-device (2 transcripts, tp=2)"):
        assert part in line
