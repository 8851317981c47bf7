"""Multi-rank self-check of `parallel/` (the twin of the JAX package's
`dryrun_multichip`, __graft_entry__.py:94-370):

    python -m qwen3_asr_gguf_tpu_torch.parallel.dryrun N [--flag-vocab V]

spawns N gloo ranks on the CPU (`launch.spawn`) on a ("data", "model") mesh
(data = 2 when N is even) and checks, as the JAX package's run does on N
virtual devices:

1. two train steps of `train.make_train_step`, the loss finite and falling;
2. tensor-parallel greedy tokens equal the single-process Generator's on a
   toy config (f32, spliced prompt);
3. the same on the 1.7B decoder's shape cut to 2 layers (16 heads, 8 kv
   heads, head_dim 128, the vocab 151,936 or `--flag-vocab`);
4. packed int4 (`Q4KWeight`) TP decode equals single-process, no int8 remap;
5. sequence-parallel windowed encode equals one process (atol 2e-5,
   rtol 1e-4);
6. the TP `ContinuousBatcher`'s greedy transcripts equal the single-process
   batcher's (a synthetic "tiny" checkpoint, f32, tp = 2);

and prints one summary line of the JAX run's form. Every rank checks its
own tokens, so the ranks' tokens are equal as well. The worker functions
here also serve the tests (`tests/test_torch_parallel.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ..models.configs import AudioEncoderConfig, TextDecoderConfig, ThinkerConfig


def toy_config(model: int) -> ThinkerConfig:
    """The dry run's toy thinker, sized by the model-parallel width."""
    return ThinkerConfig(
        audio=AudioEncoderConfig(
            num_mel_bins=128, d_model=8 * model, encoder_layers=2,
            encoder_attention_heads=model, encoder_ffn_dim=16 * model,
            downsample_hidden_size=16, output_dim=16 * model,
        ),
        text=TextDecoderConfig(
            vocab_size=64 * model, hidden_size=16 * model, num_layers=2,
            num_heads=2 * model, num_kv_heads=model, head_dim=16,
            intermediate_size=32 * model,
        ),
    )


def flagship_text(vocab: int = 151936, layers: int = 2) -> TextDecoderConfig:
    """The 1.7B decoder's widths and heads at a cut depth (and vocab)."""
    from ..models.configs import PRESETS

    return dataclasses.replace(PRESETS["qwen3-asr-1.7b"].text, num_layers=layers,
                               vocab_size=vocab)


def random_decoder(cfg: TextDecoderConfig, seed: int) -> dict:
    """Whole decoder weights N(0, 0.02) in f32 (norms 1), per-layer lists."""
    from ..export.synthetic import np_init_like
    from ..models import decoder as dec
    from ..models.params import from_jax_params

    return from_jax_params(np_init_like(dec.init_shapes(cfg), seed))


class Q4KParts(NamedTuple):
    """The numpy planes of a q4_k weight (`ops.q4k.Q4KWeight`'s fields)."""

    packed: np.ndarray
    sub_t: np.ndarray
    min_t: np.ndarray
    dd_t: np.ndarray


def int4_tree(cfg: TextDecoderConfig, seed: int) -> dict:
    """Packed int4 layer weights and head of N(0, 0.1) values quantized to
    q4_k, f32 embed, unit norms (the dry run's int4 model), as numpy with
    stacked layers: the layout both packages' weights are made from."""
    from ..formats import quants as q
    from ..ops.q4k import pack_q4k_mxu, pad_rows

    rng = np.random.default_rng(seed)
    d, hh = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv, m, n_l = cfg.num_kv_heads * cfg.head_dim, cfg.intermediate_size, cfg.num_layers

    def w4(n, k):
        return pack_q4k_mxu(q.pack_q4_direct((rng.standard_normal((n, k)) * 0.1)
                                              .astype(np.float32)))

    def stack(n, k):
        return Q4KParts(*(np.stack(f) for f in zip(*(w4(n, k) for _ in range(n_l)))))

    shapes = {"q_proj": (hh, d), "k_proj": (kv, d), "v_proj": (kv, d), "o_proj": (d, hh),
              "gate_proj": (m, d), "up_proj": (m, d), "down_proj": (d, m)}
    layers = {name: stack(*nk) for name, nk in shapes.items()}
    for name, n in (("attn_norm", d), ("mlp_norm", d), ("q_norm", cfg.head_dim),
                    ("k_norm", cfg.head_dim)):
        layers[name] = np.ones((n_l, n), np.float32)
    embed = (rng.standard_normal((cfg.vocab_size, d)) * 0.1).astype(np.float32)
    head = Q4KParts(*pad_rows(*w4(cfg.vocab_size, d)))
    return {"embed": embed, "layers": layers, "final_norm": np.ones(d, np.float32),
            "lm_head": head}


def decoder_weights(kind: str, cfg: TextDecoderConfig, seed: int) -> dict:
    """Whole port decoder weights: "f32" (`random_decoder`) or "int4"
    (`int4_tree`)."""
    from ..models.params import from_jax_params

    if kind == "int4":
        return from_jax_params(int4_tree(cfg, seed))
    return random_decoder(cfg, seed)


def spliced_prompt(cfg: TextDecoderConfig, seed: int, n_audio: int = 16, t: int = 24):
    """(ids, audio_mask, audio_embd): 4 text ids, `n_audio` audio slots, the
    rest text; audio embeddings N(0, 0.1)."""
    ids = np.zeros(t, np.int64)
    ids[:4] = [1, 2, 3, 4]
    ids[4 + n_audio:] = np.arange(5, 5 + t - 4 - n_audio)
    mask = np.zeros(t, bool)
    mask[4: 4 + n_audio] = True
    embd = (np.random.default_rng(seed).standard_normal((n_audio, cfg.hidden_size))
            * 0.1).astype(np.float32)
    return ids, mask, torch.from_numpy(embd)


def greedy_tokens(gen, prompt, seed: int = 5) -> list[int]:
    """One spliced prefill and one greedy decode block."""
    ids, mask, embd = prompt
    st = gen.start_spliced(ids, mask, embd.to(gen.device, gen.params["embed"].dtype),
                           temperature=0.0, seed=seed)
    toks, _, _, _ = gen.decode_block(st, temperature=0.0)
    return toks


def generator_tokens(params: dict, cfg: TextDecoderConfig, prompt, *, mesh=None,
                     device="cpu") -> list[int]:
    """Greedy tokens of an f32-cache Generator on `params` (cut into this
    rank's tiles under `mesh`); the tiles keep the containers' types (packed
    int4 stays packed)."""
    from ..runtime.generate import Generator

    gen = Generator(params, cfg, n_ctx=128, block=8, cache_dtype=torch.float32,
                    device=device, mesh=mesh)
    for name in ("q_proj", "down_proj"):
        assert type(gen.params["layers"][0][name]) is type(params["layers"][0][name])
    return greedy_tokens(gen, prompt)


@contextlib.contextmanager
def counting_collectives():
    """{"all_reduce": n, "all_gather": n}: the calls of those two
    `torch.distributed` functions inside the block (wrapped to count)."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    inner = {name: getattr(dist, name) for name in counts}
    for name, fn in inner.items():
        def counted(*a, _name=name, _fn=fn, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        setattr(dist, name, counted)
    try:
        yield counts
    finally:
        for name, fn in inner.items():
            setattr(dist, name, fn)


def tp_tokens(rank: int, world: int, kind: str, cfg: TextDecoderConfig, seed: int,
              prompt_seed: int, n_audio: int = 16, t: int = 24, count: bool = False) -> dict:
    """A rank of a tensor-parallel world (model = world): greedy tokens of
    the `decoder_weights(kind, cfg, seed)` decoder on `spliced_prompt`, and
    with `count` the collectives the prefill and decode block ran
    (`counting_collectives`)."""
    from . import sharding as S

    mesh = S.make_mesh({"model": world})
    prompt = spliced_prompt(cfg, prompt_seed, n_audio=n_audio, t=t)
    with counting_collectives() if count else contextlib.nullcontext(
            {"all_reduce": 0, "all_gather": 0}) as counts:
        toks = generator_tokens(decoder_weights(kind, cfg, seed), cfg, prompt, mesh=mesh)
    return {"tokens": toks, "counts": counts}


COHORT_LANES = ((16, 24), (3, 9), (30, 40))  # (audio slots, tokens) of each lane


def cohort_logits(params: dict, cfg: TextDecoderConfig, prompt_seed: int, *,
                  mesh=None) -> torch.Tensor:
    """First-token logits of one cohort prefill (`generate.prefill_cohort`)
    of `spliced_prompt`s of COHORT_LANES' lengths, on an f32 Generator's
    prefill weights (this rank's tiles under `mesh`)."""
    from ..models import decoder as dec
    from ..runtime.generate import Generator, prefill_cohort, prompt_bucket

    gen = Generator(params, cfg, n_ctx=128, block=8, cache_dtype=torch.float32, device="cpu",
                    mesh=mesh)
    prompts = [spliced_prompt(cfg, prompt_seed + i, n_audio=n, t=t)
               for i, (n, t) in enumerate(COHORT_LANES)]
    t_pad = prompt_bucket(max(t for _, t in COHORT_LANES))
    cache = dec.init_cache(gen.step_cfg, t_pad, torch.float32, rows=len(prompts))
    return prefill_cohort(gen.prefill_params, gen.step_cfg, prompts, cache, t_pad,
                          tp_group=gen.tp_group)


def tp_cohort(rank: int, world: int, cfg: TextDecoderConfig, seed: int,
              prompt_seed: int) -> dict:
    """A rank of a tensor-parallel world (model = world): `cohort_logits` of
    the f32 decoder on its tiles, and the collectives that one cohort
    prefill ran (`counting_collectives`)."""
    from . import sharding as S

    mesh = S.make_mesh({"model": world})
    params = decoder_weights("f32", cfg, seed)
    with counting_collectives() as counts:
        logits = cohort_logits(params, cfg, prompt_seed, mesh=mesh)
    return {"logits": logits, "counts": counts}


def batcher_texts(model_dir: str, mesh_shape=None, kv_cache_dtype: str = "bf16"
                  ) -> list[str] | None:
    """Greedy transcripts of two 1 s tones through a `ContinuousBatcher` on
    an f32 engine of the "tiny" checkpoint in `model_dir` (tensor-parallel
    with `mesh_shape`); None on the ranks other than 0, which follow rank
    0's plans until it closes."""
    from ..runtime.continuous import ContinuousBatcher
    from ..runtime.engine import QwenASREngine
    from ..schema import ASREngineConfig

    eng = QwenASREngine(ASREngineConfig(
        model_dir=model_dir, llm_fn="qwen3_asr_llm.f16.gguf", precision="f32", chunk_size=2.0,
        n_ctx=256, verbose=False, max_new_tokens=8, decode_block=8, mesh_shape=mesh_shape,
        kv_cache_dtype=kv_cache_dtype), device="cpu")
    cb = ContinuousBatcher(eng, max_batch=4, block=8, max_new_tokens=8)
    if not cb.leader:
        cb.follow()
        return None
    try:
        t_ax = np.arange(16000) / 16000
        auds = [(np.sin(2 * np.pi * f * t_ax) * 0.3).astype(np.float32) for f in (220.0, 330.0)]
        return [cb.submit(a, language="English", temperature=0.0, timeout=600.0).text
                for a in auds]
    finally:
        cb.close()


def _world_checks(rank: int, world: int, flag_vocab: int, model_dir: str) -> dict:
    """All six checks on one rank of the world; returns what the summary
    prints."""
    from ..models import encoder as enc
    from . import sharding as S
    from . import train as T

    data = 2 if world % 2 == 0 and world > 1 else 1
    model = world // data
    mesh = S.make_mesh({"data": data, "model": model})
    cfg = toy_config(model)
    out: dict = {"data": data, "model": model}

    # 1. train
    init_fn, step_fn = T.make_train_step(cfg, mesh)
    state = init_fn(0)
    batch = T.thinker_batch(cfg, 2 * data, 100, 32, 13)
    state, loss = step_fn(state, batch)
    state, loss2 = step_fn(state, batch)
    assert np.isfinite(loss) and np.isfinite(loss2) and loss2 < loss, (loss, loss2)
    out["loss"] = (loss, loss2)

    # 2. toy TP inference
    params = random_decoder(cfg.text, 1)
    prompt = spliced_prompt(cfg.text, 1)
    ref = generator_tokens(params, cfg.text, prompt)
    got = generator_tokens(params, cfg.text, prompt, mesh=mesh)
    assert ref == got and ref, (ref, got)
    out["toy"] = got

    # 3. the 1.7B decoder's shape, 2 layers
    flag = flagship_text(flag_vocab)
    fparams = random_decoder(flag, 2)
    fprompt = spliced_prompt(flag, 3)
    fref = generator_tokens(fparams, flag, fprompt)
    fgot = generator_tokens(fparams, flag, fprompt, mesh=mesh)
    assert fref == fgot and fref, (fref, fgot)
    out["flag"] = fgot

    # 4. packed int4
    out["int4"] = []
    if model > 1:
        i4 = dataclasses.replace(flag, hidden_size=512, num_heads=16, num_kv_heads=16,
                                 head_dim=128, intermediate_size=2048, vocab_size=512)
        assert S.int4_tp_supported(i4, model), (model, i4)
        i4p = decoder_weights("int4", i4, 7)
        iprompt = spliced_prompt(i4, 8, n_audio=12, t=20)
        iref = generator_tokens(i4p, i4, iprompt)
        igot = generator_tokens(i4p, i4, iprompt, mesh=mesh)
        assert iref == igot and iref, (iref, igot)
        out["int4"] = igot

    # 5. sequence-parallel windowed encode
    enc_w = dataclasses.replace(cfg.audio, attention_mode="windowed")
    enc_params = T.init_params(dataclasses.replace(cfg, audio=enc_w), 4)["encoder"]
    win = enc_w.tokens_per_window * (enc_w.n_window_infer // enc_w.n_window)
    hidden = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (2 * model * win, enc_w.d_model)) * 0.1).astype(np.float32))
    sp_ref = enc.backend_transformer(enc_params, enc_w, hidden)
    sp_out = enc.backend_transformer(enc_params, enc_w, hidden, sp_group=mesh.get_group("model"))
    torch.testing.assert_close(sp_out, sp_ref, atol=2e-5, rtol=1e-4)
    out["windows"] = 2 * model

    # 6. the TP batcher (tp = 2)
    out["texts"] = []
    if world % 2 == 0:
        cb_ref = batcher_texts(model_dir)
        cb_got = batcher_texts(model_dir, {"data": world // 2, "model": 2})
        if rank == 0:
            assert cb_ref == cb_got, (cb_ref, cb_got)
        out["texts"] = cb_ref
    return out


def summary(out: dict, flag_vocab: int) -> str:
    loss, loss2 = out["loss"]
    return (
        f"dryrun_multichip OK: mesh(data={out['data']}, model={out['model']}), "
        f"loss {loss:.4f} -> {loss2:.4f}; "
        f"TP infer == single-device ({len(out['toy'])} greedy tokens); "
        f"1.7B-shaped (16h/8kv/hd128/vocab{flag_vocab}, 2L) TP infer == "
        f"single-device ({len(out['flag'])} tokens); packed-int4 TP decode == "
        f"single-device ({len(out['int4'])} tokens, no int8 remap); "
        f"sequence-parallel windowed encode == single-device "
        f"({out['windows']} windows over model={out['model']}); TP ContinuousBatcher "
        f"rows decode == single-device ({len(out['texts'])} transcripts, tp=2)"
    )


def run(n: int, flag_vocab: int = 151936) -> str:
    """Spawn the world, run the checks, return the summary line."""
    from ..export.synthetic import make_synthetic_checkpoint
    from .launch import spawn

    with tempfile.TemporaryDirectory() as d:
        make_synthetic_checkpoint(d, "tiny", quant="f16")
        outs = spawn(_world_checks, n, args=(flag_vocab, d), timeout=1800.0)
    for o in outs[1:]:  # every rank decoded the same tokens
        assert (o["toy"], o["flag"], o["int4"]) == (outs[0]["toy"], outs[0]["flag"],
                                                      outs[0]["int4"])
    return summary(outs[0], flag_vocab)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m qwen3_asr_gguf_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks (gloo, on the CPU)")
    p.add_argument("--flag-vocab", type=int, default=151936,
                   help="vocab of the 1.7B-shaped check (151936 is the model's)")
    args = p.parse_args(argv)
    print(run(args.n, args.flag_vocab))
    return 0


if __name__ == "__main__":
    sys.exit(main())
