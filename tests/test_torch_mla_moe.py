"""The latent-attention sparse-expert decoder (DeepSeek-V3's block,
`models/mla_moe.py`) on the port's path, on the CPU at the tiny preset
`tiny-mla-moe` with seeded random weights:

- the plain reference (`models/mla_moe_ref.py`) against transformers'
  `DeepseekV3ForCausalLM` on the same weights: the equations are the
  published implementation's;
- the port's prefill (its f32 form exactly, its bf16 form within the
  rounding), and prefill then decode through the latent cache, against the
  reference's full forward; a prefix reused by `forward_prefill_at` against
  a fresh prefill;
- the router against its definition with a nonzero correction bias; the
  shared SwiGLU split into two experts against the whole; the routed-expert
  wrapper's plain version against a per-expert loop; the prefill's grouped
  products against the same loop;
- the checkpoint written and read back, the presets;
- `QwenASREngine.asr` and `StreamingTranscriber.feed` end to end, with the
  routing counters; the batchers and tensor parallelism refusing the model.

On the card (marked `cuda`; no JAX import, so `python -m pytest
tests/test_torch_mla_moe.py -m cuda --noconftest -q` runs there): kernel 8
against its plain version at Moonlight-16B-A3B's widths, and graph replay
against eager steps bit for bit.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.formats import q4_0
from qwen3_asr_gguf_tpu_torch.models import decoder as dec
from qwen3_asr_gguf_tpu_torch.models import mla_moe
from qwen3_asr_gguf_tpu_torch.models import mla_moe_ref as R
from qwen3_asr_gguf_tpu_torch.models import params as P
from qwen3_asr_gguf_tpu_torch.models.configs import preset
from qwen3_asr_gguf_tpu_torch.models.mla_config import MLAMoEConfig
from qwen3_asr_gguf_tpu_torch.ops import moe, q4k, qtensor
from qwen3_asr_gguf_tpu_torch.utils import profiling

PRESET = "tiny-mla-moe"
LLM_FN = "qwen3_asr_llm.q4_k.gguf"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla_moe")
    make_synthetic_checkpoint(str(d), PRESET, seed=3)
    return d


@pytest.fixture(scope="module")
def model(ckpt):
    cfg, params, _ = P.load_decoder_gguf(str(ckpt / LLM_FN), precision="int4")
    return cfg, P.fuse_layer_weights(params)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deq(w):
    if isinstance(w, q4k.Q4KWeight):
        return q4k.dequant_mxu(w, torch.float32)
    if isinstance(w, qtensor.Q4Weight):
        return qtensor.dequant_q4(w, torch.float32)
    return w.float()


def _experts_f32(x, cfg):
    """An `ExpertWeights` or `DenseExperts` as the reference's routed and
    shared f32 matrices."""
    e, s, m = cfg.n_routed_experts, cfg.n_shared_experts, cfg.moe_intermediate_size
    if isinstance(x, moe.ExpertWeights):
        g = moe.dequant(x.gate_qs, x.gate_d)
        u = moe.dequant(x.up_qs, x.up_d)
        dn = moe.dequant(x.down_qs, x.down_d)
    else:
        g, u, dn = x.gateup[:, :m].float(), x.gateup[:, m:].float(), x.down.float()
    return {"gate_exps": g[:e], "up_exps": u[:e], "down_exps": dn[:e],
            "gate_shexp": g[e:].reshape(s * m, -1), "up_shexp": u[e:].reshape(s * m, -1),
            "down_shexp": torch.cat(list(dn[e:]), 1)}


def ref_weights(params, cfg):
    """The reference's f32 weights with the values of the port's `params`."""
    layers = []
    for i, layer in enumerate(params["layers"]):
        lw = {k: _deq(layer[k]) for k in ("attn_norm", "kv_a_norm", "mlp_norm", "wq", "wkv_a",
                                          "wkv_b", "wo")}
        if not cfg.is_moe(i):
            gu = _deq(layer["gateup_proj"])
            lw.update(gate=gu[: gu.shape[0] // 2], up=gu[gu.shape[0] // 2:],
                      down=_deq(layer["down_proj"]))
        else:
            lw.update(router=layer["router"], router_bias=layer["router_bias"],
                      **_experts_f32(layer["experts"], cfg))
        layers.append(lw)
    return {"layers": layers, "final_norm": params["final_norm"],
            "lm_head": _deq(params["lm_head"])[: cfg.vocab_size]}


def _f32_params(pp):
    def leaf(v):
        if isinstance(v, moe.DenseExperts):
            return moe.DenseExperts(v.gateup.float(), v.down.float())
        return v.float() if torch.is_tensor(v) else v

    return dict(pp, layers=[{k: leaf(v) for k, v in layer.items()} for layer in pp["layers"]])


def int8(v):
    """v through kernel 8's activation rounding: int8, 32 to a scale."""
    q, sx = moe.quantize_groups(v)
    return (q * sx[..., None]).reshape(v.shape)


def _tokens(n, seed=0):
    return torch.randint(0, 512, (n,), generator=torch.Generator().manual_seed(seed))


# -- the reference against transformers ---------------------------------------


def test_reference_matches_transformers_deepseek_v3():
    pytest.importorskip("transformers")
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    cfg = MLAMoEConfig(vocab_size=97, hidden_size=64, num_layers=3, num_heads=4,
                       kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                       intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
                       n_shared_experts=2, num_experts_per_tok=3, first_k_dense_replace=1,
                       rope_theta=1000.0)
    hf_cfg = DeepseekV3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, moe_intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_heads, n_shared_experts=cfg.n_shared_experts,
        n_routed_experts=cfg.n_routed_experts, routed_scaling_factor=cfg.routed_scaling_factor,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=None, qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim, qk_nope_head_dim=cfg.qk_nope_head_dim, n_group=1,
        topk_group=1, num_experts_per_tok=cfg.num_experts_per_tok,
        first_k_dense_replace=cfg.first_k_dense_replace, norm_topk_prob=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps, rope_scaling=None,
        tie_word_embeddings=False, attention_bias=False, max_position_embeddings=64)
    torch.manual_seed(5)
    hf = DeepseekV3ForCausalLM(hf_cfg).float().eval()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for layer in hf.model.layers[cfg.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.copy_(
                torch.randn(cfg.n_routed_experts, generator=gen) * 0.05)
    layers = []
    for i, layer in enumerate(hf.model.layers):
        a = layer.self_attn
        lw = {"attn_norm": layer.input_layernorm.weight, "wq": a.q_proj.weight,
              "wkv_a": a.kv_a_proj_with_mqa.weight, "kv_a_norm": a.kv_a_layernorm.weight,
              "wkv_b": a.kv_b_proj.weight, "wo": a.o_proj.weight,
              "mlp_norm": layer.post_attention_layernorm.weight}
        mlp = layer.mlp
        if i < cfg.first_k_dense_replace:
            lw.update(gate=mlp.gate_proj.weight, up=mlp.up_proj.weight, down=mlp.down_proj.weight)
        else:
            lw.update(router=mlp.gate.weight, router_bias=mlp.gate.e_score_correction_bias,
                      gate_exps=torch.stack([e.gate_proj.weight for e in mlp.experts]),
                      up_exps=torch.stack([e.up_proj.weight for e in mlp.experts]),
                      down_exps=torch.stack([e.down_proj.weight for e in mlp.experts]),
                      gate_shexp=mlp.shared_experts.gate_proj.weight,
                      up_shexp=mlp.shared_experts.up_proj.weight,
                      down_shexp=mlp.shared_experts.down_proj.weight)
        layers.append({k: v.detach() for k, v in lw.items()})
    p = {"layers": layers, "final_norm": hf.model.norm.weight.detach(),
         "lm_head": hf.lm_head.weight.detach()}
    ids = _tokens(20, 1) % cfg.vocab_size
    with torch.no_grad():
        want = hf(input_ids=ids[None]).logits[0]
    got = R.logits(p, dataclasses.asdict(cfg), hf.model.embed_tokens.weight.detach()[ids])
    # f32 in both, the angles rounded apart (f64 here); another rope pairing,
    # scale or routing rule is off by the logits' own size
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


# -- the port against the reference -------------------------------------------


def test_prefill_f32_matches_reference(model):
    """The port's prefill in f32 on its dense prefill weights: the
    reference's logits on the same weight values, to f32 rounding."""
    cfg, params = model
    pp = _f32_params(P.dequant_prefill_params(params))
    emb = params["embed"][_tokens(48)].float()
    want = R.logits(ref_weights(pp, cfg) | {"lm_head": ref_weights(params, cfg)["lm_head"]},
                    dataclasses.asdict(cfg), emb)
    h, _ = mla_moe.forward_prefill(pp, cfg, emb, None)
    got = h @ ref_weights(params, cfg)["lm_head"].t()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_prefill_bf16_against_reference(model):
    """The bf16 prefill (the engine's) against the float32 reference on the
    int4 weights: within bf16's rounding at nearly every row. A row may
    differ more where bf16 turns a near-tie of the router's sixth and
    seventh score (the benchmark's limits absorb those)."""
    cfg, params = model
    emb = params["embed"][_tokens(48)]
    rw = ref_weights(params, cfg)
    want = R.logits(rw, dataclasses.asdict(cfg), emb.float())
    h, _ = mla_moe.forward_prefill(P.dequant_prefill_params(params), cfg, emb,
                                   mla_moe.init_cache(cfg, 256))
    got = dec.lm_logits(params, h, cfg.vocab_size)
    per_row = (got - want).abs().amax(-1) / want.abs().amax()
    assert float(per_row.median()) <= 0.01
    assert float((per_row <= 0.03).float().mean()) >= 0.9


def test_moe_prefill_takes_only_the_dense_copy(model):
    """The prefill's experts are the dense copy: the int4 planes there are
    refused, never dequantized on each call; a Generator derives the copy
    for this decoder whatever `dequant_prefill` says."""
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    cfg, params = model
    emb = params["embed"][_tokens(8)]
    with pytest.raises(TypeError, match="dense copy"):
        mla_moe.forward_prefill(params, cfg, emb, None)
    gen = Generator(params, cfg, device="cpu", dequant_prefill=False)
    layer = gen.prefill_params["layers"][cfg.first_k_dense_replace]
    assert isinstance(layer["experts"], moe.DenseExperts)


@pytest.mark.parametrize("start", [1, 17, 40])
def test_prefill_then_decode_matches_reference(model, start):
    """Prefill `start` tokens, then decode the rest one step at a time through
    the latent cache (kernel 1's and kernel 6's plain versions, the absorbed
    attention, the routed-expert plain version): the logits at every
    position against the reference's full forward."""
    cfg, params = model
    emb = params["embed"][_tokens(48, 2)]
    want = R.logits(ref_weights(params, cfg), dataclasses.asdict(cfg), emb.float())
    cache = mla_moe.init_cache(cfg, 256)
    h, _ = mla_moe.forward_prefill(P.dequant_prefill_params(params), cfg, emb[:start], cache)
    got = [dec.lm_logits(params, h[-1], cfg.vocab_size)]
    pos = torch.zeros(1, dtype=torch.int32)
    for p in range(start, 48):
        pos.fill_(p)
        hs, _ = mla_moe.forward_step_layers(params["layers"], params["final_norm"], cfg, emb[p],
                                            cache, pos, attn_window=256)
        got.append(dec.lm_logits(params, hs, cfg.vocab_size))
    per_row = (torch.stack(got) - want[start - 1:]).abs().amax(-1) / want.abs().amax()
    assert float(per_row[1:].max()) <= 0.02  # the decode steps' rows
    assert float((per_row <= 0.03).float().mean()) >= 0.9


@pytest.mark.parametrize("start,window", [(20, 64), (64, 64), (33, 128)])
def test_prefix_reuse_matches_fresh_prefill(model, start, window):
    """`forward_prefill_at` on the cache's slots [0, start) gives the rows and
    the cache slots of a fresh prefill of the whole prompt, bit for bit."""
    cfg, params = model
    pp = P.dequant_prefill_params(params)
    emb = params["embed"][_tokens(96, 3)]
    fresh = mla_moe.init_cache(cfg, 256)
    want, _ = mla_moe.forward_prefill(pp, cfg, emb, fresh)
    kept = mla_moe.init_cache(cfg, 256)
    mla_moe.forward_prefill(pp, cfg, emb[:start], kept)
    got, _ = mla_moe.forward_prefill_at(pp, cfg, emb[start:], kept, start, prefix_window=window)
    torch.testing.assert_close(got, want[start:], rtol=0, atol=0)
    for key in ("kv", "pe"):
        for a, b in zip(kept[key], fresh[key]):
            torch.testing.assert_close(a[:96], b[:96], rtol=0, atol=0)


def test_latent_cache_layout(model):
    cfg, _ = model
    cache = mla_moe.init_cache(cfg, 256)
    assert set(cache) == {"kv", "pe"} and len(cache["kv"]) == cfg.num_layers
    assert cache["kv"][0].shape == (256, cfg.kv_lora_rank)
    assert cache["pe"][0].shape == (256, cfg.qk_rope_head_dim)
    with pytest.raises(NotImplementedError):
        mla_moe.init_cache(cfg, 256, torch.int8)


# -- the router and the experts ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_choice_against_its_definition(seed):
    """The choice is the top-k of sigmoid + bias (a nonzero bias changes it),
    the weights the chosen experts' unbiased scores renormalised times the
    scale, in f32."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(64, 32, generator=g).to(torch.bfloat16)
    router = torch.randn(16, 32, generator=g) * 0.3
    bias = torch.randn(16, generator=g) * 0.2
    idx, w = moe.route(x, router, bias, 4, 2.446)
    scores = torch.sigmoid(x.float() @ router.t())
    for t in range(64):
        chosen = sorted(np.argsort(-(scores[t] + bias).numpy(), kind="stable")[:4].tolist())
        assert sorted(idx[t].tolist()) == chosen
        want = scores[t, idx[t]] / scores[t, idx[t]].sum() * 2.446
        torch.testing.assert_close(w[t], want, rtol=1e-6, atol=0)
    unbiased, _ = moe.route(x, router, torch.zeros(16), 4, 2.446)
    assert not torch.equal(torch.sort(idx).values, torch.sort(unbiased).values)


def test_shared_split_equals_whole():
    """A SwiGLU of width 2M as two experts of width M, weight 1 each, equals
    the whole up to the order of summation (kernel 8's int8 activations
    included); `from_q4_0` splits the shared expert's q4_0 rows and columns
    so."""
    g = torch.Generator().manual_seed(4)
    d, m = 64, 32
    gate, up = torch.randn(2 * m, d, generator=g) * 0.2, torch.randn(2 * m, d, generator=g) * 0.2
    down = torch.randn(d, 2 * m, generator=g) * 0.2
    enc = [torch.from_numpy(q4_0.quantize_q4_0(w.numpy())) for w in (gate, up, down)]
    gq, uq, dq = (torch.from_numpy(q4_0.dequantize_q4_0(e.numpy(), w.shape))
                  for e, w in zip(enc, (gate, up, down)))
    x = torch.randn(d, generator=g)
    # the int8 groups of the halves' activations are the whole's (M % 32 == 0)
    xq = int8(x)
    whole = dq @ int8(F.silu(gq @ xq) * (uq @ xq))
    routed = [torch.from_numpy(q4_0.quantize_q4_0(np.zeros((1, m, d), np.float32)))] * 2
    routed.append(torch.from_numpy(q4_0.quantize_q4_0(np.zeros((1, d, m), np.float32))))
    w = moe.from_q4_0(*routed, m, d, shared=tuple(enc))
    assert w.shape == (3, m, d)
    halves = moe.expert_matvec_ref(x, w, torch.tensor([1, 2], dtype=torch.int32),
                                   torch.ones(2))
    torch.testing.assert_close(halves, whole, rtol=1e-5, atol=1e-5)


def _random_experts(e, m, d, seed):
    g = torch.Generator().manual_seed(seed)
    raw = [torch.from_numpy(q4_0.quantize_q4_0((torch.randn(*s, generator=g) * 0.05).numpy()))
           for s in ((e, m, d), (e, m, d), (e, d, m))]
    return moe.from_q4_0(*raw, m, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matvec_plain_against_loop(dtype):
    e, m, d = 10, 64, 96
    w = _random_experts(e, m, d, 5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, d, generator=g).to(dtype)
    ids = torch.tensor([7, 2, 9, 0], dtype=torch.int32)
    wts = torch.rand(4, generator=g)
    got = moe.expert_matvec(x, w, ids, wts)
    assert got.dtype == dtype and got.shape == (1, d)
    want = torch.zeros(d)
    xq = int8(x[0].float())
    for s, eid in enumerate(ids.tolist()):
        gw = moe.dequant(w.gate_qs[eid], w.gate_d[eid])
        uw = moe.dequant(w.up_qs[eid], w.up_d[eid])
        dw = moe.dequant(w.down_qs[eid], w.down_d[eid])
        want += wts[s] * (dw @ int8(F.silu(gw @ xq) * (uw @ xq)))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[0].float(), want, rtol=0, atol=tol * float(want.abs().max()))
    # int8 activations, 32 to a scale: within a percent of the f32 products
    exact = sum(wts[s] * (moe.dequant(w.down_qs[e], w.down_d[e]) @ (
        F.silu(moe.dequant(w.gate_qs[e], w.gate_d[e]) @ x[0].float())
        * (moe.dequant(w.up_qs[e], w.up_d[e]) @ x[0].float()))) for s, e in enumerate(ids.tolist()))
    assert float((got[0].float() - exact).abs().max()) <= 0.03 * float(exact.abs().max())


def test_grouped_experts_against_loop():
    """The prefill's sorted, grouped products against a per-token loop, and
    the histogram of routed rows."""
    e, m, d = 10, 64, 96
    dense = _random_experts(e, m, d, 7).dense(torch.float32)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(13, d, generator=g)
    ids = torch.stack([torch.randperm(e, generator=g)[:4] for _ in range(13)])
    wts = torch.rand(13, 4, generator=g)
    hist = []
    got = moe.grouped_experts(x, dense, ids, wts, hist, n_routed=8)
    want = torch.zeros(13, d)
    for t in range(13):
        for s in range(4):
            k = int(ids[t, s])
            gu = dense.gateup[k] @ x[t]
            want[t] += wts[t, s] * (dense.down[k] @ (F.silu(gu[:m]) * gu[m:]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert hist[0].tolist() == torch.bincount(ids.reshape(-1), minlength=e)[:8].tolist()
    # a prompt's padding rows are computed but not counted
    valid = torch.arange(13) < 9
    moe.grouped_experts(x, dense, ids, wts, hist, n_routed=8, valid=valid)
    assert hist[1].tolist() == torch.bincount(ids[:9].reshape(-1), minlength=e)[:8].tolist()


# -- checkpoint, presets --------------------------------------------------------


def test_checkpoint_reads_back(ckpt, model):
    cfg, params = model
    want = preset(PRESET).text
    for f in dataclasses.fields(MLAMoEConfig):
        got, exp = getattr(cfg, f.name), getattr(want, f.name)
        assert got == pytest.approx(exp, rel=1e-6) if isinstance(exp, float) else got == exp
    assert P.load_thinker_config(str(ckpt)).text == want
    layer = params["layers"][1]
    assert isinstance(layer["experts"], moe.ExpertWeights)
    assert layer["experts"].shape == (cfg.n_routed_experts + cfg.n_shared_experts,
                                      cfg.moe_intermediate_size, cfg.hidden_size)
    assert isinstance(layer["wkv_a"], qtensor.Q4Weight) and isinstance(layer["wq"], q4k.Q4KWeight)
    assert float(layer["router_bias"].abs().max()) > 0  # the correction bias is drawn, not 0
    assert "gateup_proj" in params["layers"][0] and "experts" not in params["layers"][0]


def test_q4_0_codec_round_trip():
    x = np.random.default_rng(9).standard_normal((5, 64)).astype(np.float32)
    blocks = q4_0.quantize_q4_0(x)
    assert blocks.shape == (5, 36) and blocks.dtype == np.uint8
    y = q4_0.dequantize_q4_0(blocks, x.shape)
    step = np.abs(x).reshape(-1, 32).max(1) / 8
    assert np.all(np.abs(x - y).reshape(-1, 32) <= step[:, None] * 1.001)
    qs, d = moe.split_q4_0(torch.from_numpy(blocks), 64)
    torch.testing.assert_close(moe.dequant(qs, d), torch.from_numpy(y), rtol=0, atol=0)


def test_moonlight_preset_at_published_widths():
    t = preset("qwen3-asr-1.7b-moonlight-16b-a3b").text
    assert (t.hidden_size, t.num_layers, t.num_heads, t.vocab_size) == (2048, 27, 16, 163840)
    assert (t.kv_lora_rank, t.qk_nope_head_dim, t.qk_rope_head_dim, t.v_head_dim) == (
        512, 128, 64, 128)
    assert (t.n_routed_experts, t.num_experts_per_tok, t.n_shared_experts) == (64, 6, 2)
    assert (t.intermediate_size, t.moe_intermediate_size, t.first_k_dense_replace) == (
        11264, 1408, 1)
    assert preset("qwen3-asr-1.7b-moonlight-16b-a3b").audio == preset("qwen3-asr-1.7b").audio


# -- the engine ------------------------------------------------------------------


def _engine(ckpt, **kw):
    from qwen3_asr_gguf_tpu_torch import QwenASREngine
    from qwen3_asr_gguf_tpu_torch.schema import ASREngineConfig

    cfg = ASREngineConfig(model_dir=str(ckpt), llm_fn=LLM_FN, precision="int4", n_ctx=512,
                          chunk_size=4.0, memory_num=1, max_new_tokens=8, decode_block=8,
                          verbose=False, **kw)
    return QwenASREngine(cfg, device="cpu")


def test_engine_asr_end_to_end(ckpt, one_thread):
    engine = _engine(ckpt, kv_prefix_reuse=True, pipelined_dispatch=True)
    audio = np.random.default_rng(0).standard_normal(16000 * 10).astype(np.float32) * 0.1
    with profiling.recording():
        res = engine.asr(audio, context="", language="Chinese", chunk_size_sec=4.0,
                         memory_chunks=1, temperature=0.4)
        recs = profiling.records()
    profiling.clear()
    assert isinstance(res.text, str) and res.performance["decode_tokens"] > 0
    rows = [r.n for r in recs if r.name == "moe.rows"]
    hottest = [r.n for r in recs if r.name == "moe.rows_hottest"]
    cfg = engine.dec_cfg
    n_moe = cfg.num_layers - cfg.first_k_dense_replace
    assert rows and len(rows) == len(hottest) and len(rows) % n_moe == 0
    assert all(0 < h <= r for h, r in zip(hottest, rows))
    assert all(r % cfg.num_experts_per_tok == 0 for r in rows)
    assert any(r.name == "moe.prefill" and r.n is None for r in recs)
    engine.shutdown()


def test_streaming_feed_end_to_end(ckpt, one_thread):
    from qwen3_asr_gguf_tpu_torch.runtime.streaming import StreamingTranscriber

    engine = _engine(ckpt)
    st = StreamingTranscriber(engine, chunk_size_sec=2.0, language="Chinese")
    rng = np.random.default_rng(1)
    state = st.init_state()
    for _ in range(3):
        state = st.feed(state, rng.standard_normal(32000).astype(np.float32) * 0.1)
    assert state.chunks_seen == 3 and isinstance(state.text, str) and state.tokens
    engine.shutdown()


@pytest.mark.parametrize("what", ["continuous", "batched", "micro", "mesh", "generator_mesh"])
def test_batchers_and_tp_refuse(ckpt, what):
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    if what == "mesh":
        with pytest.raises(NotImplementedError, match="MLAMoEConfig"):
            _engine(ckpt, mesh_shape={"model": 2})
        return
    if what == "generator_mesh":
        cfg = preset(PRESET).text
        with pytest.raises(NotImplementedError, match="MLAMoEConfig"):
            Generator({}, cfg, device="cpu", mesh=object())
        return
    engine = _engine(ckpt)
    if what == "continuous":
        from qwen3_asr_gguf_tpu_torch.runtime.continuous import ContinuousBatcher as cls
    elif what == "batched":
        from qwen3_asr_gguf_tpu_torch.runtime.batched import BatchedEngine as cls
    else:
        from qwen3_asr_gguf_tpu_torch.runtime.microbatch import MicroBatcher as cls
    with pytest.raises(NotImplementedError, match="MLAMoEConfig"):
        cls(engine)
    engine.shutdown()


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (kernel 8 has no interpret mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel8_against_plain_at_moonlight_widths(card, dtype):
    e, m, d = 66, 1408, 2048
    w = _random_experts(e, m, d, 11)
    w = moe.ExpertWeights(*(getattr(w, f.name).to(card) for f in dataclasses.fields(w)))
    g = torch.Generator().manual_seed(12)
    x = torch.randn(1, d, generator=g).to(card, dtype)
    ids = torch.tensor([5, 63, 17, 0, 40, 9, 64, 65], dtype=torch.int32, device=card)
    wts = torch.cat([torch.rand(6, generator=g), torch.ones(2)]).to(card)
    got = moe.expert_matvec(x, w, ids, wts)
    want = moe.expert_matvec_ref(x, w, ids, wts)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= 0.01 * want.float().abs().max()


@pytest.mark.cuda
def test_graph_replay_equals_eager_steps(card, ckpt):
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    cfg, params, _ = P.load_decoder_gguf(str(ckpt / LLM_FN), precision="int4", device=card)
    params = P.fuse_layer_weights(params)
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 512, 40)
    mask = np.zeros(40, bool)
    audio = torch.zeros(1, cfg.hidden_size, dtype=torch.bfloat16, device=card)
    out = {}
    for graphs in (True, False):
        gen = Generator(params, cfg, n_ctx=256, block=16, dequant_prefill=True, device=card,
                        cuda_graphs=graphs)
        st = gen.start_spliced(ids, mask, audio, temperature=0.4, seed=7)
        toks = []
        for _ in range(3):
            t, st, _, _ = gen.decode_block(st, temperature=0.4)
            toks += t
        out[graphs] = (toks, st.cache["kv"][2][:100].clone(), st.cache["pe"][2][:100].clone())
        del gen, st
        gc.collect()
    assert out[True][0] == out[False][0]
    assert torch.equal(out[True][1], out[False][1]) and torch.equal(out[True][2], out[False][2])
