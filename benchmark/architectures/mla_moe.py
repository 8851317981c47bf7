"""DeepSeek-V3's decoder (multi-head latent attention, sparse experts; a
configuration such as Moonlight-16B-A3B) behind the Qwen3-ASR audio tower.

- The configuration's file holds the model's published config.json keys at
  its top level (`text_config` maps them to the port's `MLAMoEConfig`
  fields) and the tower under "model": {"audio"}.
- Checkpoint: the tower's BF16 safetensors as `checkpoint.py` writes them,
  and the decoder as llama.cpp's deepseek2 GGUF, drawn on the device from
  the configuration's `weights_seed` one tensor at a time, in sorted-name
  order within a layer (norms 1, the rest N(0, 0.02)):
  q4_k attention, kv_b and dense-MLP matrices, q4_0 experts (their width,
  1,408, is no whole 256-superblock), f32 router and bias, q6_k embed and
  head (its non-CJK rows scaled by 0.3, as `checkpoint.py` does).
- The router's correction bias is set as aux-loss-free balancing sets it
  (`balance_bias`): the writer runs the f32 decoder as it draws it over
  the prompts of a calibration clip (`CALIBRATION`: the traffic's signal
  and prompts, a seed no run draws) and gives each MoE layer the bias
  under which every expert takes its share of those rows. Random weights
  give the rows of a prompt a common direction, so with no such bias one
  expert takes most of them.
- Taps: `qwen3_asr`'s first tokens (the single-stream sampler).
- Reference: `reference/mla_moe.py`, judged as `qwen3_asr` judges (the
  gaps of the port's first and served tokens); the controls are its
  `Precision`s. Numbers: `qwen3_asr`'s, and `route_near_ties` /
  `route_decisions` (the MoE layers' routing margins under
  `reference/mla_moe.NEAR_TIE`, over the rows routed), which no limit holds.
"""

from __future__ import annotations

import importlib.util
import json
import sys

import numpy as np
import torch

from benchmark import checkpoint as writer
from benchmark import gguf, quant, signals
from benchmark import q4_0 as q40
from benchmark.architectures import qwen3_asr as asr
from benchmark.reference import mla_moe as ref
from benchmark.reference import prompts
from benchmark.reference import weights as ref_weights
from benchmark.tokenizer import build_synthetic_tokenizer

CONTROLS = asr.CONTROLS
FIXED = dict(asr.FIXED, route_mismatches=0)
ARCH = "deepseek2"
# the clip the correction bias is balanced on: (signal seed, seconds, chunks
# prompted, language); no run draws this seed
CALIBRATION = (2**31 + 101, 80.0, 2, "Chinese")
BALANCE_STEPS = 400
DECODER_FN = "qwen3_asr_llm.q4_k.gguf"
PORT_MODULE = "qwen3_asr_gguf_tpu_torch.models.mla_moe"
# the port's MLAMoEConfig field <- the published config.json key
FIELDS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
          "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
          "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
          "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
          "v_head_dim": "v_head_dim", "intermediate_size": "intermediate_size",
          "moe_intermediate_size": "moe_intermediate_size",
          "n_routed_experts": "n_routed_experts", "n_shared_experts": "n_shared_experts",
          "num_experts_per_tok": "num_experts_per_tok",
          "first_k_dense_replace": "first_k_dense_replace",
          "routed_scaling_factor": "routed_scaling_factor", "norm_topk_prob": "norm_topk_prob",
          "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta"}


def text_config(cfg: dict) -> dict:
    """The decoder's fields, named as the port's `MLAMoEConfig` names them."""
    return {mine: cfg[theirs] for mine, theirs in FIELDS.items()}


def shapes(t: dict) -> dict:
    """GGUF tensor name suffix -> (shape, ggml type) of one layer, by kind."""
    d, h, r, rope = t["hidden_size"], t["num_heads"], t["kv_lora_rank"], t["qk_rope_head_dim"]
    e, m, f = t["n_routed_experts"], t["moe_intermediate_size"], t["intermediate_size"]
    ms = t["n_shared_experts"] * m
    q4k, f32, q4z = gguf.Q4_K, gguf.F32, q40.Q4_0
    attn = {"attn_norm.weight": ((d,), f32),
            "attn_q.weight": ((h * (t["qk_nope_head_dim"] + rope), d), q4k),
            "attn_kv_a_mqa.weight": ((r + rope, d), q4k),
            "attn_kv_a_norm.weight": ((r,), f32),
            "attn_kv_b.weight": ((h * (t["qk_nope_head_dim"] + t["v_head_dim"]), r), q4k),
            "attn_output.weight": ((d, h * t["v_head_dim"]), q4k),
            "ffn_norm.weight": ((d,), f32)}
    dense = {"ffn_gate.weight": ((f, d), q4k), "ffn_up.weight": ((f, d), q4k),
             "ffn_down.weight": ((d, f), q4k)}
    moe = {"ffn_gate_inp.weight": ((e, d), f32), "ffn_gate_exps.weight": ((e, m, d), q4z),
           "ffn_up_exps.weight": ((e, m, d), q4z), "ffn_down_exps.weight": ((e, d, m), q4z),
           "ffn_gate_shexp.weight": ((ms, d), q4z), "ffn_up_shexp.weight": ((ms, d), q4z),
           "ffn_down_shexp.weight": ((d, ms), q4z)}
    return {"attn": attn, "dense": dense, "moe": moe}


def _encode(x: torch.Tensor, typ: int) -> np.ndarray:
    if typ == gguf.F32:
        return writer._host(x)
    enc = {gguf.Q4_K: quant.encode_q4_k, gguf.Q6_K: quant.encode_q6_k,
           q40.Q4_0: q40.encode_q4_0}[typ]
    return writer._host(enc(x.reshape(-1, x.shape[-1])))


def balance_bias(scores: torch.Tensor, k: int, steps: int = BALANCE_STEPS):
    """(bias [E], busiest expert's rows over the mean with no bias, with
    it): the correction bias under which the top k of scores + bias give
    every expert its share of the rows of `scores` [N, E], moved as
    aux-loss-free balancing moves it: each step every expert's bias by
    `step` against the sign of its excess rows, `step` shrinking from a
    quarter of the scores' range to 1e-4 of it. The most even bias seen is
    kept."""
    n, e = scores.shape
    mean = n * k / e
    bias = torch.zeros(e, dtype=scores.dtype, device=scores.device)
    step = float(scores.max() - scores.min()) / 4
    shrink = 4e-4 ** (1 / steps)
    first, best = None, (float("inf"), bias)
    for _ in range(steps):
        load = torch.bincount(torch.topk(scores + bias, k, dim=-1).indices.reshape(-1),
                              minlength=e)
        worst = float(load.max()) / mean
        first = worst if first is None else first
        if worst < best[0]:
            best = (worst, bias.clone())
        bias = bias - step * torch.sign(load - mean)
        step *= shrink
    return best[1], first, best[0]


def calibration_prompts(d, cfg: dict, tok, embed: torch.Tensor) -> list:
    """The input embeddings [T, D] of the first CALIBRATION chunks' prompts
    of the calibration clip, as the reference builds them (the encoder read
    back from `d`, in f32)."""
    seed, seconds, chunks, language = CALIBRATION
    e, device = cfg["engine"], embed.device
    ids = {"im_start": "<|im_start|>", "im_end": "<|im_end|>", "audio_start": "<|audio_start|>",
           "audio_end": "<|audio_end|>", "asr_text": "<asr_text>"}
    jobs = prompts.file_jobs(tok, {k: tok.token_to_id(v) for k, v in ids.items()},
                             signals.speech(seed, 0, seconds), e["chunk_size"],
                             [[]] * chunks, language, e["n_ctx"], 96)
    enc = ref_weights.encoder(d, e["precision"], device)
    filters = torch.from_numpy(writer.mel_filterbank()).to(device)
    prec, audio = ref.model.Precision(None), cfg["model"]["audio"]
    out = []
    for job in jobs:
        rows = []
        for part in job["parts"]:
            if part[0] == "ids":
                rows.append(embed[torch.as_tensor(part[1], dtype=torch.long, device=device)])
            else:
                mel = ref.model.log_mel(torch.as_tensor(part[1], device=device), filters)
                rows.append(ref.model.encode(enc, audio, mel, prec)[: part[2]])
        out.append(torch.cat(rows))
    return out


def write_decoder(path, t: dict, tok, gen, device, cjk_ids, calibrate) -> None:
    """The deepseek2 GGUF. `calibrate(embed)` gives the calibration prompts'
    input embeddings, which the layers run over as they are drawn (f32,
    TF32 off) to balance each MoE layer's correction bias."""
    w = gguf.Writer(ARCH)
    for key, val in (("block_count", t["num_layers"]), ("embedding_length", t["hidden_size"]),
                     ("feed_forward_length", t["intermediate_size"]),
                     ("attention.head_count", t["num_heads"]),
                     ("attention.head_count_kv", t["num_heads"]),
                     ("attention.kv_lora_rank", t["kv_lora_rank"]),
                     ("attention.key_length", t["qk_nope_head_dim"] + t["qk_rope_head_dim"]),
                     ("attention.value_length", t["v_head_dim"]),
                     ("rope.dimension_count", t["qk_rope_head_dim"]),
                     ("leading_dense_block_count", t["first_k_dense_replace"]),
                     ("expert_feed_forward_length", t["moe_intermediate_size"]),
                     ("expert_count", t["n_routed_experts"]),
                     ("expert_shared_count", t["n_shared_experts"]),
                     ("expert_used_count", t["num_experts_per_tok"]),
                     ("expert_gating_func", 2), ("vocab_size", t["vocab_size"])):
        w.add(f"{ARCH}.{key}", gguf.T_U32, int(val))
    for key, val in (("expert_weights_scale", t["routed_scaling_factor"]),
                     ("attention.layer_norm_rms_epsilon", t["rms_norm_eps"]),
                     ("rope.freq_base", t["rope_theta"])):
        w.add(f"{ARCH}.{key}", gguf.T_F32, float(val))
    # a u32 where llama.cpp writes a bool: the benchmark's writer has no bool
    w.add(f"{ARCH}.expert_weights_norm", gguf.T_U32, int(bool(t["norm_topk_prob"])))
    w.add("tokenizer.ggml.model", gguf.T_STR, "gpt2")
    w.add("tokenizer.ggml.pre", gguf.T_STR, "qwen2")
    w.add("tokenizer.ggml.tokens", gguf.T_ARR, (gguf.T_STR, tok.tokens))
    merges = [f"{a} {b}" for (a, b), _ in sorted(tok.merge_ranks.items(), key=lambda kv: kv[1])]
    w.add("tokenizer.ggml.merges", gguf.T_ARR, (gguf.T_STR, merges))
    w.add("tokenizer.ggml.token_type", gguf.T_ARR,
          (gguf.T_I32, [3 if s in tok.special_tokens else 1 for s in tok.tokens]))
    w.add("tokenizer.ggml.eos_token_id", gguf.T_U32, tok.eos_token_id)

    def add(name, shape, typ):
        if "norm" in name:
            x = torch.ones(shape, device=device)
        else:
            x = torch.randn(shape, generator=gen, device=device) * 0.02
        if name == "output.weight" and cjk_ids is not None and len(cjk_ids) >= 100:
            scale = torch.full((shape[0],), 0.3, device=device)
            scale[torch.as_tensor(cjk_ids, device=device)] = 1.0
            x *= scale[:, None]
        w.add_tensor(name, shape, typ, _encode(x, typ))
        return x

    d, v = t["hidden_size"], t["vocab_size"]
    hs = calibrate(add("token_embd.weight", (v, d), gguf.Q6_K))
    add("output_norm.weight", (d,), gguf.F32)
    add("output.weight", (v, d), gguf.Q6_K)
    kinds = shapes(t)
    names = {suffix: mine for mine, suffix in {**ref.ATTN, **ref.DENSE, **ref.MOE}.items()}
    prec, eps, k = ref.model.Precision(None), t["rms_norm_eps"], t["num_experts_per_tok"]
    biases, loads = [], []
    for i in range(t["num_layers"]):
        moe_layer = i >= t["first_k_dense_replace"]
        per = dict(kinds["attn"], **kinds["moe" if moe_layer else "dense"])
        lw = {names[suffix]: add(f"blk.{i}.{suffix}", *per[suffix]) for suffix in sorted(per)}
        hs = [h + ref.attention(lw, t, ref.rms(h, lw["attn_norm"], eps), prec) for h in hs]
        ys = [ref.rms(h, lw["mlp_norm"], eps) for h in hs]
        if not moe_layer:
            hs = [h + ref.swiglu(y, lw["gate"], lw["up"], lw["down"], prec)
                  for h, y in zip(hs, ys)]
            continue
        scores = torch.sigmoid(torch.cat(ys) @ lw["router"].t())
        lw["router_bias"], before, after = balance_bias(scores, k)
        biases.append(lw["router_bias"])
        loads.append((before, after))
        hs = [h + ref.moe(lw, t, y, prec, None, {}) for h, y in zip(hs, ys)]
        del lw, scores
    for i, bias in zip(range(t["first_k_dense_replace"], t["num_layers"]), biases):
        w.add_tensor(f"blk.{i}.exp_probs_b.bias", (t["n_routed_experts"],), gguf.F32,
                     writer._host(bias))
    if loads:
        b = torch.stack(biases)
        print(f"[bench] correction bias balanced over {sum(h.shape[0] for h in hs)} rows: "
              f"busiest expert's rows over the mean {np.median([x for x, _ in loads]):.2f} -> "
              f"{np.median([y for _, y in loads]):.2f} (median of layers; worst "
              f"{max(y for _, y in loads):.2f}); bias in [{float(b.min()):.4f}, "
              f"{float(b.max()):.4f}], std {float(b.std()):.4f}", file=sys.stderr, flush=True)
    w.write(str(path))


def write_model(d, cfg: dict, seed: int, device) -> None:
    t = text_config(cfg)
    d.mkdir(parents=True, exist_ok=True)
    tok = build_synthetic_tokenizer(t["vocab_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    audio = cfg["model"]["audio"]
    writer.write_encoder(d / writer.ENCODER_FN, audio, gen, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            write_decoder(d / DECODER_FN, t, tok, gen, device, writer.cjk_token_ids(tok),
                          calibrate=lambda embed: calibration_prompts(d, cfg, tok, embed))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (d / "config.json").write_text(json.dumps(
        writer.thinker_json({"audio": audio, "text": t}, tok), indent=1))
    np.save(d / "mel_filters.npy", writer.mel_filterbank())


def checkpoint(cfg: dict, cache_root, device):
    if importlib.util.find_spec(PORT_MODULE) is None:  # fail before writing 9 GB
        raise RuntimeError(f"the port has no {ARCH} decoder ({PORT_MODULE})")
    keys = ("model", "weights_seed", "assumed", *sorted(set(FIELDS.values())))
    return writer.ensure(cfg, cache_root, device, keys=keys,
                         write=lambda tmp: write_model(tmp, cfg, int(cfg["weights_seed"]), device))


class RouteTap:
    """The experts the port's router chose, for every row of every MoE layer
    the port computed while the window was open: it wraps `ops.moe.route`
    (which the prefill and the captured decode step call) and appends each
    call's [T, k] choices to a device buffer at a device counter (an add, a
    clamp, a cast and an index copy: valid inside a captured graph, read
    once after the window); each prefill's T (> 1, called on the host) goes
    to a host list. A decode step calls it once per MoE layer with T = 1,
    a prefill once per MoE layer with its padded rows (each call's T to the
    host list), in the order the stream runs them."""

    CAPACITY = 1 << 22  # rows (a 120 s call routes ~90,000)
    MAX_T = 8192

    def __init__(self, device):
        self.device = torch.device(device)
        self.buf = self.ctr = self.ar = None
        self.prefills: list = []
        self._module = self._inner = None

    def install(self) -> None:
        from qwen3_asr_gguf_tpu_torch.ops import moe

        inner = moe.route
        tap = self

        def route(x, *a, **k):
            idx, w = inner(x, *a, **k)
            t = idx.shape[0]
            if tap.buf is None:  # the first call is a warm-up prefill, outside any capture
                tap.buf = torch.full((tap.CAPACITY, idx.shape[1]), -1, dtype=torch.int16,
                                     device=idx.device)
                tap.ctr = torch.zeros(1, dtype=torch.int64, device=idx.device)
                tap.ar = torch.arange(tap.MAX_T, device=idx.device)
            if t > 1:
                tap.prefills.append(t)
            pos = (tap.ctr + tap.ar[:t]).clamp_(max=tap.CAPACITY - 1)
            tap.buf.index_copy_(0, pos, idx.to(torch.int16))
            tap.ctr.add_(t)
            return idx, w

        self._module, self._inner = moe, inner
        moe.route = route

    def remove(self) -> None:
        if self._module is not None:
            self._module.route = self._inner
            self._module = None

    def reset(self) -> None:
        if self.ctr is not None:
            self.ctr.zero_()
        del self.prefills[:]

    def read(self):
        """(choices [rows, k] in stream order, the prefills' T, overflowed)."""
        if self.ctr is None:
            return np.zeros((0, 1), np.int64), [], False
        n = int(self.ctr.item())
        rows = self.buf[: min(n, self.CAPACITY)].cpu().numpy().astype(np.int64)
        return rows, list(self.prefills), n > self.CAPACITY

    def fill(self, jobs: list, record) -> str:
        """Each job with a "route_plan" (the traffic driver's) gets "routes": one
        [rows, k] array per MoE layer for the reference's rows (the prompt,
        then the served tokens but the last), or None where the record does
        not hold them."""
        rows, prefills, overflow = record
        for job in jobs:
            if "route_plan" in job:
                job["routes"] = None if overflow else plan_routes(job, rows, prefills)
        return (f"{len(rows)} routed rows, {len(prefills)} prefills recorded"
                + (" (overflowed)" if overflow else ""))


def plan_routes(job: dict, rows: np.ndarray, prefills: list):
    """The port's choices for the reference's rows of `job`. The traffic driver's
    plan: `prior` (prefills, steps) of each earlier call of the window,
    this call's chunks as prefills each followed by `block` steps, `n_moe`
    MoE layers, each chunk's prompt length `P` and first prefilled position
    `start`; a row before `start` was prefilled by chunk 0 (the KV prefix
    the engine reuses)."""
    p = job["route_plan"]
    n_moe, block, i = p["n_moe"], p["block"], p["chunk"]
    if len(prefills) % n_moe:
        return None
    prefills = prefills[::n_moe]  # a prefill's MoE layers each recorded its T
    first = sum(n for n, _ in p["prior"])  # this call's first prefill in `prefills`
    offset = sum(n_moe * (sum(prefills[j] for j in range(f, f + n)) + steps)
                 for f, (n, steps) in zip(np.cumsum([0] + [n for n, _ in p["prior"]]),
                                          p["prior"]))
    starts = []  # (first row of the prefill, its T, first row of its steps) per chunk
    for c in range(len(p["P"])):
        if first + c >= len(prefills):
            return None
        t = prefills[first + c]
        starts.append((offset, t, offset + n_moe * t))
        offset += n_moe * (t + block)
    if offset > len(rows):
        return None
    n_rows = p["P"][i] + len(job["served"]) - 1
    r = np.arange(n_rows)
    out = []
    for layer in range(n_moe):
        at = np.empty(n_rows, np.int64)
        reused = r < p["start"][i]
        pre = (r >= p["start"][i]) & (r < p["P"][i])
        dec = r >= p["P"][i]
        at[reused] = starts[0][0] + layer * starts[0][1] + r[reused]
        at[pre] = starts[i][0] + layer * starts[i][1] + r[pre] - p["start"][i]
        at[dec] = starts[i][2] + (r[dec] - p["P"][i]) * n_moe + layer
        if (r[reused] >= starts[0][1]).any() or (r[pre] - p["start"][i] >= starts[i][1]).any() \
                or (r[dec] - p["P"][i] >= block).any():
            return None
        out.append(rows[at])
    return out


def taps(device) -> list:
    return asr.taps(device) + [RouteTap(device)]


class Judge(asr.Judge):
    """`qwen3_asr`'s gaps, the reference routed as the port routed (see
    `reference/mla_moe.py`), and the routing's own numbers: each forced
    choice's gap below the reference's k-th best biased score."""

    def __init__(self, ckpt, cfg: dict, device, control: str | None = None):
        self.ref = ref.Reference(ckpt, cfg, text_config(cfg), device, control=control)

    def _routing(self, stats: dict) -> dict:
        gaps = torch.cat(stats.get("gaps", [])) if stats.get("gaps") else torch.zeros(0)
        return {"route_gaps": gaps.cpu().numpy(), "flips": sum(stats.get("flips", [])),
                "near_ties": sum(stats.get("near_ties", []))}

    def judge(self, job: dict, keep: bool = False) -> dict:
        if job["served"] and job.get("routes") is None:
            return {"route_mismatch": 1}
        out = super().judge(job, keep=keep)
        if "gaps" in out:
            out.update(self._routing(self.ref.stats))
        return out

    def control(self, job: dict) -> dict:
        """The control in the port's place: its own routing at its precision,
        its first tokens and routing judged against the f32 reference routed
        as it routed."""
        if not job["served"]:
            return {}
        mine = self.ref.logits(job, forced=None)  # its own routing
        chosen = self.ref.stats["chosen"]
        ref_logits = self.ref.logits(job, prec=ref.model.Precision(None), forced=chosen)
        stats = self.ref.stats
        jf = dict(job, firsts=[int(t) for t in mine.argmax(-1).tolist()])
        mask = np.array([f is not None for f in job["firsts"]], dtype=bool)
        g = ref_logits.amax(-1) - ref_logits.gather(
            1, torch.as_tensor(jf["firsts"], device=ref_logits.device)[:, None])[:, 0]
        g = torch.where(torch.as_tensor(mask, device=g.device), g, torch.zeros_like(g))
        g = torch.maximum(g, self.ref._served_gap(ref_logits, job))
        return {"gaps": (g.cpu().numpy(), mask), **self._routing(stats)}


def reference(ckpt, cfg: dict, device, control: str | None = None) -> Judge:
    return Judge(ckpt, cfg, device, control)


def numbers(results: list) -> dict:
    out = asr.numbers(results)
    gaps = [r["route_gaps"] for r in results if "route_gaps" in r]
    d = np.concatenate(gaps) if gaps else np.zeros(0)
    out.update({"route_gap_widest": float(d.max()) if len(d) else None,
                "route_judged": int(len(d)),
                "route_flips": sum(r.get("flips", 0) for r in results),
                "route_near_ties": sum(r.get("near_ties", 0) for r in results),
                "route_mismatches": sum(r.get("route_mismatch", 0) for r in results)})
    return out
