"""The sparse-expert architecture (`architectures/mla_moe.py`): its tiny
checkpoint written and read back by the port, a whole run of a tiny cell
through the harness on the CPU (writer, port, tap, reference, verdict), the
roofline pieces at Moonlight-16B-A3B's published widths, the new readers
on a missing trace or counter, and the configuration and cell files."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import q4_0 as q40
from benchmark import roofline_mla_moe as rmm

from .conftest import BENCH, ENGINE, FILE_PARAMS, TINY_AUDIO

CELL = "file-moonlight-a3b"
TINY = {"vocab_size": 512, "hidden_size": 256, "num_hidden_layers": 3,
        "num_attention_heads": 2, "num_key_value_heads": 2, "q_lora_rank": None,
        "kv_lora_rank": 256, "qk_nope_head_dim": 32, "qk_rope_head_dim": 32, "v_head_dim": 128,
        "intermediate_size": 256, "moe_intermediate_size": 64, "n_routed_experts": 8,
        "n_shared_experts": 2, "num_experts_per_tok": 3, "first_k_dense_replace": 1,
        "routed_scaling_factor": 2.446, "norm_topk_prob": True, "rms_norm_eps": 1e-5,
        "rope_theta": 50000.0, "tie_word_embeddings": False}


def tiny_config(name: str = "tiny-mla") -> dict:
    return {"name": name, "source": "test", "architecture": "mla_moe", **TINY,
            "model": {"audio": dict(TINY_AUDIO, output_dim=TINY["hidden_size"])},
            "weights_seed": 0, "assumed": [], "engine": dict(ENGINE, precision="int4")}


@pytest.fixture(scope="module")
def arch():
    return harness.load_module(BENCH / "architectures" / "mla_moe.py", "bench_arch_mla_moe")


def test_tiny_checkpoint_reads_back_in_the_port(tmp_path, arch):
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.models.mla_config import MLAMoEConfig
    from qwen3_asr_gguf_tpu_torch.ops import moe

    cfg = tiny_config()
    d, written = arch.checkpoint(cfg, tmp_path, "cpu")
    assert written and not arch.checkpoint(cfg, tmp_path, "cpu")[1]
    want = MLAMoEConfig(**arch.text_config(cfg))
    assert P.load_thinker_config(str(d)).text == want
    got, params, _ = P.load_decoder_gguf(str(d / arch.DECODER_FN), precision="int4")
    for f in dataclasses.fields(MLAMoEConfig):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a == pytest.approx(b, rel=1e-6) if isinstance(b, float) else a == b, f.name
    # the port's expert planes hold the reference decoder's q4_0 values; the
    # correction bias is drawn, not 0
    from benchmark.reference import mla_moe as ref

    dec = ref.Decoder(d / arch.DECODER_FN, arch.text_config(cfg), "int4", "cpu")
    lw = dec.layer(2)
    x = params["layers"][2]["experts"]
    e = TINY["n_routed_experts"]
    torch.testing.assert_close(moe.dequant(x.gate_qs[:e], x.gate_d[:e]), lw["gate_exps"],
                               rtol=0, atol=0)
    torch.testing.assert_close(moe.dequant(x.down_qs[e:], x.down_d[e:]),
                               lw["down_shexp"].reshape(TINY["hidden_size"], 2, -1)
                               .transpose(0, 1), rtol=0, atol=0)
    torch.testing.assert_close(params["layers"][2]["router_bias"], lw["router_bias"])
    assert float(lw["router_bias"].abs().min()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_balanced_bias_spreads_a_skewed_router(arch, seed):
    """Scores whose rows share a direction (one expert first on nearly every
    row): the balanced bias gives each expert its share of the top-k picks
    within a few rows, where none gives the busiest expert several times
    its share."""
    g = torch.Generator().manual_seed(seed)
    n, e, k = 600, 16, 3
    common = torch.randn(e, generator=g) * 2.0
    scores = torch.sigmoid(common + 0.3 * torch.randn(n, e, generator=g))
    bias, before, after = arch.balance_bias(scores, k)
    load = torch.bincount(torch.topk(scores + bias, k, -1).indices.reshape(-1), minlength=e)
    assert before > 3.0
    assert after == pytest.approx(float(load.max()) / (n * k / e))
    assert after <= 1.1 and int(load.min()) >= 0.9 * n * k / e


def test_q4_0_codec_matches_the_ports(arch):
    from qwen3_asr_gguf_tpu_torch.formats import q4_0 as port

    x = torch.randn(6, 96, generator=torch.Generator().manual_seed(3))
    got = q40.encode_q4_0(x).numpy()
    np.testing.assert_array_equal(got, port.quantize_q4_0(x.numpy()))
    np.testing.assert_array_equal(q40.decode_q4_0(torch.from_numpy(got), 96).numpy(),
                                  port.dequantize_q4_0(got, (6, 96)))


def test_tiny_cell_runs_through_the_harness(tiny):
    """Writer, port (int4, plain kernels on the CPU), tap, reference and
    verdict: `correct` with the limits of a tiny model, the new readers
    reading the run."""
    tiny.add_config(tiny_config())
    tiny.add_cell("moe", "tiny-mla", "engine_file_mla_moe", dict(FILE_PARAMS, clip_s=4.0),
                  "rtf", ["mfu.moe", "decode_ms_per_token.moe", "expert_load.moe",
                          "moe_prefill_ms.moe", "expert_roofline.moe"], gap=0.05)
    spec_path = tiny.bench / "workloads" / "moe.json"
    spec = json.loads(spec_path.read_text())
    spec["limits"]["route_gap_widest"] = 5e-3
    spec_path.write_text(json.dumps(spec))
    out = tiny.run("moe", trace=False)
    assert out["correct"], out["checks"]
    assert out["checks"]["judged"]["value"] >= 4
    assert out["checks"]["route_mismatches"]["value"] == 0
    assert "rtf" in out["metrics"] and "setup_s" in out["metrics"]


def test_roofline_pieces_at_published_widths(arch):
    cfg = harness.Cell(BENCH, CELL).config
    t = arch.text_config(cfg)
    c = rmm.counts(t)
    # q 3072 x 2048, kv_a 576 x 2048, kv_b 4096 x 512, o 2048 x 2048, each layer
    assert c["attention"] == 27 * (3072 * 2048 + 576 * 2048 + 4096 * 512 + 2048 * 2048)
    assert c["active_experts"] == 26 * 8 * 3 * 1408 * 2048  # 6 routed + 2 shared halves
    assert c["head"] == 163840 * 2048 and c["router"] == 26 * 64 * 2048
    step = rmm.decode_step(t, 1000)
    weights = c["attention"] + c["dense_mlp"] + c["active_experts"] + c["head"]
    latent = 1000 * 576 * 2 * 27
    assert step.bytes == pytest.approx(weights * 144 / 256 + 4 * c["router"] + latent
                                       + rmm._act_bytes_per_token(t))
    assert 1.45e9 < step.bytes < 1.55e9  # 1.50 GB: 0.45 ms at 3.35 TB/s
    assert step.seconds()[1] == "bytes"
    routed = 26 * 6 * 3 * 1408 * 2048 * 144 / 256
    assert routed == pytest.approx(0.76e9, rel=0.01)
    assert rmm.expert_step(t).bytes > routed
    p = rmm.prefill(t, 700, 0)
    assert p.flops > 2 * 700 * (c["attention"] + c["active_experts"])


@pytest.mark.parametrize("metric", ["expert_roofline", "moe_prefill_ms", "expert_load"])
def test_new_readers_give_none_without_a_trace_or_counter(metric, monkeypatch):
    from benchmark import spans

    read = harness.Cell(BENCH, CELL).reader(f"{metric}.moe")
    monkeypatch.setattr(spans, "records", lambda: [])
    bare = {"cell": CELL, "summary": {}, "least_s": 0.0, "least_split": {},
            "traced_least_s": None, "traced_units": [], "trace": None}
    assert read(bare) is None
    traced = dict(bare, summary={"expert_least_s": [1e-3, 2e-3], "moe_experts": 64},
                  traced_units=[1], trace={"busy_s": 1.0, "window_s": 2.0, "breakdown": {
                      "device_ops": [["void q4k_matvec_one_kernel<false>(...)", 0.1]],
                      "idle_gaps": []}})
    assert read(traced) is None  # no kernel 8 among the top ops; no span, no counter


def test_expert_roofline_reads_kernel8(monkeypatch):
    read = harness.Cell(BENCH, CELL).reader("expert_roofline.moe")
    ctx = {"cell": CELL, "summary": {"expert_least_s": [1e-3, 3e-3]}, "traced_units": [1],
           "trace": {"busy_s": 1.0, "window_s": 2.0, "breakdown": {"device_ops": [
               ["void (anonymous namespace)::moe_gate_up_kernel<true>(void const*, ...)", 4e-3],
               ["void (anonymous namespace)::moe_down_kernel(float const*, ...)", 2e-3]],
               "idle_gaps": []}}}
    assert read(ctx) == pytest.approx(50.0)


def test_config_and_cell_files(arch):
    from qwen3_asr_gguf_tpu_torch.models.configs import preset

    contract = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = harness.Cell(BENCH, CELL)
    assert cell.config["architecture"] == "mla_moe" and cell.arch.__name__.endswith("mla_moe")
    entry = next(c for c in contract["configs"] if c["name"] == cell.spec["config"])
    assert entry["reduced"] == [] and cell.config["source"] == entry["source"]
    t = arch.text_config(cell.config)
    port = dataclasses.asdict(preset("qwen3-asr-1.7b-moonlight-16b-a3b").text)
    assert {k: port[k] for k in t} == t
    assert cell.config["model"]["audio"] == harness.Cell(BENCH, "file-1.7b").config["model"][
        "audio"]
    assert cell.spec["params"] == harness.Cell(BENCH, "file-1.7b").spec["params"]
    assert cell.config["engine"] == harness.Cell(BENCH, "file-1.7b").config["engine"]
    assert set(cell.spec["limits"]) == {"gap_widest", "gap_mean", "route_gap_widest", "min_judged"}


def test_plan_routes_maps_the_stream():
    """Two calls of two chunks (prefills of T 8 and 4, blocks of 3 steps, two
    MoE layers): each reference row gets the row its computation routed:
    chunk 0's prefill for the reused prefix, chunk i's prefill, then its
    steps, one row per MoE layer each."""
    from benchmark.architectures import mla_moe as arch

    n_moe, block = 2, 3
    stream, prefills = [], []
    for call in range(2):
        for chunk, t in enumerate((8, 4)):
            prefills += [t] * n_moe
            stream += [("pre", call, chunk, layer, r) for layer in range(n_moe) for r in range(t)]
            stream += [("dec", call, chunk, layer, s) for s in range(block)
                       for layer in range(n_moe)]
    rows = np.arange(len(stream))[:, None]
    job = {"served": [1, 2, 3], "route_plan": {
        "prior": [(2, 2 * block)], "n_moe": n_moe, "block": block, "P": [7, 6],
        "start": [0, 3], "chunk": 1}}
    got = arch.plan_routes(job, rows, prefills)
    assert len(got) == n_moe
    for layer in range(n_moe):
        labels = [stream[int(i)] for i in got[layer][:, 0]]
        assert labels == ([("pre", 1, 0, layer, r) for r in range(3)]
                          + [("pre", 1, 1, layer, r) for r in range(3)]
                          + [("dec", 1, 1, layer, s) for s in range(2)])
    assert arch.plan_routes(dict(job, served=list(range(5))), rows, prefills) is None
