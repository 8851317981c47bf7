"""The fidelity gates through the port, on the CPU at tiny sizes (the JAX
package runs them only in its slow lane: tests/test_fidelity_gates.py,
tests/test_verify_weights.py).

- `cli/perplexity.compute_ppl`: the two cases of tests/test_fidelity_gates.py
  on its `tiny-ppl-256` preset (q4_k against f32 of one file; q4_k against
  f16 storage), each |delta| <= 9% (the reference's bar), and the port
  against the JAX `compute_ppl` on the same ids within 1e-4 relative (both
  f32 on the CPU; JAX jits the window, the port runs eagerly).
- `cli/quant_accuracy.main`: exit code 0 and the JAX report's keys, cosines
  within 1e-3 and MAEs within 1e-5; the quantized encoders it loads
  (`load_encoder_quantized`) bit-equal to the JAX `quantize_encoder_params`.
- `cli/verify_weights.verify` on a tiny HF-layout directory: convert, load
  and both fidelity stages PASS; the oracle stage SKIP when the reference
  modeling is missing (the detail names the path), on ImportError and on
  MemoryError, and FAIL on any other exception, a RuntimeError mentioning
  "import" included.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu.models.params as JP
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.cli import perplexity as jppl
from qwen3_asr_gguf_tpu.cli import quant_accuracy as jqa
from qwen3_asr_gguf_tpu_torch.cli import perplexity as tppl
from qwen3_asr_gguf_tpu_torch.cli import quant_accuracy as tqa
from qwen3_asr_gguf_tpu_torch.cli import verify_weights as tvw
from qwen3_asr_gguf_tpu_torch.devtools.hf_checkpoint import write_hf_checkpoint
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import params as TP
from qwen3_asr_gguf_tpu_torch.ops.qtensor import Int8Weight, Q4Weight
from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the preset of tests/test_fidelity_gates.py, registered in both tables (hidden
# 256: every decoder matrix is whole q4_k superblocks); the other PR 10 test
# files import it from here
PPL_BAR = 0.09
PPL_JAX_RTOL = 1e-4
COSINE_TOL = 1e-3
MAE_TOL = 1e-5

PRESET = "tiny-ppl-256"
for _mod in (C, TC):
    _mod.PRESETS.setdefault(PRESET, _mod.ThinkerConfig(
        audio=_mod.AudioEncoderConfig(
            num_mel_bins=128, d_model=64, encoder_layers=1,
            encoder_attention_heads=4, encoder_ffn_dim=128,
            downsample_hidden_size=32, output_dim=256,
        ),
        text=_mod.TextDecoderConfig(
            vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=64, intermediate_size=512,
        ),
    ))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tiny-ppl-256 with its decoder at q4_k and at f16 (same weights)."""
    d = tmp_path_factory.mktemp("ppl_ckpt")
    make_synthetic_checkpoint(str(d), PRESET, quant="q4_k")
    make_synthetic_checkpoint(str(d), PRESET, quant="f16")
    return d


def test_presets_agree():
    assert dataclasses.asdict(C.preset(PRESET)) == dataclasses.asdict(TC.preset(PRESET))


def test_q4k_ppl_delta_within_reference_bar(ckpt):
    """PPL(q4_k) against PPL(f32 dequant of the same file): the case of
    tests/test_fidelity_gates.py, on the same ids."""
    ids = np.random.default_rng(0).integers(0, 500, size=600).astype(np.int32)
    q4k = str(ckpt / "qwen3_asr_llm.q4_k.gguf")
    ppl_f32 = tppl.compute_ppl(q4k, ids, precision="f32", window=128, device="cpu")
    ppl_q = tppl.compute_ppl(q4k, ids, precision="q4_k", window=128, device="cpu")
    assert np.isfinite(ppl_f32) and np.isfinite(ppl_q)
    assert abs(ppl_q - ppl_f32) / ppl_f32 <= PPL_BAR, (ppl_f32, ppl_q)


def test_q4k_vs_f16_storage_ppl_delta(ckpt):
    """The same weights stored as f16 and as q4_k, both scored at f32."""
    ids = np.random.default_rng(1).integers(0, 500, size=600).astype(np.int32)
    ppl_f16 = tppl.compute_ppl(str(ckpt / "qwen3_asr_llm.f16.gguf"), ids, precision="f32",
                               window=128, device="cpu")
    ppl_q = tppl.compute_ppl(str(ckpt / "qwen3_asr_llm.q4_k.gguf"), ids, precision="f32",
                             window=128, device="cpu")
    assert abs(ppl_q - ppl_f16) / ppl_f16 <= PPL_BAR, (ppl_f16, ppl_q)


@pytest.mark.parametrize("precision", ["q4_k", "f32", "int4"])
def test_compute_ppl_equals_jax(ckpt, precision):
    """Same file, same ids (a short last window, zero-padded): relative
    difference <= 1e-4."""
    ids = np.random.default_rng(2).integers(0, 500, size=300).astype(np.int32)
    llm = str(ckpt / "qwen3_asr_llm.q4_k.gguf")
    got = tppl.compute_ppl(llm, ids, precision=precision, window=128, device="cpu")
    want = jppl.compute_ppl(llm, ids, precision=precision, window=128)
    assert abs(got - want) / want <= PPL_JAX_RTOL, (got, want)


def test_perplexity_cli_report(ckpt, tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog. " * 40, encoding="utf-8")
    argv = ["--llm", str(ckpt / "qwen3_asr_llm.q4_k.gguf"), "--text", str(corpus),
            "--compare", "f32", "--window", "128", "--max-tokens", "300"]
    assert tppl.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jppl.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() and got["tokens"] == want["tokens"]
    for key in ("ppl_q4_k", "ppl_f32"):
        assert abs(got[key] - want[key]) / want[key] <= PPL_JAX_RTOL + 1e-4  # 4-decimal rounding
    assert abs(got["delta_pct"]) <= 100 * PPL_BAR


@pytest.mark.parametrize("kind", ["int4", "int8"])
def test_quantized_encoder_equals_jax_quantize_encoder_params(ckpt, kind):
    """`load_encoder_quantized` gives the weights of the JAX
    `quantize_encoder_params` on the same f32 master, bit for bit."""
    path = str(ckpt / "qwen3_asr_encoder.safetensors")
    _, master = JP.load_encoder_safetensors(path, as_numpy=True)
    jq = JP.quantize_encoder_params(master, kind=kind)
    want = TP.from_jax_params(jax.tree.map(np.asarray, jq))
    _, got = TP.load_encoder_quantized(path, kind=kind)

    def same(a, b, where):
        if isinstance(a, (Q4Weight, Int8Weight)):
            assert type(a) is type(b), where
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), where

    assert sorted(got) == sorted(want)
    for name in got:
        if name == "layers":
            for i, (gl, wl) in enumerate(zip(got["layers"], want["layers"], strict=True)):
                assert sorted(gl) == sorted(wl)
                for k in gl:
                    same(gl[k], wl[k], f"layers.{i}.{k}")
        else:
            same(got[name], want[name], name)


def test_quant_accuracy_report_equals_jax(ckpt, capsys):
    assert tqa.main(["--model-dir", str(ckpt), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    jrc = jqa.main(["--model-dir", str(ckpt)])
    want = json.loads(capsys.readouterr().out)
    assert jrc == 0 and list(got) == list(want)
    for key, value in want.items():
        if key.endswith("_cosine"):
            assert abs(got[key] - value) <= COSINE_TOL, key
        elif key.endswith("_mae"):
            assert abs(got[key] - value) <= MAE_TOL, key
        elif key.endswith("_pass"):
            assert got[key] is value is True, key
    assert got["encoder_int4_cosine"] >= tqa.ENCODER_BAR
    assert got["decoder_hidden_cosine"] >= tqa.DECODER_BAR


@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    return write_hf_checkpoint(str(tmp_path_factory.mktemp("vw") / "hf"), PRESET, seed=9)


def test_verify_weights_stages_pass(tiny_hf, tmp_path, capsys):
    rep = tvw.verify(str(tiny_hf), str(tmp_path / "model"), quant="q4_k", seconds=2.0,
                     language="English", max_new=8, device="cpu")
    stages = {s: (st, d) for s, st, d in rep.rows}
    for stage in ("convert", "load", "fidelity/quant-cosine", "fidelity/ppl-delta"):
        assert stages[stage][0] == "PASS", stages
    assert stages["oracle"] == ("SKIP", f"reference modeling not found: {tvw.REF_TB}")
    assert not rep.failed
    assert (tmp_path / "model" / "qwen3_asr_llm.f16.gguf").exists()
    assert (tmp_path / "model" / "qwen3_asr_llm.q4_k.gguf").exists()


def test_verify_weights_reference_modeling_looked_for_in_checkout():
    """The oracle's modeling is looked for only inside the checkout, so what
    lies beside it cannot be imported or change the oracle's verdict."""
    repo = Path(tvw.__file__).resolve().parents[2]
    ref = Path(tvw.REF_TB)
    assert ref.is_absolute() and ref.is_relative_to(repo) and ".." not in ref.parts
    assert ref.relative_to(repo).parts == ("reference", "qwen_asr", "core",
                                           "transformers_backend")


@pytest.mark.parametrize("error,status", [
    (ImportError("No module named 'nagisa'"), "SKIP"),
    (ModuleNotFoundError("No module named 'ref_tb.modeling_qwen3_asr'"), "SKIP"),
    (MemoryError("host RAM"), "SKIP"),
    (RuntimeError("could not import weights: shape mismatch"), "FAIL"),
    (ValueError("tokenizer import table broken"), "FAIL"),
], ids=["ImportError", "ModuleNotFoundError", "MemoryError", "RuntimeError-import", "ValueError"])
def test_verify_weights_oracle_triage_by_type(tiny_hf, tmp_path, monkeypatch, error, status):
    """Only ImportError (ModuleNotFoundError included) and MemoryError are
    SKIP; the JAX tool's `"import" in repr(e)` test would call the last two
    SKIP as well."""
    monkeypatch.setattr(tvw, "REF_TB", str(tmp_path))

    def oracle(*args, **kw):
        raise error

    monkeypatch.setattr(tvw, "_oracle_transcript", oracle)
    rep = tvw.verify(str(tiny_hf), str(tmp_path / "model"), quant="f16", seconds=1.0,
                     language="English", max_new=4, skip_fidelity=True, device="cpu")
    stages = {s: st for s, st, _ in rep.rows}
    assert stages["oracle"] == status and rep.failed == (status == "FAIL")
    assert stages["convert"] == stages["load"] == "PASS" and stages["fidelity"] == "SKIP"
