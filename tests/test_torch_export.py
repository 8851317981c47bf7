"""The port's HF converter, its CLI and the GGUF CLI against the JAX
package's (exact: byte-identical files and equal stdout).

- BF16 in `models/safetensors_np.py`: read bit-exactly against
  `safetensors.numpy` + ml_dtypes, and written byte-identically.
- `convert_hf_checkpoint` on HF-layout directories written from a seed by
  `devtools.hf_checkpoint` (BF16 and F32, with and without the `thinker.`
  prefix, and the forced aligner with a short head): every output file
  byte-identical to the JAX converter's at q4_k, q8_0, f16 and f32. Both
  packages quantize through their `formats/quants.py`, which takes the
  native codec where it is built and numpy otherwise; the test asserts that
  both packages see the same codec, so both take the same route.
- `convert_text_llm` on tied and untied transformers Qwen3ForCausalLM
  checkpoints: the GGUF byte-identical to the JAX converter's, and greedy
  tokens through the port's Generator equal to transformers'; a config
  missing a shape key raises KeyError naming it (the JAX converter fills in
  defaults there).
- The export and formats CLIs: the same files and stdout as the JAX CLIs.
"""

import dataclasses
import filecmp
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu.native as jnative
import qwen3_asr_gguf_tpu_torch.models.configs as TC
import qwen3_asr_gguf_tpu_torch.native as tnative
from qwen3_asr_gguf_tpu.export import __main__ as jexport
from qwen3_asr_gguf_tpu.export import convert as jconvert
from qwen3_asr_gguf_tpu.formats import __main__ as jformats_cli
from qwen3_asr_gguf_tpu_torch.devtools.hf_checkpoint import write_hf_checkpoint
from qwen3_asr_gguf_tpu_torch.export import __main__ as texport
from qwen3_asr_gguf_tpu_torch.export import convert as tconvert
from qwen3_asr_gguf_tpu_torch.formats import __main__ as tformats_cli
from qwen3_asr_gguf_tpu_torch.models import safetensors_np as S
# hidden 256: the q4_k and q8_0 paths quantize every decoder matrix (at the
# `tiny` preset's 48 they fall back to f16)
from test_torch_fidelity import PRESET

QUANTS = ("q4_k", "q8_0", "f16", "f32")
ALIGNER_PRESET = "tiny-ppl-256-aligner"  # a 40-row head: classify_num from its shape
for _mod in (C, TC):
    _base = _mod.PRESETS[PRESET]
    _mod.PRESETS.setdefault(ALIGNER_PRESET, dataclasses.replace(
        _base, text=dataclasses.replace(_base.text, classify_num=40)))


def test_both_packages_quantize_through_the_same_codec():
    assert jnative.available() == tnative.available()


# --------------------------------------------------------------------------
# BF16
# --------------------------------------------------------------------------


def _awkward_f32(seed: int) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal((37, 41)) * 5).astype(np.float32)
    x.flat[:6] = [np.nan, np.inf, -np.inf, -0.0, 1e-40, 3.0e38]  # NaN, infs, subnormal, overflow
    return x


def test_bf16_read_is_bit_exact(tmp_path):
    """A BF16 tensor written by safetensors (ml_dtypes bfloat16) reads back
    as the f32 that ml_dtypes widens it to, bit for bit; `bf16_bits` rounds
    as ml_dtypes does (ties to even)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from safetensors.numpy import load_file, save_file

    x = _awkward_f32(0)
    ref_bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(S.bf16_bits(x), ref_bits)
    save_file({"w": x.astype(ml_dtypes.bfloat16), "b": x[:3]}, str(tmp_path / "a.safetensors"))
    got, _ = S.load_file(str(tmp_path / "a.safetensors"))
    want = load_file(str(tmp_path / "a.safetensors"))
    assert got["w"].dtype == np.float32 and got["w"].shape == x.shape
    np.testing.assert_array_equal(got["w"].view(np.uint32),
                                  want["w"].astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(got["b"].view(np.uint32), x[:3].view(np.uint32))
    np.testing.assert_array_equal(S.widen_bf16(ref_bits).view(np.uint32),
                                  want["w"].astype(np.float32).view(np.uint32))


def test_bf16_write_is_byte_identical_to_safetensors(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from safetensors.numpy import save_file

    x = _awkward_f32(1)
    ints = np.arange(12, dtype=np.int32).reshape(3, 4)
    save_file({"w": x.astype(ml_dtypes.bfloat16), "i": ints, "f": x[:2]},
              str(tmp_path / "ref.safetensors"), metadata={"k": "v"})
    S.save_file({"w": S.bf16_bits(x), "i": ints, "f": x[:2]}, str(tmp_path / "mine.safetensors"),
                metadata={"k": "v"}, bf16={"w"})
    ref, mine = (tmp_path / f"{n}.safetensors" for n in ("ref", "mine"))
    assert ref.read_bytes() == mine.read_bytes()
    with pytest.raises(TypeError, match="BF16 takes uint16"):
        S.save_file({"w": x}, str(tmp_path / "bad.safetensors"), bf16={"w"})


# --------------------------------------------------------------------------
# convert_hf_checkpoint
# --------------------------------------------------------------------------


def _same_files(a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


@pytest.mark.parametrize("preset,prefix,bf16", [
    (PRESET, "thinker.", True), (PRESET, "", True), (PRESET, "thinker.", False),
    (ALIGNER_PRESET, "thinker.", True),
], ids=["bf16-thinker-prefix", "bf16-raw-thinker", "f32-thinker-prefix", "aligner-bf16"])
def test_convert_hf_checkpoint_files_equal_jax(tmp_path, preset, prefix, bf16):
    aligner = preset == ALIGNER_PRESET
    hf = write_hf_checkpoint(str(tmp_path / "hf"), preset, seed=5, bf16=bf16, prefix=prefix)
    for quant in QUANTS:
        t = tconvert.convert_hf_checkpoint(str(hf), str(tmp_path / "t"), quant=quant,
                                           aligner=aligner)
        j = jconvert.convert_hf_checkpoint(str(hf), str(tmp_path / "j"), quant=quant,
                                           aligner=aligner)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    _same_files(tmp_path / "t", tmp_path / "j")
    assert len(list((tmp_path / "t").glob("*.gguf"))) == len(QUANTS)
    assert t.text.classify_num == (40 if aligner else None)
    assert t.audio.n_window == 100  # HF's 50, doubled on import


def test_convert_refuses_other_conv_windows(tmp_path):
    hf = write_hf_checkpoint(str(tmp_path / "hf"), PRESET, seed=5)
    cfg = json.loads((hf / "config.json").read_text())
    cfg["thinker_config"]["audio_config"]["n_window"] = 40
    (hf / "config.json").write_text(json.dumps(cfg))
    for conv in (tconvert, jconvert):
        with pytest.raises(ValueError, match="n_window=40"):
            conv.convert_hf_checkpoint(str(hf), str(tmp_path / "out"), quant="f32")


# --------------------------------------------------------------------------
# convert_text_llm
# --------------------------------------------------------------------------


def _tiny_qwen3(tmp_path: Path, *, tie: bool) -> Path:
    """A transformers Qwen3ForCausalLM checkpoint (the one of
    tests/test_convert_llm.py)."""
    pytest.importorskip("transformers")
    from transformers.models.qwen3 import Qwen3Config, Qwen3ForCausalLM

    cfg = Qwen3Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, intermediate_size=128, rope_theta=5_000_000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=tie, attention_dropout=0.0,
    )
    torch.manual_seed(7 if tie else 8)
    model = Qwen3ForCausalLM(cfg).eval()
    d = tmp_path / ("hf_tied" if tie else "hf_untied")
    model.save_pretrained(str(d), safe_serialization=True)
    return d


def _torch_greedy(hf_dir: Path, prompt: list[int], n: int) -> list[int]:
    from transformers.models.qwen3 import Qwen3ForCausalLM

    model = Qwen3ForCausalLM.from_pretrained(str(hf_dir)).eval()
    ids = torch.tensor([prompt], dtype=torch.long)
    out = []
    with torch.no_grad():
        for _ in range(n):
            t = int(model(ids).logits[0, -1].argmax())
            out.append(t)
            ids = torch.cat([ids, torch.tensor([[t]], dtype=torch.long)], dim=1)
    return out


@pytest.mark.parametrize("tie", [True, False], ids=["tied-head", "untied-head"])
def test_convert_text_llm_equals_jax_and_transformers(tmp_path, tie):
    """The GGUF is byte-identical to the JAX converter's; through the port's
    Generator (f32) its greedy tokens equal transformers' (exact argmax; the
    test of tests/test_convert_llm.py)."""
    from qwen3_asr_gguf_tpu_torch.models import params as P
    from qwen3_asr_gguf_tpu_torch.runtime.generate import Generator

    hf = _tiny_qwen3(tmp_path, tie=tie)
    for quant in ("f32", "q8_0"):
        cfg = tconvert.convert_text_llm(str(hf), str(tmp_path / f"t.{quant}.gguf"), quant=quant)
        jconvert.convert_text_llm(str(hf), str(tmp_path / f"j.{quant}.gguf"), quant=quant)
        assert (tmp_path / f"t.{quant}.gguf").read_bytes() == \
            (tmp_path / f"j.{quant}.gguf").read_bytes()
    assert cfg.num_layers == 2 and cfg.vocab_size == 256 and cfg.head_dim == 16

    lcfg, params, _ = P.load_decoder_gguf(str(tmp_path / "t.f32.gguf"), precision="f32")
    gen = Generator(params, lcfg, n_ctx=128, eos_ids=(255,), cache_dtype=torch.float32,
                    block=8, device="cpu")
    prompt = np.asarray([3, 17, 250, 42, 9])
    state = gen.start_spliced(prompt, np.zeros(len(prompt), bool),
                              torch.zeros(1, lcfg.hidden_size), temperature=0.0, seed=0)
    got, state, _, _ = gen.decode_block(state, temperature=0.0)  # from the prefill's token
    want = _torch_greedy(hf, prompt.tolist(), len(got))
    want = [t for t in want[: len(got)] if t != 255]
    assert got[: len(want)] == want and len(want) >= 6


_SHAPE_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
               "num_key_value_heads", "intermediate_size", "rms_norm_eps", "rope_theta")


@pytest.mark.parametrize("key", _SHAPE_KEYS)
def test_convert_text_llm_missing_shape_key_raises(tmp_path, key):
    """The JAX converter would fill in a 1.7B default here; the port
    refuses before reading any tensor."""
    cfg = {"architectures": ["Qwen3ForCausalLM"], "head_dim": 16,
           **{k: 1 for k in _SHAPE_KEYS}}
    del cfg[key]
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match=key):
        tconvert.convert_text_llm(str(tmp_path), str(tmp_path / "x.gguf"))


def test_convert_text_llm_head_dim_defaults_as_hf(tmp_path):
    """head_dim is the one key HF may omit: it then defaults to 128, as in
    transformers' Qwen3Config and in the JAX converter."""
    transformers = pytest.importorskip("transformers")
    assert transformers.Qwen3Config(hidden_size=64, num_attention_heads=4).head_dim == 128
    hf = _tiny_qwen3(tmp_path, tie=True)
    cfg = json.loads((hf / "config.json").read_text())
    del cfg["head_dim"]
    (hf / "config.json").write_text(json.dumps(cfg))
    t = tconvert.convert_text_llm(str(hf), str(tmp_path / "t.gguf"), quant="f32")
    j = jconvert.convert_text_llm(str(hf), str(tmp_path / "j.gguf"), quant="f32")
    assert t.head_dim == j.head_dim == 128
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_non_qwen3_arch_refused(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["LlamaForCausalLM"]}))
    with pytest.raises(ValueError, match="unsupported text-LLM architecture"):
        tconvert.convert_text_llm(str(tmp_path), str(tmp_path / "x.gguf"))


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def _run(main, argv, cwd: Path, monkeypatch, capsys) -> tuple[int, str]:
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--synthetic", "--preset", "tiny", "--quant", "f16"],
    ["--synthetic", "--preset", "tiny", "--quant", "q4_k", "--aligner", "--seed", "1"],
    ["--hf", "HF", "--quant", "q8_0"],
], ids=["synthetic", "synthetic-aligner", "hf"])
def test_export_cli_writes_the_jax_files(tmp_path, monkeypatch, capsys, argv):
    """`python -m qwen3_asr_gguf_tpu_torch.export` and the JAX CLI, each in
    a directory of its own with the same relative paths: the same stdout
    and byte-identical files."""
    if "HF" in argv:
        write_hf_checkpoint(str(tmp_path / "HF"), PRESET, seed=2)
        argv = [str(tmp_path / "HF") if a == "HF" else a for a in argv]
    outs = [_run(mod.main, argv + ["--out", "model"], tmp_path / name, monkeypatch, capsys)
            for mod, name in ((texport, "t"), (jexport, "j"))]
    assert outs[0] == outs[1] and outs[0][0] == 0
    _same_files(tmp_path / "t" / "model", tmp_path / "j" / "model")


def test_export_cli_llm_needs_hf(capsys):
    with pytest.raises(SystemExit):
        texport.main(["--synthetic", "--llm", "--out", "x"])
    assert "--llm requires --hf" in capsys.readouterr().err


FORMATS_WRITE = {"requant", "set-metadata", "new-metadata", "endian"}
FORMATS_CASES = {
    "dump": ["dump", "m.gguf"],
    "dump-tensors": ["dump", "m.gguf", "--tensors"],
    "requant": ["requant", "m.gguf", "out.gguf", "--quant", "q4_k"],
    "hash": ["hash", "m.gguf"],
    "set-metadata": ["set-metadata", "m.gguf", "out.gguf", "--set", "general.name=tiny",
                     "--set", "qwen3vl.block_count=3"],
    "new-metadata": ["new-metadata", "m.gguf", "out.gguf", "--set", "x.flag=true",
                     "--remove", "tokenizer.ggml.pre"],
    "endian": ["endian", "m.gguf", "out.gguf", "--to", "big"],
}


@pytest.fixture(scope="module")
def tiny_f32_gguf(tmp_path_factory) -> bytes:
    from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

    d = tmp_path_factory.mktemp("fmt")
    make_synthetic_checkpoint(str(d), PRESET, quant="f32", seed=4)
    return (d / "qwen3_asr_llm.f32.gguf").read_bytes()


@pytest.mark.parametrize("case", sorted(FORMATS_CASES))
def test_formats_cli_equals_jax(tmp_path, monkeypatch, capsys, tiny_f32_gguf, case):
    """Each subcommand on a tiny f32 GGUF: the same stdout, return code and
    output file bytes as the JAX CLI."""
    results = []
    for mod, name in ((tformats_cli, "t"), (jformats_cli, "j")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "m.gguf").write_bytes(tiny_f32_gguf)
        results.append(_run(mod.main, FORMATS_CASES[case], tmp_path / name, monkeypatch, capsys))
    assert results[0] == results[1] and results[0][0] == 0 and results[0][1]
    out = [tmp_path / n / "out.gguf" for n in ("t", "j")]
    assert out[0].exists() == out[1].exists() == (case in FORMATS_WRITE)
    if out[0].exists():
        assert out[0].read_bytes() == out[1].read_bytes()
