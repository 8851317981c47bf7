"""The port imports nothing of JAX and nothing of the JAX package, and its
copies of the JAX package's JAX-free modules behave as their originals.

1. Source walk: no `import` / `from` of `jax`, `jaxlib` or
   `qwen3_asr_gguf_tpu` anywhere (module level or nested) under
   `qwen3_asr_gguf_tpu_torch/` or in `chip_smoke.py`.
2. A subprocess blocks those names with a `sys.meta_path` finder and imports
   every module of the port.
3. Each copied module is held to its original on seeded inputs: codecs
   bit-equal, a GGUF written by one package read by the other, tokenizer,
   align-text, parsing and presets equal.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import qwen3_asr_gguf_tpu.formats as jformats
import qwen3_asr_gguf_tpu_torch as tpkg
import qwen3_asr_gguf_tpu_torch.formats as tformats
from qwen3_asr_gguf_tpu.formats import quants as jq
from qwen3_asr_gguf_tpu.models import configs as jconfigs
from qwen3_asr_gguf_tpu.schema import ForcedAlignItem as JItem
from qwen3_asr_gguf_tpu.text import align_text as jalign
from qwen3_asr_gguf_tpu.text import parsing as jparsing
from qwen3_asr_gguf_tpu.text import tokenizer as jtok
from qwen3_asr_gguf_tpu.utils import languages as jlang
from qwen3_asr_gguf_tpu_torch.formats import quants as tq
from qwen3_asr_gguf_tpu_torch.models import configs as tconfigs
from qwen3_asr_gguf_tpu_torch.schema import ForcedAlignItem as TItem
from qwen3_asr_gguf_tpu_torch.text import align_text as talign
from qwen3_asr_gguf_tpu_torch.text import parsing as tparsing
from qwen3_asr_gguf_tpu_torch.text import tokenizer as ttok
from qwen3_asr_gguf_tpu_torch.utils import languages as tlang

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "qwen3_asr_gguf_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "qwen3_asr_gguf_tpu")
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
# the modules that are copies: same relative path in both packages
COPIED = ["schema.py", "models/configs.py", "formats/__init__.py", "formats/gguf.py",
          "formats/quants.py", "text/__init__.py", "text/tokenizer.py", "text/parsing.py",
          "text/align_text.py", "text/itn.py", "text/exporters.py", "utils/__init__.py",
          "utils/languages.py", "audio/io.py", "native.py", "audio/split.py",
          "runtime/model_api.py", "formats/__main__.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append((node.lineno, node.module))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """A finder that refuses `jax`, `jaxlib` and `qwen3_asr_gguf_tpu` stands
    first in `sys.meta_path`; every module of the port must still import,
    and `sys.modules` must hold none of those names afterwards."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
import qwen3_asr_gguf_tpu_torch as pkg
pkg.QwenASREngine, pkg.native, pkg.preset("tiny")
assert not [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}], "leaked"
print("imported", len({modules!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"imported {len(modules)}"
    assert len(modules) > 30
    for new in ("ops.qmm", "ops.mlp", "audio.split", "runtime.streaming", "runtime.model_api",
                "runtime.batched", "runtime.microbatch", "cli.transcribe", "export.convert",
                "export.__main__", "formats.__main__", "cli.perplexity", "cli.quant_accuracy",
                "cli.diagnostics", "cli.demo_streaming", "cli.verify_weights", "cli.release",
                "examples.run_asr", "examples.run_aligner", "parallel.sharding",
                "parallel.train", "parallel.launch", "parallel.collectives", "parallel.dryrun",
                "utils.profiling"):
        assert f"qwen3_asr_gguf_tpu_torch.{new}" in modules


@pytest.mark.parametrize("rel", COPIED)
def test_copy_differs_from_its_original_only_in_names(rel):
    """A copy is a copy: the same lines, apart from the package's own name."""
    theirs = (REPO / "qwen3_asr_gguf_tpu" / rel).read_text()
    mine = (PORT / rel).read_text().replace("qwen3_asr_gguf_tpu_torch", "qwen3_asr_gguf_tpu")
    assert mine == theirs


def _rng():
    return np.random.default_rng(20260301)


def _case_quants():
    x = (_rng().standard_normal((8, 512)) * 0.05).astype(np.float32)
    for name in ("quantize_q4_k", "quantize_q6_k", "quantize_q8_0"):
        if hasattr(jq, name):
            np.testing.assert_array_equal(getattr(jq, name)(x), getattr(tq, name)(x))
    for t in (jq.GGML_Q4_K, jq.GGML_Q6_K, jq.GGML_Q8_0, jq.GGML_F16):
        blocks = jq.quantize(x, t)
        np.testing.assert_array_equal(blocks, tq.quantize(x, t))
        np.testing.assert_array_equal(jq.dequantize(blocks, t, x.shape),
                                      tq.dequantize(blocks, t, x.shape))
    jp, tp = jq.pack_q4_direct(x), tq.pack_q4_direct(x)
    for f in ("packed", "scale", "minv"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    np.testing.assert_array_equal(jq.unpack_q4(jp), tq.unpack_q4(tp))
    blocks = jq.quantize(x, jq.GGML_Q4_K)
    jr, tr = jq.repack_q4_k(blocks, x.shape), tq.repack_q4_k(blocks, x.shape)
    for f in ("packed", "scale", "minv"):
        np.testing.assert_array_equal(getattr(jr, f), getattr(tr, f))


def _case_gguf(tmp_path):
    """A file written by one package is read by the other, both ways."""
    rng = _rng()
    tensors = {"a.weight": (rng.standard_normal((4, 256)) * 0.1).astype(np.float32),
               "b.weight": rng.standard_normal((3, 64)).astype(np.float32)}
    for writer_pkg, reader_pkg, fn in ((jformats, tformats, "j.gguf"), (tformats, jformats, "t.gguf")):
        w = writer_pkg.GGUFWriter(str(tmp_path / fn), arch="qwen3vl")
        w.add_u32("qwen3vl.block_count", 3)
        w.add_string("tokenizer.ggml.model", "gpt2")
        w.add_tensor("a.weight", tensors["a.weight"], writer_pkg.quants.GGML_Q4_K)
        w.add_tensor("b.weight", tensors["b.weight"], writer_pkg.quants.GGML_F32)
        w.write()
    assert (tmp_path / "j.gguf").read_bytes() == (tmp_path / "t.gguf").read_bytes()
    for reader_pkg, fn in ((tformats, "j.gguf"), (jformats, "t.gguf")):
        r = reader_pkg.GGUFReader(str(tmp_path / fn))
        assert r.kv["qwen3vl.block_count"] == 3 and r.kv["tokenizer.ggml.model"] == "gpt2"
        np.testing.assert_array_equal(r.tensor("b.weight", dtype=np.float32), tensors["b.weight"])
        np.testing.assert_array_equal(
            r.tensor("a.weight", dtype=np.float32),
            jq.dequantize(jq.quantize(tensors["a.weight"], jq.GGML_Q4_K), jq.GGML_Q4_K, (4, 256)))


STRINGS = ["hello world again", "The quick brown fox, jumps over 13 lazy dogs!",
           "今天天气很好，我们去公园。", "こんにちは、世界。テストです", "안녕하세요 세계입니다",
           "Grüße aus München — café naïve", "mixed 中文 and English 混合 text 42",
           "  spaces\tand\nnewlines  ", "<|im_start|>system<|im_end|>", ""]


def _case_tokenizer():
    jt, tt = jtok.build_synthetic_tokenizer(512), ttok.build_synthetic_tokenizer(512)
    assert jt.tokens == tt.tokens and jt.merge_ranks == tt.merge_ranks
    assert jt.special_tokens == tt.special_tokens
    for s in STRINGS:
        for special in (True, False):
            ids = jt.encode(s, allow_special=special)
            assert ids == tt.encode(s, allow_special=special), s
            assert jt.decode(ids) == tt.decode(ids)
        assert jt.tokenize(s) == tt.tokenize(s)
    for tid in range(0, 512, 7):
        assert jt.token_to_bytes(tid) == tt.token_to_bytes(tid)


def _items(cls):
    return [cls(text=w, start_time=0.1 * i, end_time=0.1 * i + 0.05)
            for i, w in enumerate(["今", "天", "天", "气"])]


def _case_align_text():
    for s in STRINGS:
        for lang in ("Chinese", "English", "Japanese", None):
            assert jalign.tokenize(s, lang) == talign.tokenize(s, lang), (s, lang)
    scores = jalign.korean_scores_from_vocab(["안녕", "세계", "하세요"])
    assert scores == talign.korean_scores_from_vocab(["안녕", "세계", "하세요"])
    assert jalign.tokenize(STRINGS[4], "Korean", ko_scores=scores) \
        == talign.tokenize(STRINGS[4], "Korean", ko_scores=scores)
    rng = _rng()
    for _ in range(20):
        raw = rng.integers(0, 4000, size=int(rng.integers(2, 40))).tolist()
        assert list(jalign.fix_timestamps(raw)) == list(talign.fix_timestamps(raw))
    text = "今天，天气。"
    got = [dataclasses.astuple(i) for i in talign.reconcile(text, _items(TItem))]
    assert got == [dataclasses.astuple(i) for i in jalign.reconcile(text, _items(JItem))]
    assert [dataclasses.astuple(i) for i in talign.reconcile(text, [])] \
        == [dataclasses.astuple(i) for i in jalign.reconcile(text, [])]
    for c in "中a。 ":
        assert jalign.is_cjk_char(c) == talign.is_cjk_char(c)


def _case_parsing():
    outs = ["language Chinese<asr_text>今天天气很好", "language English<asr_text>hello there",
            "<asr_text>no language", "plain text only", "language None<asr_text>", ""]
    for s in outs:
        assert jparsing.parse_asr_output(s) == tparsing.parse_asr_output(s), s
    for langs in (["Chinese", "Chinese"], ["Chinese", "English"], ["", "English"], []):
        assert jparsing.merge_languages(langs) == tparsing.merge_languages(langs)
    for name in ("zh", "chinese", "English", "ja", "ko", None):
        assert jlang.resolve_language(name) == tlang.resolve_language(name)
        if name:
            assert jlang.normalize_language_name(name) == tlang.normalize_language_name(name)


def _case_presets():
    # other test files add presets of their own to either table: hold the
    # packages' own four to each other
    builtin = ["qwen3-asr-0.6b", "qwen3-asr-1.7b", "qwen3-forced-aligner-0.6b", "tiny"]
    assert set(builtin) <= set(jconfigs.PRESETS) and set(builtin) <= set(tconfigs.PRESETS)
    for name in builtin:
        ja, ta = jconfigs.preset(name), tpkg.preset(name)
        assert type(ja).__name__ == type(ta).__name__
        assert dataclasses.asdict(ja) == dataclasses.asdict(ta), name
        for part in ("audio", "text"):
            for f in dataclasses.fields(getattr(ja, part)):
                assert getattr(getattr(ja, part), f.name) == getattr(getattr(ta, part), f.name)
        assert ja.text.lm_head_dim == ta.text.lm_head_dim


def _case_int4_tp_supported():
    """The port's `parallel.sharding.int4_tp_supported` is the JAX package's
    function line for line (a copied function in a module that is not a
    copy), and gives its answers on the presets' decoders at 1 to 8 ways."""
    import inspect

    from qwen3_asr_gguf_tpu.parallel import sharding as jsh
    from qwen3_asr_gguf_tpu_torch.parallel import sharding as tsh

    assert inspect.getsource(tsh.int4_tp_supported) == inspect.getsource(jsh.int4_tp_supported)
    for name in ("qwen3-asr-0.6b", "qwen3-asr-1.7b", "qwen3-forced-aligner-0.6b", "tiny"):
        for tp in range(1, 9):
            assert (tsh.int4_tp_supported(tpkg.preset(name).text, tp)
                    == jsh.int4_tp_supported(jconfigs.preset(name).text, tp)), (name, tp)


CASES = {"quants": _case_quants, "gguf": _case_gguf, "tokenizer": _case_tokenizer,
         "align_text": _case_align_text, "parsing": _case_parsing, "presets": _case_presets,
         "int4_tp_supported": _case_int4_tp_supported}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copied_module_equals_its_original(case, tmp_path):
    fn = CASES[case]
    fn(tmp_path) if case == "gguf" else fn()
