"""Nothing the benchmark runs imports JAX or the JAX package, compared on
the top-level module name as a whole (the port's name begins with the JAX
package's); the reference imports nothing of the port either."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "qwen3_asr_gguf_tpu"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts and ".cache" not in p.parts]


def test_no_jax_side_import_in_sources():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & JAX_SIDE, (path, tops & JAX_SIDE)


def test_reference_imports_nothing_of_the_port():
    """reference/ and the benchmark modules it reaches import neither the
    port nor the JAX side."""
    seen, todo = set(), [p for p in (BENCH / "reference").glob("*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                mods = [node.module] if node.module else [a.name for a in node.names]
                for m in mods:
                    cand = base.joinpath(*m.split(".")).with_suffix(".py")
                    if cand.exists():
                        todo.append(cand)
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (JAX_SIDE | {"qwen3_asr_gguf_tpu_torch"}), (path, tops)
    assert BENCH / "quant.py" in seen and BENCH / "gguf.py" in seen


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qwen3_asr_gguf_tpu_torch.fake", object())
    for name in list(sys.modules):
        if name.split(".")[0] in JAX_SIDE:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qwen3_asr_gguf_tpu.fake", object())
    assert harness.forbidden_modules() == ["qwen3_asr_gguf_tpu"]


def test_a_run_loads_no_jax_side_module(tiny):
    """A whole tiny run in this process leaves no JAX-side module loaded
    (run in a fresh interpreter, so that other tests' imports do not count)."""
    import subprocess
    import textwrap

    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(BENCH.parent)!r})
        sys.path.insert(0, {str(BENCH / 'tests')!r})
        from pathlib import Path
        from conftest import TinyBench, config, STREAM_PARAMS
        torch.set_num_threads(1)
        t = TinyBench(Path({str(tiny.root)!r}) / "sub")
        t.add_config(config("tiny-f32"))
        t.add_cell("s", "tiny-f32", "live_stream", STREAM_PARAMS, "stream_chunk_latency_p90_s", [])
        out = t.run("s", trace=False, seconds=0.5)
        from benchmark import harness
        print(out["correct"], harness.forbidden_modules())
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True []"
