"""The port's transcription CLI (`qwen3_asr_gguf_tpu_torch.cli.transcribe`)
against the JAX package's on the CPU: the same checkpoint (tests/
test_golden.py's f32 `tiny` ASR and aligner), the same wav and the same
flags must write the same `.txt`, `.srt` and `.json`, byte for byte.

Neither CLI has a flag for the token budget, and random weights run until the
repetition breaker, whose retries sample with each framework's own random
numbers; so both CLIs get one engine setting from the test (max_new_tokens
12, below the breaker's 16-token window), in their own schema modules.
"""

import dataclasses
import sys

import numpy as np
import pytest

import qwen3_asr_gguf_tpu.schema as jax_schema
import qwen3_asr_gguf_tpu_torch.schema as port_schema
from qwen3_asr_gguf_tpu.cli import transcribe as jax_cli
from qwen3_asr_gguf_tpu_torch.cli import transcribe as port_cli
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint

from test_torch_engine import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _audio
from test_torch_serve import _wav


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_tiny"))
    make_synthetic_checkpoint(d, "tiny", quant="f16", seed=0)
    make_synthetic_checkpoint(d, "tiny", quant="f16", aligner=True, seed=1)
    return d


def _short_budget(monkeypatch, schema):
    @dataclasses.dataclass
    class Config(schema.ASREngineConfig):
        max_new_tokens: int = 12
        decode_block: int = 8

    monkeypatch.setattr(schema, "ASREngineConfig", Config)


def _args(model_dir, wav, out, *extra):
    return [str(wav), "--model-dir", model_dir, "--prec", "f32", "--chunk-size", "2",
            "--n-ctx", "512", "--temperature", "0", "--output-dir", str(out), "--quiet", "-y",
            *extra]


def test_cli_files_equal_the_jax_cli(model_dir, tmp_path, monkeypatch):
    """A 3.5 s wav in 2 s chunks with `--timestamp`: the three files of both
    CLIs are equal, and the `.json` holds the aligned items."""
    import json

    wav = tmp_path / "clip.wav"
    wav.write_bytes(_wav(_audio(3.5, 550.0)))
    _short_budget(monkeypatch, jax_schema)
    _short_budget(monkeypatch, port_schema)
    outs = {}
    for name, cli, extra in (("jax", jax_cli, ()), ("port", port_cli, ("--device", "cpu"))):
        out = tmp_path / name
        np.random.seed(11)
        assert cli.main(_args(model_dir, wav, out, "--timestamp", *extra)) == 0
        outs[name] = {s: (out / f"clip{s}").read_text(encoding="utf-8")
                      for s in (".txt", ".srt", ".json")}
    assert outs["port"] == outs["jax"]
    items = json.loads(outs["port"][".json"])
    assert items and " --> " in outs["port"][".srt"] and outs["port"][".txt"].strip()
    starts = [it["start"] for it in items]
    assert starts == sorted(starts)


def test_cli_without_timestamp_writes_text_only(model_dir, tmp_path, monkeypatch):
    wav = tmp_path / "a.wav"
    wav.write_bytes(_wav(_audio(2.0, 440.0)))
    _short_budget(monkeypatch, port_schema)
    out = tmp_path / "out"
    assert port_cli.main(_args(model_dir, wav, out, "--device", "cpu", "--dml",
                               "--vulkan")) == 0
    assert (out / "a.txt").read_text(encoding="utf-8").strip()
    assert not (out / "a.srt").exists() and not (out / "a.json").exists()


def test_cli_reports_a_missing_checkpoint(tmp_path, capsys):
    wav = tmp_path / "a.wav"
    wav.write_bytes(_wav(_audio(1.0)))
    rc = port_cli.main([str(wav), "--model-dir", str(tmp_path / "none"), "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2 and "missing model files" in err
    assert "qwen3_asr_gguf_tpu_torch/export/synthetic.py" in err


def test_cli_mesh_and_missing_card_raise(model_dir, tmp_path, monkeypatch):
    import torch

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli.main(["a.wav", "--model-dir", model_dir, "--mesh", "model=2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["a.wav", "--model-dir", model_dir])  # the default device, cuda


def test_cli_runs_without_jax(model_dir, tmp_path):
    """The CLI module and its main run in a process without JAX (`--prec
    f16` maps to the bf16 engine)."""
    import subprocess

    wav = tmp_path / "a.wav"
    wav.write_bytes(_wav(_audio(1.0)))
    argv = [str(wav), "--model-dir", model_dir, "--prec", "f16", "--chunk-size", "2",
            "--n-ctx", "512", "--device", "cpu", "--quiet", "-y", "--output-dir",
            str(tmp_path / "o")]
    code = ("import dataclasses, sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"  # as the one_torch_thread fixture
            "from qwen3_asr_gguf_tpu_torch import schema\n"
            "from qwen3_asr_gguf_tpu_torch.cli import transcribe\n"
            "@dataclasses.dataclass\n"
            "class Config(schema.ASREngineConfig):\n"  # as _short_budget
            "    max_new_tokens: int = 12\n"
            "    decode_block: int = 8\n"
            "schema.ASREngineConfig = Config\n"
            f"rc = transcribe.main({argv!r})\n"
            "print(rc, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "0 False"
    assert (tmp_path / "o" / "a.txt").exists()
