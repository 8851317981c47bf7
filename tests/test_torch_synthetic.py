"""The port's checkpoint writer, its numpy safetensors codec, and its
freedom from JAX: files byte-identical to the JAX package's
`make_synthetic_checkpoint`; the numpy reader/writer round-trips with the
`safetensors` package; every port module imports with JAX, safetensors and
ml_dtypes blocked."""

import filecmp
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

import qwen3_asr_gguf_tpu.models.configs as C
import qwen3_asr_gguf_tpu_torch.models.configs as TC
from qwen3_asr_gguf_tpu.export.convert import make_synthetic_checkpoint as jax_make
from qwen3_asr_gguf_tpu_torch.export.synthetic import make_synthetic_checkpoint
from qwen3_asr_gguf_tpu_torch.models import safetensors_np

REPO = Path(__file__).resolve().parent.parent

KERNEL_PRESET = C.ThinkerConfig(
    audio=C.AudioEncoderConfig(
        num_mel_bins=128, d_model=64, encoder_layers=1, encoder_attention_heads=4,
        encoder_ffn_dim=128, downsample_hidden_size=32, output_dim=512,
    ),
    text=C.TextDecoderConfig(
        vocab_size=512, hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=128, intermediate_size=1024,
    ),
)


@pytest.mark.parametrize("preset,quant,aligner", [
    ("tiny", "f16", False),
    ("tiny", "q4_k", True),
    ("kernel-512", "q4_k", False),
])
def test_checkpoint_byte_identical_to_jax(tmp_path, preset, quant, aligner):
    for presets in (C.PRESETS, TC.PRESETS):  # each package keeps its own table
        presets.setdefault("kernel-512", KERNEL_PRESET)
    a, b = tmp_path / "jax", tmp_path / "port"
    want = jax_make(str(a), preset, quant=quant, seed=3, aligner=aligner)
    got = make_synthetic_checkpoint(str(b), preset, quant=quant, seed=3, aligner=aligner)
    assert asdict(got) == asdict(want)  # one class per package
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 4
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_safetensors_round_trip(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors import safe_open

    rng = np.random.default_rng(0)
    tensors = {
        "layers.q_w": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "conv1_b": rng.standard_normal(5).astype(np.float32),
        "half": rng.standard_normal((3, 3)).astype(np.float16),
        "ids": np.arange(7, dtype=np.int64),
        "bytes": np.arange(9, dtype=np.uint8),
    }
    meta = {"config": '{"d_model": 64, "name": "x y"}'}
    ours, theirs = tmp_path / "ours.st", tmp_path / "theirs.st"
    safetensors_np.save_file(tensors, str(ours), metadata=meta)
    save_file(tensors, str(theirs), metadata=meta)
    assert ours.read_bytes() == theirs.read_bytes()
    back = load_file(str(ours))
    with safe_open(str(ours), framework="numpy") as f:
        assert f.metadata() == meta
    mine, my_meta = safetensors_np.load_file(str(theirs))
    assert my_meta == meta
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(mine[k], v)
        assert mine[k].dtype == v.dtype


def test_port_imports_without_jax():
    """Every port module imports with jax, safetensors and ml_dtypes
    blocked (the card's machine has no JAX; the port needs neither
    safetensors nor ml_dtypes)."""
    pkg = REPO / "qwen3_asr_gguf_tpu_torch"
    mods = sorted(
        "qwen3_asr_gguf_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py"
    )
    assert len(mods) >= 13
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'safetensors', 'ml_dtypes'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import qwen3_asr_gguf_tpu_torch as p\n"
        "assert p.QwenASREngine.__name__ == 'QwenASREngine'\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
