"""Port parity: log-mel and the audio encoder of qwen3_asr_gguf_tpu_torch
against the JAX package on the same weights and audio. Bounds: mel within
1e-5 of `log_mel_np`; encoder output within 1e-4 (f32)."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.audio import mel as jmel
from qwen3_asr_gguf_tpu.models import encoder as jenc
from qwen3_asr_gguf_tpu.models import params as jP
from qwen3_asr_gguf_tpu.models.configs import preset
from qwen3_asr_gguf_tpu.runtime.encoder_runner import EncoderRunner as JRunner
from qwen3_asr_gguf_tpu_torch.audio import mel as tmel
from qwen3_asr_gguf_tpu_torch.export.synthetic import np_init_like
from qwen3_asr_gguf_tpu_torch.models import encoder as tenc
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.runtime.encoder_runner import EncoderRunner as TRunner

CFG = preset("tiny").audio


def _audio(n, seed=0):
    t = np.arange(n) / 16000
    noise = np.random.default_rng(seed).standard_normal(n) * 0.05
    return (np.sin(2 * np.pi * 440 * t) * 0.3 + noise).astype(np.float32)


def _tree(cfg, seed=0):
    tree = np_init_like(tenc.init_shapes(cfg), seed)
    tree["pos_embed"] = tenc.sinusoid_positions(cfg.max_source_positions, cfg.d_model)
    return tree


def test_numpy_half_is_a_copy():
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    for a, b in zip(tmel._dft_constants(400), jmel._dft_constants(400)):
        np.testing.assert_array_equal(a, b)
    x = _audio(12345)
    np.testing.assert_array_equal(tmel.log_mel_np(x, tmel.mel_filterbank()),
                                  jmel.log_mel_np(x, jmel.mel_filterbank()))


@pytest.mark.parametrize("n", [32000, 16000 * 3 + 777])
def test_log_mel_vs_numpy(n):
    x = _audio(n, seed=n)
    fb = jmel.mel_filterbank()
    want = jmel.log_mel_np(x, fb)
    got = tmel.LogMelFrontend(fb)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_padded_log_mel_vs_jax():
    x = _audio(16000 * 2 + 4321, seed=5)
    frames, bucket = len(x) // 160, 500
    y = jmel.pad_signal_for_bucket(x, bucket)
    np.testing.assert_array_equal(tmel.pad_signal_for_bucket(x, bucket), y)
    fb = jmel.mel_filterbank()
    want = np.asarray(jmel._log_mel_padded_jit(jnp.asarray(y), jnp.asarray(fb),
                                               jnp.int32(frames), bucket))
    got = tmel.LogMelFrontend(fb).padded(torch.from_numpy(y), frames, bucket).numpy()
    np.testing.assert_allclose(got[:, :frames], jmel.log_mel_np(x, fb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, frames:], 0.0)
    # XLA's CPU DFT matmul is itself 1.7e-4 from log_mel_np on this input
    # (low-power bins, where log10 magnifies f32 rounding of the sums)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("mode", ["full", "windowed"])
def test_encode_vs_jax(mode):
    cfg = replace(CFG, attention_mode=mode, n_window_infer=200)
    tree = _tree(cfg, seed=1)
    mel = jmel.log_mel_np(_audio(16000 * 7 + 3210, seed=2), jmel.mel_filterbank())
    t = mel.shape[1]
    mel = np.pad(mel, ((0, 0), (0, (-t) % cfg.n_window)))
    want = jenc.encode(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(mel), valid_mel_len=t)
    got = tenc.encode(tP.from_jax_params(tree), cfg, torch.from_numpy(mel), valid_mel_len=t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """Both runners over the same int4 encoder checkpoint file."""
    cfg = replace(CFG, output_dim=256)
    path = str(tmp_path_factory.mktemp("enc") / "enc.safetensors")
    tP.save_encoder_safetensors(path, cfg, _tree(cfg, seed=3))
    jcfg, jparams = jP.load_encoder_quantized(path, kind="int4")
    tcfg, tparams = tP.load_encoder_quantized(path, kind="int4")
    assert asdict(jcfg) == asdict(tcfg) == asdict(cfg)  # one class per package
    return JRunner(jparams, jcfg), TRunner(tparams, tcfg, device="cpu")


@pytest.mark.parametrize("n", [32000, 16000 + 5555])
def test_int4_runner_vs_jax(runners, n):
    """The engine's encoder: aligned chunks and bucketed odd lengths (f32
    backend on the CPU on both sides)."""
    jr, tr = runners
    x = _audio(n, seed=n)
    valid = jr.valid_tokens(n)
    assert tr.valid_tokens(n) == valid
    want = np.asarray(jr.encode_async(x))[:valid]
    got = tr.encode(torch.from_numpy(x))[:valid].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
