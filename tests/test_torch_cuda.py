"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`; every test skips without a CUDA device. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bound: max|kernel - plain| <= 1e-2 * max|plain| for bf16 outputs (one bf16
rounding of differently ordered f32 sums, and at most a one-step flip of an
int8 activation where the fused norm's rsqrt rounds differently), and
1e-4 * max|plain| for f32 outputs of the unfused kernel (f32 sum order only).
"""

import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.formats import quants as q
from qwen3_asr_gguf_tpu_torch.ops import q4k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _weight(n, k, seed, device):
    rng = np.random.default_rng(seed)
    p = q.pack_q4_direct((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    return q4k.from_packed_q4(p, device=device)


def _x(k, dtype, device, seed=1):
    return torch.randn(1, k, generator=torch.Generator().manual_seed(seed)).to(device, dtype)


def _rel_err(got, want):
    torch.cuda.synchronize()
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2048, 2048), (2048, 6144), (4096, 512), (152576, 2048)])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-4)])
def test_matvec_vs_plain(cuda, n, k, dtype, bound):
    w = _weight(n, k, n + k, cuda)
    x = _x(k, dtype, cuda)
    before = q4k.q4k_matvec.launches
    got = q4k.q4k_matvec(x, w)
    assert q4k.q4k_matvec.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, n)
    assert _rel_err(got, q4k.q4k_matvec_ref(x, w)) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4096, 2048), (12288, 2048), (1024, 512), (512, 1024)])
def test_matvec_normed_vs_plain(cuda, n, k):
    w = _weight(n, k, n + 2 * k, cuda)
    x = _x(k, torch.bfloat16, cuda, seed=2)
    nw = torch.rand(k, generator=torch.Generator().manual_seed(3)).to(cuda) + 0.5
    before = q4k.q4k_matvec_normed.launches
    got = q4k.q4k_matvec_normed(x, w, nw, 1e-6)
    assert q4k.q4k_matvec_normed.launches == before + 1
    assert _rel_err(got, q4k.q4k_matvec_normed_ref(x, w, nw, 1e-6)) <= 1e-2


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    w = _weight(512, 1024, 5, cuda)
    x = _x(2048, torch.bfloat16, cuda)[:, ::2]  # right size, not contiguous
    with pytest.raises(ValueError):
        q4k.q4k_matvec(x, w)
    with pytest.raises(ValueError):
        q4k.q4k_matvec(_x(1024, torch.bfloat16, cuda), w.to("cpu"))
    with pytest.raises(TypeError):
        q4k.q4k_matvec(_x(1024, torch.float16, cuda), w)
