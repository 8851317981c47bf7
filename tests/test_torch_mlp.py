"""Port parity for the fused int8 SwiGLU MLP (`ops/mlp.py`): its plain version
against the JAX Pallas kernel in interpret mode and the kernel's numpy twin,
at the JAX package's own test cases, and `split_mlp_weights` against the JAX
function on weights carried across.

Bound: rtol/atol 2e-4, the JAX test's own (`tests/test_pallas_mlp.py`): the
integer dots are exact in all three, so they differ by the ulp of exp in the
logistic, which moves an act value across a .5 boundary of the per-tile
requantization only rarely (no such flip in these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_gguf_tpu.models import decoder as jdec
from qwen3_asr_gguf_tpu.ops import qtensor as jq
from qwen3_asr_gguf_tpu.ops.pallas_mlp import fused_mlp_matvec as jax_fused_mlp
from qwen3_asr_gguf_tpu_torch.models import decoder as tdec
from qwen3_asr_gguf_tpu_torch.models import params as tP
from qwen3_asr_gguf_tpu_torch.ops import mlp
from qwen3_asr_gguf_tpu_torch.ops import qtensor as tq


def _np_twin(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m):
    """The kernel's math in numpy (per-tile act quantization)."""
    xf = x.astype(np.float64).astype(np.float32)
    sx = max(np.abs(xf).max() / 127.0, 1e-10)
    xq = np.clip(np.round(xf / sx), -127, 127).astype(np.int32)
    m, d = wg_q.shape
    acc = np.zeros((1, d), np.float32)
    for t0 in range(0, m, tile_m):
        t1 = t0 + tile_m
        g = (xq @ wg_q[t0:t1].astype(np.int32).T).astype(np.float32) * (sx * sg[t0:t1])
        u = (xq @ wu_q[t0:t1].astype(np.int32).T).astype(np.float32) * (sx * su[t0:t1])
        act = (g * (1.0 / (1.0 + np.exp(-g)))) * u
        s_act = max(np.abs(act).max() / 127.0, 1e-10)
        actq = np.clip(np.round(act / s_act), -127, 127).astype(np.int32)
        acc += (actq @ wd_q[:, t0:t1].astype(np.int32).T).astype(np.float32) * s_act
    return acc * sd[None, :]


def _case(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, d)) * 0.1).astype(np.float32)
    ws = [rng.integers(-127, 128, shape).astype(np.int8) for shape in ((m, d), (m, d), (d, m))]
    ss = [(rng.random(n) * 0.01 + 0.001).astype(np.float32) for n in (m, m, d)]
    return x, (ws[0], ss[0], ws[1], ss[1], ws[2], ss[2])


@pytest.mark.parametrize("m,d,tile", [(512, 256, 256), (1024, 128, 512)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_vs_jax_interpret_kernel_and_numpy_twin(m, d, tile, seed):
    x, args = _case(m, d, seed)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), *map(jnp.asarray, args), tile_m=tile,
                                    interpret=True))
    got = mlp.fused_mlp_matvec_ref(torch.from_numpy(x), *map(torch.from_numpy, args), tile_m=tile)
    assert got.dtype == torch.float32 and got.shape == (1, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _np_twin(x, *args, tile), rtol=2e-4, atol=2e-4)
    # on the CPU the wrapper is its plain version
    assert torch.equal(mlp.fused_mlp_matvec(torch.from_numpy(x), *map(torch.from_numpy, args),
                                            tile_m=tile), got)


def test_bf16_row_comes_back_in_bf16():
    x, args = _case(1024, 128, 2)
    want = jax_fused_mlp(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, args),
                         interpret=True)
    got = mlp.fused_mlp_matvec_ref(torch.from_numpy(x).to(torch.bfloat16),
                                   *map(torch.from_numpy, args))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of values within 2e-4 of each other
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-3)


def test_act_is_quantized_per_tile_and_tiles_add_in_order():
    x, args = _case(1024, 128, 3)
    targs = list(map(torch.from_numpy, args))
    act = mlp.mlp_act_ref(torch.from_numpy(x), *targs[:4])
    aq, s_act = mlp.quantize_act_tiles(act, 512)
    assert aq.dtype == torch.int8 and aq.shape == (1, 1024) and s_act.shape == (1, 2)
    for j in range(2):
        tile = act[0, 512 * j: 512 * (j + 1)]
        assert s_act[0, j].item() == pytest.approx(tile.abs().max().item() / 127.0, rel=1e-6)
        assert aq[0, 512 * j: 512 * (j + 1)].abs().max().item() == 127
    with pytest.raises(ValueError):
        mlp.fused_mlp_matvec_ref(torch.from_numpy(x), *targs, tile_m=768)


def test_tracks_the_float_mlp():
    """The quantized MLP approximates the dense float one: cosine > 0.999."""
    rng = np.random.default_rng(4)
    m, d = 1024, 256
    dense = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((m, d), (m, d), (d, m))]
    args = []
    for w in dense:
        iw = tq.to_int8(torch.from_numpy(w))
        args += [iw.q, iw.scale]
    x = (rng.standard_normal((1, d)) * 0.2).astype(np.float32)
    got = mlp.fused_mlp_matvec(torch.from_numpy(x), *args).numpy()
    g = x @ dense[0].T
    want = ((g / (1 + np.exp(-g))) * (x @ dense[1].T)) @ dense[2].T
    cos = (got.ravel() * want.ravel()).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.999, cos


def test_split_mlp_weights_vs_jax():
    """Int8 and dense fused gate|up weights split into the same halves as
    the JAX function's, and a layer without a fused weight passes through."""
    rng = np.random.default_rng(5)
    m, d = 512, 128
    gu_q = rng.integers(-127, 128, (2, 2 * m, d)).astype(np.int8)
    gu_s = rng.random((2, 2 * m)).astype(np.float32)
    down = rng.standard_normal((2, d, m)).astype(np.float32)
    jlayers = {"gateup_proj": jq.Int8Weight(q=jnp.asarray(gu_q), scale=jnp.asarray(gu_s)),
               "down_proj": jnp.asarray(down)}
    want = jdec.split_mlp_weights(jdec.unstack_layers(jlayers, 2))
    tlayers = tP.from_jax_params({"layers": jax.tree.map(np.asarray, jlayers)})["layers"]
    got = tdec.split_mlp_weights(tlayers)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["down_proj", "gate_proj", "up_proj"]
        for name in ("gate_proj", "up_proj"):
            assert isinstance(g[name], tq.Int8Weight) and g[name].shape == (m, d)
            np.testing.assert_array_equal(g[name].q.numpy(), np.asarray(w[name].q))
            np.testing.assert_array_equal(g[name].scale.numpy(), np.asarray(w[name].scale))
        assert g["gate_proj"].q.is_contiguous() and g["up_proj"].q.is_contiguous()
    dense_layers = [{"gateup_proj": torch.from_numpy(gu_s[0].reshape(2 * m, 1).copy())},
                    {"gate_proj": torch.zeros(1)}]
    out = tdec.split_mlp_weights(dense_layers)
    assert out[0]["gate_proj"].shape == (m, 1) and out[0]["up_proj"].shape == (m, 1)
    assert sorted(out[1]) == ["gate_proj"]


def test_can_fuse_mlp_conditions():
    def layer(m, d):
        w = tq.Int8Weight(q=torch.zeros(m, d, dtype=torch.int8), scale=torch.ones(m))
        return {"gate_proj": w, "up_proj": w,
                "down_proj": tq.Int8Weight(q=torch.zeros(d, m, dtype=torch.int8),
                                           scale=torch.ones(d))}

    x = torch.zeros(1, 128)
    assert tdec._can_fuse_mlp(layer(512, 128), x)
    assert not tdec._can_fuse_mlp(layer(512, 128), torch.zeros(2, 128))  # one token only
    assert not tdec._can_fuse_mlp(layer(256, 128), x)  # M % 512
    assert not tdec._can_fuse_mlp(layer(512, 64), torch.zeros(1, 64))  # D % 128
    assert not tdec._can_fuse_mlp({"gateup_proj": layer(512, 128)["gate_proj"]}, x)
    with pytest.raises(ValueError):  # asked for, but not fusable: no quiet unfused MLP
        tdec._mlp(layer(256, 128), x, fused_kernel=True)


# (D, M, tile_m) of the kernel's `cuda` tests: both model shapes first
KERNEL_SHAPES = [(2048, 6144, 512), (1024, 3072, 512), (512, 1024, 512), (256, 512, 256),
                 (128, 1024, 64)]


@pytest.mark.parametrize("d,m,tile", KERNEL_SHAPES)
@pytest.mark.parametrize("blocks", [132, 114])
def test_fused_mlp_plan_deals_every_row_once(d, m, tile, blocks):
    """The launch plan: every M row is dealt to exactly one block, each
    block's rows in increasing order (tile 0's first), every D row falls in
    exactly one Wd slab, and the slab plus the staging fits the shared
    memory the plan declares."""
    plan = mlp.fused_mlp_plan(m, d, tile, blocks)
    assert plan.blocks == blocks and (plan.m, plan.d, plan.tile_m) == (m, d, tile)
    assert sorted(r for b in range(blocks) for r in plan.act_rows(b)) == list(range(m))
    for b in range(blocks):
        rows = list(plan.act_rows(b))
        assert rows == sorted(rows)
        first_tile = [r for r in rows if r < tile]
        assert rows[:len(first_tile)] == first_tile
    assert [r for b in range(blocks) for r in plan.slab(b)] == list(range(d))
    assert plan.slab_rows == -(-d // blocks)
    assert all(len(plan.slab(b)) <= plan.slab_rows for b in range(blocks))
    staging = plan.slab_rows * m + m + d + 4 * (m // tile) + 4 * plan.slab_rows * (m // tile)
    assert staging <= plan.smem_bytes <= mlp.SMEM_BUDGET


@pytest.mark.parametrize("m,d,tile,blocks", [
    (16384, 2048, 512, 132),  # the Wd slab (16 rows of 16 KB) is over the budget
    (512, 4096, 512, 132),  # D beyond the registers of phase 1
    (1536, 256, 768, 132),  # tile_m not a power of two
    (2048, 256, 1024, 132),  # tile_m beyond 16 values per lane
    (1024, 2048, 512, 1),  # 2048 slab rows in one block
    (1000, 256, 500, 132),  # tile_m no multiple of 16
    (1024, 100, 512, 132),  # D no multiple of 16
])
def test_fused_mlp_plan_refuses_what_does_not_fit(m, d, tile, blocks):
    with pytest.raises(ValueError):
        mlp.fused_mlp_plan(m, d, tile, blocks)


def test_fused_mlp_plan_constants_are_the_compiled_ones():
    """The plan's limits are csrc/fused_mlp.cu's: the shared-memory budget,
    16 act values per lane, 4 pieces of 16 bytes of a row per lane, one
    thread per slab row, two counters."""
    import re
    from pathlib import Path

    src = (Path(mlp.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu").read_text()

    def constant(name):
        return eval(re.search(rf"constexpr int {name} = ([\d *]+);", src).group(1))

    assert constant("SMEM_BUDGET") == mlp.SMEM_BUDGET
    assert constant("MAX_TILE") == mlp.MAX_TILE
    assert constant("MAX_C") * 512 == mlp.MAX_D
    assert constant("WARPS") * 32 == mlp.MAX_SLAB_ROWS
    assert "ROWS_OUT = 0, TICKETS = 1;" in src and mlp.COUNTERS == 2
