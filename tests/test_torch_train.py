"""`qwen3_asr_gguf_tpu_torch.parallel.train` on the CPU against the JAX
package's `parallel.train`, and across meshes in gloo worlds of spawned
ranks. Bounds (f32): the loss within 1e-5 relative of JAX's; each gradient
leaf within 1e-3 relative of its largest entry, plus 1e-9 (the key bias's
gradient is exactly 0 in exact arithmetic, softmax ignoring a shift per
query, and both packages leave ~1e-13 of rounding there); after one AdamW step every
coordinate within 2*lr of optax's (Adam's first step moves a coordinate by
about lr * sign(g), and a gradient near 0 may take the other sign in the
other package's sums) and those with |g| > 1e-4 within 1e-7; DP x TP within
1e-6 of the world of 1."""

import dataclasses

import numpy as np
import pytest

from qwen3_asr_gguf_tpu_torch.models.params import from_jax_params
from qwen3_asr_gguf_tpu_torch.parallel import dryrun as D
from qwen3_asr_gguf_tpu_torch.parallel import launch
from qwen3_asr_gguf_tpu_torch.parallel import sharding as S
from qwen3_asr_gguf_tpu_torch.parallel import train as T

CFG = D.toy_config(2)
LR = 1e-4


def _batch():
    return T.thinker_batch(CFG, 2, 100, 32, 13)


def _jax_cfg():
    from qwen3_asr_gguf_tpu.models import configs as jc

    return jc.ThinkerConfig(audio=jc.AudioEncoderConfig(**dataclasses.asdict(CFG.audio)),
                            text=jc.TextDecoderConfig(**dataclasses.asdict(CFG.text)))


@pytest.fixture(scope="module")
def jax_side():
    """JAX parameters, loss, gradients and one optax AdamW step on the batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from qwen3_asr_gguf_tpu.models import decoder as jdec
    from qwen3_asr_gguf_tpu.models import encoder as jenc
    from qwen3_asr_gguf_tpu.parallel import train as jtrain
    from qwen3_asr_gguf_tpu.parallel.sharding import make_mesh

    cfg = _jax_cfg()
    k_enc, k_dec = jax.random.split(jax.random.key(0))
    params = {"encoder": jenc.init_params(cfg.audio, k_enc),
              "decoder": jdec.init_params(cfg.text, k_dec)}
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch().items()}
    batch["tokens"] = batch["tokens"].astype(jnp.int32)
    with make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1]):
        loss, grads = jax.value_and_grad(jtrain._forward_loss)(params, cfg, batch)
    tx = optax.adamw(LR, weight_decay=0.01)
    upd, _ = tx.update(grads, tx.init(params), params)
    stepped = optax.apply_updates(params, upd)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": host(params), "loss": float(loss), "grads": host(grads),
            "stepped": host(stepped)}


def _port(tree):
    return {k: from_jax_params(v) for k, v in tree.items()}


def _close_leaves(got, want, rel):
    for (name, g), (_, w) in zip(T._leaves(got), T._leaves(want)):
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-9, (name, err)


def test_forward_loss_and_grads_match_jax(jax_side):
    params = _port(jax_side["params"])
    leaves = [t.requires_grad_(True) for _, t in T._leaves(params)]
    loss = T._forward_loss(params, CFG, _batch())
    loss.backward()
    assert abs(loss.item() - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
    grads = T._rebuild(params, iter(t.grad for t in leaves))
    _close_leaves(grads, _port(jax_side["grads"]), 1e-3)


def test_one_adamw_step_matches_optax(jax_side):
    _, step_fn = T.make_train_step(CFG, learning_rate=LR, weight_decay=0.01)
    state = step_fn.new_state(_port(jax_side["params"]))
    state, loss = step_fn(state, _batch())
    assert abs(loss - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
    want, grads = _port(jax_side["stepped"]), _port(jax_side["grads"])
    n_tight = 0
    for (name, p), (_, w), (_, g) in zip(T._leaves(state.params), T._leaves(want),
                                         T._leaves(grads)):
        diff = (p.detach() - w).abs()
        assert float(diff.max()) <= 2 * LR, name
        big = g.abs() > 1e-4
        n_tight += int(big.sum())
        if big.any():
            assert float(diff[big].max()) <= 1e-7, name
    assert n_tight > 1000


def test_loss_falls():
    init_fn, step_fn = T.make_train_step(CFG)
    state = init_fn(0)
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, _batch())
        losses.append(loss)
    assert all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2], losses
    assert state.step == 3


def _steps(mesh, steps=2):
    init_fn, step_fn = T.make_train_step(CFG, mesh)
    state = init_fn(0)
    batch = T.thinker_batch(CFG, 4, 100, 32, 13)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, batch)
        losses.append(loss)
    group = S.tp_group(mesh)
    specs = [s for _, s in T._leaves(T.thinker_param_specs(CFG))]
    whole = [T._whole(t, s, group) for (_, t), s in zip(T._leaves(state.params), specs)]
    grads = [T._whole(t.grad, s, group) for (_, t), s in zip(T._leaves(state.params), specs)]
    return losses, whole, grads


def _dp_tp_world(rank, world):
    return _steps(S.make_mesh({"data": 2, "model": 2}))


def test_dp_tp_equals_the_world_of_one(tmp_path):
    """2 x 2 ranks: the losses, the (gathered) gradients of the last step
    and the parameters after two steps equal one process's."""
    ref_loss, ref_params, ref_grads = _steps(None)
    outs = launch.spawn(_dp_tp_world, 4, init_file=str(tmp_path / "rendezvous"))
    for losses, params, grads in outs:
        np.testing.assert_allclose(losses, ref_loss, rtol=1e-6)
        for a, b in zip(params + grads, ref_params + ref_grads):
            assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1.0)


def _save_world(rank, world, path):
    mesh = S.make_mesh({"model": world})
    init_fn, step_fn = T.make_train_step(CFG, mesh)
    state = init_fn(0)
    batch = _batch()
    state, _ = step_fn(state, batch)
    T.save_checkpoint(path, state, CFG, mesh)
    _, loss = step_fn(state, batch)
    return loss


def test_checkpoint_restores_at_another_mesh(tmp_path):
    """Saved after a step on tp = 2, restored into one process: the next
    step's loss equals the one the tp = 2 run took."""
    path = str(tmp_path / "ckpt.pt")
    tp_loss = launch.spawn(_save_world, 2, init_file=str(tmp_path / "rendezvous"),
                           args=(path,))[0]
    init_fn, step_fn = T.make_train_step(CFG)
    state = T.restore_checkpoint(path, init_fn(1), CFG)
    assert state.step == 1
    _, loss = step_fn(state, _batch())
    assert abs(loss - tp_loss) <= 1e-6 * abs(tp_loss)
