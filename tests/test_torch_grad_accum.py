"""Gradient accumulation: DPMNSystem.accum_train_step against dpmn_tpu's
make_accum_train_step, in float64 at dropout rates 0 on a tiny geometry
(TATT PSN, srb 1, embed 24, one student and one PGRM per branch, B = 4 in
two microbatches of 2), from one numpy-seeded state; and the port's own
invariants: `accum_steps=1` is `train_step`, and accumulation is the
average of sequential `_micro_grads` calls followed by one update."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from test_torch_train_helpers import _jax_state, _np, _port_system

TINY = dict(arch="tatt", mask=True, stu_iter_b1=1, stu_iter_b2=1, patch_size="2,", embed_dim="24,",
            window_size="2,4,8,", depths="1,", num_heads="6,", mlp_ratio="4,", srb=1, gradient=True,
            drop_rate="0,", attn_drop_rate="0,", drop_path_rate="0,")


def _images(seed, b=4, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return rng.rand(b, 32, 128, 4).astype(dtype), rng.rand(b, 16, 64, 4).astype(dtype)


def _assert_states_close(a, b, atol):
    assert a.keys() == b.keys()
    for k in a:
        if a[k].is_floating_point():
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=atol, err_msg=k)
        else:
            assert torch.equal(a[k], b[k]), k


def test_accum_against_jax_float64(monkeypatch):
    """Against the computation dpmn_tpu's make_accum_train_step performs
    (its own test holds the scan to this loop): `_micro_grads` per
    microbatch with the BatchNorm statistics threaded through, the averaged
    gradients, one `_apply_update`.  The scan itself cannot run in float64:
    its loss carry starts as a float32 zero.  Tolerances as tests/test_torch_train_strict.py's (the JAX
    cascade casts its losses to float32; to_mask swapped for the same smooth
    function on both sides): loss and grad_norm rtol 1e-5 / 1e-4, the
    averaged gradients within 5e-3 of each leaf's largest value (one
    microbatch's `_micro_grads` already differs by up to 2e-3 of it in the
    CMM: the float32 losses; the biases ahead of a BatchNorm get 0 up to
    rounding, 1e-14), the BatchNorm statistics rtol 1e-4, and each
    parameter's change equal, within 1e-9, to the difference of Adam's first
    steps on the two sides' clipped gradients: Adam's first step is
    ~lr * sign(g), so a gradient at rounding level moves its element a full
    step either way."""
    monkeypatch.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    with jax.enable_x64(True):
        jsys = JS.DPMNSystem(JTrainCfg(batch_size=4), JArgs(**TINY), glyph_mode="atlas")
        state = _jax_state(jsys, 5, np.float64)
        psys = _port_system(TINY, torch.float64, state)
        hr, lr = _images(3)
        micro, apply = jax.jit(jsys._micro_grads), jax.jit(jsys._apply_update)
        bs, losses, grads = state["batch_stats"], [], []
        for i in range(2):
            loss, g, bs = micro(state["params"], bs, state["frozen"], jnp.asarray(hr[2 * i:2 * i + 2]),
                                jnp.asarray(lr[2 * i:2 * i + 2]), jax.random.PRNGKey(i))
            losses.append(loss)
            grads.append(g)
        g_avg = jax.tree_util.tree_map(lambda x, y: (x + y) * 0.5, *grads)
        new_state, metrics = apply(state, g_avg, bs, (losses[0] + losses[1]) * 0.5)
        applied = {}
        apply_update = psys._apply_update
        psys._apply_update = lambda g, loss: applied.setdefault("grads", g) and apply_update(g, loss)
        out = psys.accum_train_step(hr, lr, seed=0, accum_steps=2)
    np.testing.assert_allclose(out["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"].item(), float(metrics["grad_norm"]), rtol=1e-4)
    assert psys.step == 1 and int(new_state["step"]) == 1
    # the averaged gradients of both sides, leaf by leaf
    view = _port_system(TINY, torch.float64, dict(_np(new_state), params=_np(g_avg)))
    g_j = [p.detach().numpy() for p in view.trainable_parameters()]
    g_p = [g.numpy() for g in applied["grads"]]
    names = {id(p): n for n, p in psys.named_parameters()}
    names = [names[id(p)] for p in psys.trainable_parameters()]
    for name, a, b in zip(names, g_p, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-3 * np.abs(b).max() + 1e-12, err_msg=name)
    # each side's parameters moved by Adam's first step on its own clipped
    # gradients, lr * c g / (|c g| + eps): where a gradient is near 0 or
    # its clipped value near eps, the two steps differ by what the
    # gradients do, and nowhere else
    steps = {n: a - b for n, a, b in zip(names, _adam_first_step(psys, g_p), _adam_first_step(psys, g_j))}
    got, n_stats = psys.state_dict(), 0
    for name, want in _port_system(TINY, torch.float64, _np(new_state)).state_dict().items():
        have, want = got[name].numpy(), want.numpy()
        if name in steps:
            np.testing.assert_allclose(have - want, -steps[name], rtol=0, atol=1e-9, err_msg=name)
        elif name.endswith(("running_mean", "running_var")) and name.startswith("cmm."):
            np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-6, err_msg=name)
            n_stats += 1
        else:
            np.testing.assert_array_equal(have, want, err_msg=name)
    assert n_stats == 2 * 25


def _adam_first_step(system, grads, lr=1e-3, eps=1e-8):
    """The first Adam step of each parameter after the per-module clip at
    0.25: bias-corrected, it is lr * g / (|g| + eps) of the clipped g."""
    out, i = [], 0
    for module in system.trainable_modules().values():
        n = len(list(module.parameters()))
        group = grads[i:i + n]
        i += n
        c = min(1.0, 0.25 / (np.sqrt(sum(float((g * g).sum()) for g in group)) + 1e-6))
        out += [lr * c * g / (np.abs(c * g) + eps) for g in group]
    return out


def test_accum_one_is_train_step():
    base = _port_system(TINY, torch.float32)
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    hr, lr = _images(4, b=2, dtype=np.float32)
    ma = a.train_step(hr, lr, 7)
    mb = b.accum_train_step(hr, lr, 7, accum_steps=1)
    assert ma["loss"].item() == mb["loss"].item() and ma["grad_norm"].item() == mb["grad_norm"].item()
    _assert_states_close(a.state_dict(), b.state_dict(), atol=0)


def test_accum_is_the_average_of_microbatches():
    base = _port_system(TINY, torch.float32)
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    hr, lr = _images(6, b=6, dtype=np.float32)
    out = a.accum_train_step(hr, lr, seed=4, accum_steps=3)
    losses, grads = [], None
    for i in range(3):
        loss, g = b._micro_grads(hr[2 * i:2 * i + 2], lr[2 * i:2 * i + 2], 4 * 3 + i)
        losses.append(loss)
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
    ref = b._apply_update([g * (1.0 / 3) for g in grads], (losses[0] + losses[1] + losses[2]) * (1.0 / 3))
    assert out["loss"].item() == ref["loss"].item()
    np.testing.assert_allclose(out["grad_norm"].item(), ref["grad_norm"].item(), rtol=1e-6)
    _assert_states_close(a.state_dict(), b.state_dict(), atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        a.accum_train_step(hr[:5], lr[:5], 0, accum_steps=2)
