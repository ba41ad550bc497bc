"""Shared helpers of the port's train-step tests (no tests of its own): the
small training configuration, random JAX train states, port systems loaded
from them, and two train steps of both packages from one state
(`_two_steps`), which tests/test_torch_train_strict.py and
tests/test_torch_train_float32.py hold against each other.

BatchNorm statistics: flax computes the batch variance as E[x^2] - E[x]^2
(`use_fast_variance`), torch in two passes.  At B = 2 the CMM's deep
BatchNorms see 8 to 32 values per channel with means large against their
spread, and the one-pass form cancels (tests/test_torch_train.py::
test_cmm_gradients_against_float64).  So the float32 steps run the JAX side
with the two-pass variance (`_patch_two_pass`), a test-local patch of flax;
the port keeps torch's two-pass statistics."""

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import random_variables
from test_torch_system import SMALL


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _patch_two_pass(mp):
    compute_stats = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    mp.setattr(flax_norm, "_compute_stats", two_pass)


TRAIN = dict(SMALL, gradient=True, drop_rate="0,", attn_drop_rate="0,", drop_path_rate="0,")


def _images(seed, b=2):
    rng = np.random.RandomState(seed)
    return rng.rand(b, 32, 128, 4).astype(np.float32), rng.rand(b, 16, 64, 4).astype(np.float32)


def _jax_state(jsys, seed, dtype=np.float32):
    shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
    state = random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, seed)
    state = jax.tree_util.tree_map(lambda a: a.astype(dtype) if a.dtype == np.float32 else a, state)
    state["opt_state"] = jsys._adam.init(state["params"])
    state["step"] = jnp.zeros((), jnp.int32)
    return state


def _port_system(kw, dtype, tree=None):
    system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**kw), device="cpu").to(dtype)
    if tree is not None:
        from_jax(tree, system)
    return system


def _load_jax_state(psys, kw, dtype, state):
    """Put a JAX train state — params, batch_stats and Adam's count, mu, nu —
    into the port system and its optimizer."""
    from_jax(state, psys)
    adam = [t for t in jax.tree_util.tree_leaves(state["opt_state"], is_leaf=lambda t: isinstance(
        t, optax.ScaleByAdamState)) if isinstance(t, optax.ScaleByAdamState)][0]
    moments = [_port_system(kw, dtype, dict(state, params=_np(tree))).trainable_parameters()
               for tree in (adam.mu, adam.nu)]
    for p, mu, nu in zip(psys.trainable_parameters(), *moments):
        psys.optimizer.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu.detach().clone(),
                                   "exp_avg_sq": nu.detach().clone()}


def _two_steps(kw, mask_patch, dtype, seed=0, images_seed=11, resync=False):
    """Two train steps of each package from one state, both in `dtype`
    (float64: JAX under jax.enable_x64).  With `resync` the port takes its
    second step from the JAX package's state after the first (parameters,
    batch_stats and Adam's moments), so step 2 is compared from one state.
    Returns what the tests compare."""
    x64 = dtype == torch.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
        if not x64:
            _patch_two_pass(mp)
        if mask_patch:
            mp.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
            mp.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
        jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**kw), glyph_mode="atlas")
        state = _jax_state(jsys, seed, np.float64 if x64 else np.float32)
        psys = _port_system(kw, dtype, state)

        j_ids, p_ids = [], []
        glyph_fn = jsys._device_glyph

        def recording_glyph(ids, lengths):
            jax.debug.callback(lambda i: j_ids.append(np.asarray(i)), ids)
            return glyph_fn(ids, lengths)

        jsys._device_glyph = recording_glyph
        hook = psys.glyph.register_forward_hook(lambda m, inp, out: p_ids.append(inp[0].numpy().copy()))
        micro, apply = jax.jit(jsys._micro_grads), jax.jit(jsys._apply_update)
        res = {"j": [], "p": [], "kw": kw, "dtype": dtype}
        try:
            for step in range(2):
                hr, lr = _images(images_seed + step)
                jhr, jlr = (jnp.asarray(a, jnp.float64 if x64 else jnp.float32) for a in (hr, lr))
                if resync and step == 1:
                    _load_jax_state(psys, kw, dtype, state)
                loss, grads, new_bs = micro(state["params"], state["batch_stats"], state["frozen"], jhr, jlr,
                                            jax.random.PRNGKey(step))
                state, metrics = apply(state, grads, new_bs, loss)
                res["j"].append(dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                                     grads=_np(grads), state=_np(state)))
                p_loss, p_grads = psys._micro_grads(hr, lr, step)
                p_metrics = psys._apply_update(p_grads, p_loss)
                res["p"].append(dict(loss=p_metrics["loss"].item(), grad_norm=p_metrics["grad_norm"].item(),
                                     grads=[g.numpy() for g in p_grads],
                                     state={k: v.clone() for k, v in psys.state_dict().items()}))
        finally:
            hook.remove()
            jsys._device_glyph = glyph_fn
    res["ids"] = (j_ids, p_ids)
    return res


def _trainable_names(system):
    ids = {id(p) for p in system.trainable_parameters()}
    return [n for n, p in system.named_parameters() if id(p) in ids]


def _state_view(res, step):
    """A port system holding the JAX package's state after `step`, made once
    per result and shared by the tests that read it."""
    views = res.setdefault("views", {})
    if step not in views:
        views[step] = _port_system(res["kw"], res["dtype"], res["j"][step]["state"])
    return views[step]


def _grad_leaves(res, step):
    """(name, port grad, JAX grad in port layout) for every trainable
    parameter; computed once per result and step."""
    leaves = res.setdefault("grad_leaves", {})
    if step not in leaves:
        j = res["j"][step]
        view = _port_system(res["kw"], res["dtype"], dict(j["state"], params=j["grads"]))
        ref = [p.detach().numpy() for p in view.trainable_parameters()]
        names = _trainable_names(view)
        assert len(names) == len(ref) == len(res["p"][step]["grads"])
        leaves[step] = list(zip(names, res["p"][step]["grads"], ref))
    return leaves[step]
