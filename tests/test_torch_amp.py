"""The bf16 AMP train step (DPMNSystem train_dtype="bfloat16") against the JAX
package's AMP step (`_amp_frozen_cast` + `_micro_grads`, system.py:441-479)
at the SMALL geometry of tests/test_torch_system.py, B = 2, rates 0, the
"block" core: the JAX side runs K3 in interpret mode on bf16 io
(DPMN_TPU_PALLAS_WINDOW=1, its `_PALLAS_WINDOW_MODE`) with the kernel's
rounding points, which the port's plain version keeps; the BatchNorm
variance is the two-pass one on both sides (`_patch_two_pass`).  The port
reads the JAX step's glyph ids (a bf16 student may read a word differently
in the two packages; the prior then differs by a whole glyph).

What holds, and why each limit is where it is:
  * the loss within rel 1e-2 (7.1e-4 seen);
  * the gradient of each PGRM, its leaves as one vector (the unit of the
    per-module clip), within relative norm 5e-2 of the JAX one (2.1e-2 to
    4.2e-2 seen); each leaf within 5e-2 of its PGRM's gradient norm (3.0e-2
    seen).  A leaf's error against its own norm cannot hold 5e-2 for a
    rounding reason: the relative-position tables, the conv biases before a
    LayerNorm and the residual weights have gradients that are small
    remainders of cancelling terms, and bf16 rounding of the terms moves them
    by up to 0.72 of their norm (pgrms.1 ... relative_position_bias_table_0),
    as much in either package: against the port's float32 step that leaf
    moves 0.68 under the port's AMP and 0.66 under the JAX package's
    (ROADMAP §3);
  * the BatchNorm statistics after the step within 2e-2 of each buffer's
    largest value (7.6e-3 seen);
  * no bf16 in the port's parameters, gradients, Adam state or buffers;
  * the JAX package's own gates (tests/test_system.py:82-106): the AMP loss
    within 5 % of the float32 loss from the same state, and 4 more AMP
    steps finite with the last loss below the first."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as JP
import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.models.pgrm import WindowAttention
from dpmn_tpu_torch.weights import from_jax
from test_torch_train_helpers import TRAIN, _images, _jax_state, _np, _patch_two_pass, _port_system, _trainable_names


def _port(train_dtype="bfloat16", state=None, **kw):
    system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", train_dtype=train_dtype, **kw)
    if state is not None:
        from_jax(state, system)
    return system


def _feed_ids(system, ids):
    """Make the port's glyph renders take the JAX step's (ids, lengths), in order."""
    it = iter(ids)
    return system.glyph.register_forward_pre_hook(lambda m, args: tuple(torch.from_numpy(a) for a in next(it)))


@pytest.fixture(scope="module")
def amp():
    """One AMP micro step of each package from one state, the port's float32
    step from it, and the JAX step's glyph ids."""
    hr, lr = _images(11)
    with pytest.MonkeyPatch.context() as mp:
        _patch_two_pass(mp)
        mp.setattr(JP, "_PALLAS_WINDOW_MODE", "1")
        jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**TRAIN), glyph_mode="atlas", train_dtype="bfloat16")
        state = _jax_state(jsys, 0)
        ids = []
        glyph_fn = jsys._device_glyph

        def recording_glyph(i, lengths):
            jax.debug.callback(lambda a, b: ids.append((np.array(a), np.array(b))), i, lengths)
            return glyph_fn(i, lengths)

        jsys._device_glyph = recording_glyph
        frozen, jlr = jsys._amp_frozen_cast(state, jnp.asarray(lr))
        loss, grads, new_bs = jax.jit(jsys._micro_grads)(state["params"], state["batch_stats"], frozen,
                                                          jnp.asarray(hr), jlr, jax.random.PRNGKey(0))
        j = dict(loss=float(loss), grads=_np(grads), batch_stats=_np(new_bs))
    assert len(ids) == 2
    # the JAX step's gradients and statistics in the port's layout
    view = _port_system(TRAIN, torch.float32, dict(state, params=j["grads"], batch_stats=j["batch_stats"]))
    psys = _port(state=state)
    hook = _feed_ids(psys, ids)
    p_loss, p_grads = psys._micro_grads(hr, lr, 0)
    hook.remove()
    p32 = _port(None, state)
    hook = _feed_ids(p32, ids)
    f32_loss, _ = p32._micro_grads(hr, lr, 0)
    hook.remove()
    return dict(j=j, view=view, state=state, psys=psys, loss=p_loss, grads=p_grads, f32_loss=f32_loss.item(), hr=hr,
                lr=lr)


def test_amp_loss_matches_jax(amp):
    assert amp["loss"].dtype == torch.float32
    np.testing.assert_allclose(amp["loss"].item(), amp["j"]["loss"], rtol=1e-2)


def test_amp_pgrm_gradients_match_jax(amp):
    view = amp["view"]
    ref = [p.detach().numpy() for p in view.trainable_parameters()]
    names = _trainable_names(view)
    assert len(names) == len(ref) == len(amp["grads"])
    for g in amp["grads"]:
        assert g.dtype == torch.float32
    for mi in range(len(view.pgrms)):
        idx = [i for i, n in enumerate(names) if n.startswith(f"pgrms.{mi}.")]
        got = np.concatenate([amp["grads"][i].numpy().ravel() for i in idx])
        want = np.concatenate([ref[i].ravel() for i in idx])
        norm = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= 5e-2 * norm, (mi, np.linalg.norm(got - want) / norm)
        for i in idx:
            err = np.linalg.norm(amp["grads"][i].numpy() - ref[i])
            assert err <= 5e-2 * norm, (names[i], err / norm)


def test_amp_batch_stats_match_jax(amp):
    want = amp["view"].state_dict()
    got = amp["psys"].state_dict()
    stats = [k for k in want if "running_" in k]
    assert stats
    for k in stats:
        assert got[k].dtype == torch.float32
        scale = np.abs(want[k].numpy()).max()
        assert np.abs(got[k].numpy() - want[k].numpy()).max() <= 2e-2 * scale, k


def test_amp_gates_of_the_jax_package(amp):
    """Within 5 % of the float32 loss; after the update no bf16 anywhere in the
    state; 4 more steps finite and descending on the same batch; the frozen
    side's bf16 copy made once."""
    psys = amp["psys"]
    np.testing.assert_allclose(amp["loss"].item(), amp["f32_loss"], rtol=0.05)
    losses = [psys._apply_update(amp["grads"], amp["loss"])["loss"].item()]
    for i in range(4):
        losses.append(psys.train_step(amp["hr"], amp["lr"], seed=i + 1)["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for name, t in psys.state_dict().items():
        assert t.dtype != torch.bfloat16, name
    for p in psys.trainable_parameters():
        for v in psys.optimizer.state[p].values():
            assert not torch.is_tensor(v) or v.dtype != torch.bfloat16
    assert psys.frozen_bf16.made == 1


def test_amp_accum_step_composes(amp):
    """A 2-microbatch accum_train_step under AMP is the mean of two AMP
    micro steps (the BatchNorm statistics advancing between them) and one
    update, bit for bit, on the same frozen bf16 copy."""
    base = _port(state=amp["state"])
    twin = copy.deepcopy(base)
    hr, lr = _images(12)
    m = base.accum_train_step(hr, lr, seed=3, accum_steps=2)
    l0, g0 = twin._micro_grads(hr[:1], lr[:1], 6)
    l1, g1 = twin._micro_grads(hr[1:], lr[1:], 7)
    m2 = twin._apply_update([(a + b) * 0.5 for a, b in zip(g0, g1)], (l0 + l1) * 0.5)
    assert torch.equal(m["loss"], m2["loss"]) and np.isfinite(m["loss"].item())
    for (name, a), b in zip(base.state_dict().items(), twin.state_dict().values()):
        assert a.dtype != torch.bfloat16 and torch.equal(a, b), name
    assert base.frozen_bf16.made == twin.frozen_bf16.made == 1


def test_amp_casts_what_it_names(amp):
    """The PSN reads the bf16 LR image on the bf16 frozen copy; the PGRMs
    read bf16 activations on bf16 views of the float32 masters (not the
    masters themselves); the gradients land float32."""
    system = _port(state=amp["state"])
    seen = {}
    psn_forward = system._psn_forward

    def recording_psn(images, nets=None):
        seen["psn"] = (images.dtype, (nets or system).psn.conv_in.weight.dtype)
        return psn_forward(images, nets)

    system._psn_forward = recording_psn
    embed = system.pgrms[0].patch_embed
    hook = embed.register_forward_pre_hook(lambda m, args: seen.setdefault("pgrm", (args[0].dtype, m.weight)) and None)
    loss, grads = system._micro_grads(amp["hr"], amp["lr"], 0)
    hook.remove()
    x_dtype, weight = seen["pgrm"]
    assert seen["psn"] == (torch.bfloat16, torch.bfloat16) and system.frozen_bf16.made == 1
    assert x_dtype == weight.dtype == torch.bfloat16 and weight is not embed.weight
    assert torch.equal(weight.float(), embed.weight.to(torch.bfloat16).float())
    assert embed.weight.dtype == torch.float32
    assert np.isfinite(loss.item()) and all(g.dtype == torch.float32 for g in grads)


def test_amp_refuses_what_it_does_not_run():
    """train_dtype None or "bfloat16": "float16" raises; the "attention" and
    "full" cores build under AMP and run on bf16 tokens with float32 bias
    tables, giving bf16 out (K4 and K5 on bf16 io; tests/test_torch_amp_cores.py
    holds them against the JAX package)."""
    with pytest.raises(ValueError, match="float16"):
        _port("float16")
    for core in ("attention", "full"):
        system = _port(train_core=core)
        assert {blk.attn.train_core for p in system.pgrms for layer in p.layers for blk in layer.blocks} == {core}
        attn = WindowAttention(48, (2, 4, 8), (0, 0, 0), 6, (16, 64), train_core=core).train().to(torch.bfloat16)
        x = torch.zeros(1, 1024, 48, dtype=torch.bfloat16)
        ln = {k: torch.ones(48, dtype=torch.bfloat16) for k in ("qs", "qb", "ks", "kb")}
        out = attn(x, x, ln)
        assert out.dtype == torch.bfloat16 and out.shape == x.shape and torch.isfinite(out.float()).all()
