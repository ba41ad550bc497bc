"""bf16 AMP under every training core: the port against the JAX package on
the CPU, the JAX side with its switches for each core (K3, K4 and K5 in
interpret mode on bf16 io; tests/test_torch_train_blocks.py `JAX_MODES`).

The "attention" core's XLA side: the port's LayerNorm and projections on
bf16 tokens against the JAX package's `_layer_norm` and flax `nn.Dense` in
bf16 (float32 statistics rounded to bf16 once; the product rounded to bf16,
then the bias added in bf16), value for value: at most 1e-3 of the values
differ (2 of 196,608 and 23 of 393,216 seen: summation order, and XLA's
bf16 dot on the CPU rounding some partial sums), each by at most one bf16
step of the largest value; LN in bf16, or the bias added before the
rounding, moves about a quarter of them.

Block level: WindowAttention in train mode on bf16 tokens, bf16 parameters
and LayerNorm parameters, at rates 0, against the flax module on the same
bf16 values.  SKConv runs in bf16 outside the kernel under "block" and
"attention" in both packages, where XLA keeps float32 between fused
elementwise operations and PyTorch rounds after each, so the output parts
by up to 2^-6.85 of its largest value (2^-8.8 under "full", whose SKConv
runs in float32 inside the kernel on both sides).  Limits: the output within
2^-6 of its largest value; each parameter gradient within 2^-5 of its
largest value (0.021 seen), except SKConv's proj_head bias under "block" and
"attention": a sum over 2048 tokens of terms near 0.8, which XLA on the CPU
accumulates in bf16 and stalls at 512 (the port's float32 sum reads about
1,600), is held within 2^-5 of its largest value against the float32 sum
of the output's bf16 cotangent.

Whole step: the AMP step (`_micro_grads`) under "attention" and "full" at
the SMALL geometry of tests/test_torch_system.py, B = 2, rates 0, against
the JAX package's AMP step (`_amp_frozen_cast` + `_micro_grads`) with the
core's switches, the JAX step's glyph ids fed to the port, with
tests/test_torch_amp.py's limits: the loss within rel 1e-2 (1.2e-4 and
1.4e-3 seen); each PGRM's gradient as one vector within 5e-2 (2.2e-2 to
3.3e-2 seen), each leaf within 5e-2 of its PGRM's norm (2.2e-2 seen); the
state float32 after the step."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as JP
import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu.models.pgrm import WindowAttention as JWindowAttention
from dpmn_tpu_torch.config import Args, TrainCfg
import dpmn_tpu_torch.models.pgrm as port_pgrm
from dpmn_tpu_torch.models.pgrm import WindowAttention
from dpmn_tpu_torch.weights import from_jax, module_from_jax
from test_torch_helpers import init_variables
from test_torch_train_helpers import TRAIN, _images, _jax_state, _np, _patch_two_pass, _port_system, _trainable_names

# the JAX package's switches for each core with its Pallas kernel in
# interpret mode: "block" K3 (dpmn_tpu/models/pgrm.py:378-447), "attention"
# K4 (:449-510), "full" K5 (:418-437)
AMP_MODES = {"block": {"_PALLAS_WINDOW_MODE": "1"},
             "attention": {"_PALLAS_WINDOW_MODE": "1", "_FUSE_QKV_MODE": "0"},
             "full": {"_PALLAS_WINDOW_MODE": "1", "_FUSE_QKV_MODE": "1", "_FUSE_SKCONV_MODE": "1"}}


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def test_attention_core_ln_and_dense_round_as_flax():
    import flax.linen as nn
    from dpmn_tpu.ops.pallas_window import _layer_norm
    from dpmn_tpu_torch.models.pgrm import _dense_bf16, _layer_norm_bf16

    rng = np.random.RandomState(0)
    x, s, b = _bf16(rng.randn(2, 1024, 96) * 0.5), _bf16(1 + 0.1 * rng.randn(96)), _bf16(0.1 * rng.randn(96))
    w, wb = _bf16(rng.randn(96, 192) / 10), _bf16(0.1 * rng.randn(192))
    bf = jnp.bfloat16
    j_ln = _layer_norm(jnp.asarray(x, bf), jnp.asarray(s, bf), jnp.asarray(b, bf))
    j_kv = nn.Dense(192).apply({"params": {"kernel": jnp.asarray(w, bf), "bias": jnp.asarray(wb, bf)}}, j_ln)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    lin = torch.nn.Linear(96, 192).to(torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(t(w.T))
        lin.bias.copy_(t(wb))
        p_ln = _layer_norm_bf16(t(x), t(s), t(b))
        p_kv = _dense_bf16(p_ln, lin)
    for got, want in ((p_ln, j_ln), (p_kv, j_kv)):
        assert got.dtype == torch.bfloat16 and want.dtype == bf
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert (got != want).mean() <= 1e-3
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


@pytest.mark.parametrize("train_core", ["block", "attention", "full"])
def test_window_attention_bf16_matches_flax(monkeypatch, train_core):
    for name, mode in AMP_MODES[train_core].items():
        monkeypatch.setattr(JP, name, mode)
    rng = np.random.RandomState(7)
    h, w, c = 16, 64, 96
    xq, xkv = (_bf16(rng.randn(2, h * w, c) * 0.5) for _ in range(2))
    ln = [_bf16(1.0 + 0.1 * rng.randn(c)), _bf16(0.1 * rng.randn(c)), _bf16(1.0 + 0.1 * rng.randn(c)),
          _bf16(0.1 * rng.randn(c))]
    jm = JWindowAttention(dim=c, window_size=[2, 4, 8], shift_size=[1, 2, 4], num_heads=6, input_resolution=(h, w))
    bf = jnp.bfloat16
    args4 = [jnp.asarray(x.reshape(2, h, w, c), bf) for x in (xq, xkv)]
    variables = init_variables(jm, 8, *args4, False, ln=tuple(jnp.asarray(t, bf) for t in ln))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(_bf16(a), bf), variables["params"])

    def loss(params, ln):
        out, _ = jm.apply({"params": params}, *args4, False, ln=ln, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(jnp.tanh(out.astype(jnp.float32))), out

    (_, ref_out), (ref_g, ref_gln) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, tuple(jnp.asarray(t, bf) for t in ln))
    assert ref_out.dtype == bf

    port = WindowAttention(c, (2, 4, 8), (1, 2, 4), 6, (h, w), train_core=train_core).train()
    module_from_jax(port, {"params": _np(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params))})
    port = port.to(torch.bfloat16)
    lnp = {k: torch.from_numpy(t).to(torch.bfloat16).requires_grad_() for k, t in zip(("qs", "qb", "ks", "kb"), ln)}
    t = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    out = port(t(xq), t(xkv), lnp)
    assert out.dtype == torch.bfloat16
    torch.tanh(out.float()).sum().backward()
    ref = np.asarray(ref_out.astype(jnp.float32)).reshape(2, h * w, c)
    err = np.abs(out.detach().float().numpy() - ref).max()
    assert err <= 2.0**-6 * np.abs(ref).max(), err / np.abs(ref).max()

    want = WindowAttention(c, (2, 4, 8), (1, 2, 4), 6, (h, w))
    module_from_jax(want, {"params": _np(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), ref_g))})
    want = dict(want.named_parameters())
    pairs = [(n, p.grad, want[n].detach()) for n, p in port.named_parameters()]
    pairs += [(k, lnp[k].grad, torch.from_numpy(np.asarray(g.astype(jnp.float32))))
              for k, g in zip(("qs", "qb", "ks", "kb"), ref_gln)]
    assert len(pairs) == 19
    for name, g, r in pairs:
        assert g.dtype == torch.bfloat16, name
        err = (g.float() - r).abs().max().item()
        if name == "SKConv.proj_head.bias" and train_core != "full":
            # XLA's bf16 sum stalls at 512 here (2048 terms near 0.8): held
            # against the float32 sum of the bf16 cotangent of the output
            cot = (1 - torch.tanh(out.detach().float()) ** 2).to(torch.bfloat16).float()
            r = cot.sum(dim=(0, 1))
            assert (g.float() - r).abs().max().item() <= 2.0**-5 * r.abs().max().item(), name
        else:
            assert err <= 2.0**-5 * r.abs().max().item(), (name, err / r.abs().max().item())


def _port(train_core, state):
    system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", train_dtype="bfloat16",
                           train_core=train_core)
    from_jax(state, system)
    return system


@pytest.fixture(scope="module", params=["attention", "full"])
def amp_step(request):
    """One AMP micro step of each package from one state under the core, the
    port fed the JAX step's glyph ids."""
    core = request.param
    hr, lr = _images(11)
    with pytest.MonkeyPatch.context() as mp:
        _patch_two_pass(mp)
        for name, mode in AMP_MODES[core].items():
            mp.setattr(JP, name, mode)
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
        j = dict(loss=float(loss), grads=_np(grads))
    assert len(ids) == 2
    view = _port_system(TRAIN, torch.float32, dict(state, params=j["grads"], batch_stats=_np(new_bs)))
    psys = _port(core, state)
    it = iter(ids)
    hook = psys.glyph.register_forward_pre_hook(lambda m, args: tuple(torch.from_numpy(a) for a in next(it)))
    calls = []  # (core function, dtype of its first token tensor) per call
    with pytest.MonkeyPatch.context() as mp:
        for name in ("window_attention_block_core", "window_attention_core", "window_attention_full_core"):
            def spy(*args, _fn=getattr(port_pgrm, name), _name=name):
                calls.append((_name, args[0].dtype))
                return _fn(*args)

            mp.setattr(port_pgrm, name, spy)
        p_loss, p_grads = psys._micro_grads(hr, lr, 0)
    hook.remove()
    return dict(core=core, j=j, view=view, psys=psys, loss=p_loss, grads=p_grads, calls=calls, hr=hr, lr=lr)


def test_amp_step_loss_matches_jax(amp_step):
    """The loss within rel 1e-2; every PGRM ran the core asked for, on bf16."""
    assert amp_step["loss"].dtype == torch.float32
    np.testing.assert_allclose(amp_step["loss"].item(), amp_step["j"]["loss"], rtol=1e-2)
    name = {"attention": "window_attention_core", "full": "window_attention_full_core"}[amp_step["core"]]
    assert amp_step["calls"] and set(amp_step["calls"]) == {(name, torch.bfloat16)}


def test_amp_step_pgrm_gradients_match_jax(amp_step):
    view = amp_step["view"]
    ref = [p.detach().numpy() for p in view.trainable_parameters()]
    names = _trainable_names(view)
    grads = amp_step["grads"]
    assert len(names) == len(ref) == len(grads)
    assert all(g.dtype == torch.float32 for g in grads)
    for mi in range(len(view.pgrms)):
        idx = [i for i, n in enumerate(names) if n.startswith(f"pgrms.{mi}.")]
        got = np.concatenate([grads[i].numpy().ravel() for i in idx])
        want = np.concatenate([ref[i].ravel() for i in idx])
        norm = np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= 5e-2 * norm, (mi, np.linalg.norm(got - want) / norm)
        for i in idx:
            err = np.linalg.norm(grads[i].numpy() - ref[i])
            assert err <= 5e-2 * norm, (names[i], err / norm)


def test_amp_step_state_stays_float32(amp_step):
    """After the update no bf16 in the parameters, buffers or Adam state; the
    loss finite."""
    psys = amp_step["psys"]
    m = psys._apply_update(amp_step["grads"], amp_step["loss"])
    assert np.isfinite(m["loss"].item())
    for name, t in psys.state_dict().items():
        assert t.dtype != torch.bfloat16, name
    for p in psys.trainable_parameters():
        for v in psys.optimizer.state[p].values():
            assert not torch.is_tensor(v) or v.dtype != torch.bfloat16
