"""The port's train step against the JAX package's, module by module and for
the whole slice, on the same numpy-seeded weights and inputs.

Modules: the losses, the flax-style BatchNorm (CMM and DistillModule in train
mode: output, loss, feature and the new batch_stats), SKConv's forward, a
train-mode SwinTransformerBlock (output and every parameter gradient against
flax value_and_grad with deterministic=False; on the CPU the JAX block takes
its XLA path, the port its K3 autograd Function over the plain version), and
dropout / DropPath at rate 0.  Tolerances: rtol 1e-4, atol 1e-5 for values,
rtol 2e-3, atol 2e-4 for the block's gradients (the JAX package's own for its
training kernel, tests/test_pallas_train.py:173-182).

The slice: the SMALL configuration of tests/test_torch_system.py with the
gradient loss and every dropout rate at 0, B = 2, two train steps on both
sides (so Adam's bias correction at step 2 is covered); the JAX side is
`_micro_grads` + `_apply_update`, the port's `_micro_grads` + `_apply_update`
(which `train_step` chains).  Held strictly where a test-local patch swaps
to_mask for the same smooth function on both sides (its uint8 thresholds can
flip on a 1e-6 difference), loosely with the real one.

BatchNorm statistics: flax computes the batch variance as E[x^2] - E[x]^2
(`use_fast_variance`), torch in two passes.  At B = 2 the CMM's deep
BatchNorms see 8 to 32 values per channel with means large against their
spread, and the one-pass form cancels: held against a float64 run of the
port, flax's float32 CMM gradients are off by up to 2.6e-2 of their leaf's
largest value, the port's by 3.7e-6, and flax's with the two-pass variance
by 3.5e-6 (test_cmm_gradients_against_float64).  So the tests with train-mode
BatchNorms run the JAX side with the two-pass variance (`two_pass_variance`),
a test-local patch of flax like the smooth to_mask; the port keeps torch's
two-pass statistics."""

import flax.linen as fnn
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dpmn_tpu.losses as JL
import dpmn_tpu.models.pgrm as jax_pgrm
import dpmn_tpu.system as JS
import dpmn_tpu_torch.models.pgrm as port_pgrm
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu.models.cmm import CMM as JCMM
from dpmn_tpu.models.distill import DistillModule as JDistill
from dpmn_tpu.models.pgrm import SKConv as JSKConv
from dpmn_tpu.models.pgrm import SwinTransformerBlock as JBlock
from dpmn_tpu_torch import losses as TL
from dpmn_tpu_torch.config import Args, TrainCfg, flagship_args
from dpmn_tpu_torch.models.cmm import CMM
from dpmn_tpu_torch.models.distill import DistillModule
from dpmn_tpu_torch.models.pgrm import SKConv, SwinTransformerBlock
from dpmn_tpu_torch.ops.batch_norm import BatchNorm2d
from dpmn_tpu_torch.ops.dropout import TrainRng, drop_path, dropout
from dpmn_tpu_torch.weights import from_jax, module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc, random_variables
from test_torch_system import SMALL

RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _patch_two_pass(mp):
    compute_stats = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    mp.setattr(flax_norm, "_compute_stats", two_pass)


@pytest.fixture
def two_pass_variance(monkeypatch):
    _patch_two_pass(monkeypatch)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("gradient", [False, True])
def test_image_loss_matches(gradient):
    rng = np.random.RandomState(0)
    out, hr = rng.rand(2, 32, 128, 4).astype(np.float32), rng.rand(2, 32, 128, 4).astype(np.float32)
    ref = float(JL.image_loss(jnp.asarray(out[..., :3]), jnp.asarray(hr[..., :3]), gradient=gradient))
    got = TL.image_loss(nchw(out)[:, :3], nchw(hr)[:, :3], gradient).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(TL.gradient_prior_loss(nchw(out), nchw(hr)).item(),
                               float(JL.gradient_prior_loss(jnp.asarray(out), jnp.asarray(hr))), rtol=1e-6)
    np.testing.assert_allclose(nhwc(TL.gradient_map(nchw(out))), np.asarray(JL.gradient_map(jnp.asarray(out))),
                               rtol=1e-6, atol=1e-7)


def test_distill_train_matches(two_pass_variance):
    rng = np.random.RandomState(1)
    deep, shallow = (rng.rand(2, 32, 128, 3).astype(np.float32) for _ in range(2))
    jm = JDistill()
    variables = init_variables(jm, 2, jnp.asarray(deep), jnp.asarray(shallow))
    (ref_loss, ref_feat), mut = jm.apply(variables, jnp.asarray(deep), jnp.asarray(shallow), train=True,
                                         mutable=["batch_stats"])
    port = DistillModule().train()
    module_from_jax(port, variables)
    loss, feat = port(nchw(deep), nchw(shallow))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    np.testing.assert_allclose(nhwc(feat), np.asarray(ref_feat), rtol=RTOL, atol=ATOL)
    for name, bn in (("bn_1", port.bn_1), ("bn_2", port.bn_2)):
        stats = mut["batch_stats"][name]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=RTOL, atol=1e-6)


def test_batch_norm_running_var_is_flax():
    """flax moves the running variance toward the biased batch variance;
    torch's stock BatchNorm2d toward the unbiased one, which fails here."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 4, 5) * 2 + 1).astype(np.float32)  # 2 * 4 * 5 = 40 values per channel
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x.transpose(0, 2, 3, 1)))
    y_ref, mut = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    ours, stock = BatchNorm2d(3).train(), torch.nn.BatchNorm2d(3).train()
    y = ours(torch.from_numpy(x))
    stock(torch.from_numpy(x))
    ref_var = np.asarray(mut["batch_stats"]["var"])
    np.testing.assert_allclose(ours.running_var.numpy(), ref_var, rtol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y_ref), rtol=RTOL, atol=ATOL)
    assert not np.allclose(stock.running_var.numpy(), ref_var, rtol=1e-3)
    ours.eval()
    np.testing.assert_array_equal(ours(torch.from_numpy(x)).detach().numpy(),
                                  torch.nn.functional.batch_norm(torch.from_numpy(x), ours.running_mean,
                                                                 ours.running_var, ours.weight, ours.bias,
                                                                 False, 0.0, ours.eps).detach().numpy())


def test_cmm_train_matches():
    """CMM in train mode: batch statistics in the forward, flax's running-stat
    update; both in float64 (JAX under jax.enable_x64), rtol 1e-7 and atol
    1e-9.  In float32 at B = 2 the output is determined only to ~5e-5: its
    1x4 bottleneck sees 8 values per channel, and a leaky-ReLU input within
    rounding of 0 changes slope."""
    rng = np.random.RandomState(3)
    x1, x2 = (rng.rand(2, 32, 128, 3) for _ in range(2))
    jm = JCMM()
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                       init_variables(jm, 4, jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)))
    with jax.enable_x64(True):
        ref, mut = jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2), train=True, mutable=["batch_stats"])
        ref, mut = np.asarray(ref), _np(mut["batch_stats"])
    assert ref.dtype == np.float64
    port = CMM().double().train()
    module_from_jax(port, variables)
    out = port(nchw(x1), nchw(x2))
    np.testing.assert_allclose(nhwc(out), ref, rtol=1e-7, atol=1e-9)
    fresh = CMM().double()
    module_from_jax(fresh, {"params": variables["params"], "batch_stats": mut})
    want = dict(fresh.named_buffers())
    n = 0
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-7, atol=1e-9, err_msg=name)
            n += 1
    assert n == 50


@pytest.mark.parametrize("fast_variance", [True, False])
def test_cmm_gradients_against_float64(monkeypatch, fast_variance):
    """The CMM's train-mode parameter gradients at B = 2 (a random cotangent),
    held against a float64 run of the port: the port's float32 within 2e-5
    of each leaf's largest value, flax's too with the two-pass variance, and
    flax's one-pass variance further off than 1e-3 in some leaf."""
    if not fast_variance:
        _patch_two_pass(monkeypatch)
    rng = np.random.RandomState(3)
    x1, x2 = (rng.rand(2, 32, 128, 3).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, 32, 128, 3).astype(np.float32)
    jm = JCMM()
    variables = init_variables(jm, 4, jnp.asarray(x1), jnp.asarray(x2))

    def f(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x1),
                          jnp.asarray(x2), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    view = CMM()
    module_from_jax(view, {"params": _np(jax.grad(f)(variables["params"])),
                           "batch_stats": variables["batch_stats"]})
    jax_g = dict(view.named_parameters())

    def port_grads(dtype):
        port = CMM().train()
        module_from_jax(port, variables)
        port = port.to(dtype)
        (port(nchw(x1).to(dtype), nchw(x2).to(dtype)) * nchw(cot).to(dtype)).sum().backward()
        return {n: p.grad.double() for n, p in port.named_parameters()}

    g32, g64 = port_grads(torch.float32), port_grads(torch.float64)
    worst_port = worst_jax = 0.0
    for name, ref in g64.items():
        m = ref.abs().max().item()
        if m < 1e-3:  # biases ahead of a BatchNorm: zero up to rounding
            continue
        worst_port = max(worst_port, (g32[name] - ref).abs().max().item() / m)
        worst_jax = max(worst_jax, (jax_g[name].detach().double() - ref).abs().max().item() / m)
    assert worst_port < 2e-5
    assert worst_jax > 1e-3 if fast_variance else worst_jax < 2e-5


def test_skconv_forward_matches():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 64, 48).astype(np.float32)
    jm = JSKConv(dim=48, m=3)
    variables = init_variables(jm, 5, jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    port = SKConv(48, 3)
    for j, lin in enumerate((port.proj, port.fc1, port.fc2, port.proj_head)):
        p = variables["params"][f"Dense_{j}"]
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    with torch.no_grad():
        out = port(torch.from_numpy(x.reshape(2, 1024, 48)))
    np.testing.assert_allclose(out.numpy().reshape(ref.shape), ref, rtol=RTOL, atol=ATOL)


# the JAX package's switches for each training core (dpmn_tpu/models/pgrm.py:44,
# :61-65): K4 and K5 run in interpret mode on the CPU; "block" keeps the
# default, where the CPU takes the XLA formulation
JAX_MODES = {"block": {}, "attention": {"_PALLAS_WINDOW_MODE": "1", "_FUSE_QKV_MODE": "0"},
             "full": {"_PALLAS_WINDOW_MODE": "1", "_FUSE_QKV_MODE": "1", "_FUSE_SKCONV_MODE": "1"}}


def _check_swin_block_train(monkeypatch, shift, faithful, train_core):
    """Train mode at rates 0: output and every parameter gradient of
    sum(tanh(x_kv)) against flax value_and_grad with deterministic=False.
    Returns the port block."""
    rng = np.random.RandomState(7)
    xq = (rng.randn(2, 1024, 96) * 0.5).astype(np.float32)
    xkv = (rng.randn(2, 1024, 96) * 0.5).astype(np.float32)
    jm = JBlock(dim=96, input_resolution=(16, 64), num_heads=6, window_size=[2, 4, 8], shift_size=list(shift),
                faithful=faithful)
    variables = init_variables(jm, 8, jnp.asarray(xq), jnp.asarray(xkv))
    for name, mode in JAX_MODES[train_core].items():
        monkeypatch.setattr(jax_pgrm, name, mode)

    def loss(params):
        _, out = jm.apply({"params": params}, jnp.asarray(xq), jnp.asarray(xkv), False,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(jnp.tanh(out)), out

    (ref_l, ref_out), ref_g = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    port = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], list(shift), faithful=faithful,
                                train_core=train_core).train()
    module_from_jax(port, variables)
    x_q = torch.from_numpy(xq)
    out_q, out = port(x_q, torch.from_numpy(xkv))
    assert out_q is x_q
    l = torch.tanh(out).sum()
    l.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.item(), float(ref_l), rtol=1e-5)
    want = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], list(shift), faithful=faithful)
    module_from_jax(want, {"params": _np(ref_g)})
    want = dict(want.named_parameters())
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == len(want) == 29
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)
    return port


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("faithful", [True, False])
def test_swin_block_train_matches(monkeypatch, shift, faithful):
    """The default core ("block", kernel K3's plain version) against flax."""
    _check_swin_block_train(monkeypatch, shift, faithful, "block")


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("train_core", ["attention", "full"])
def test_swin_block_train_core_matches(monkeypatch, train_core, faithful):
    """The other two cores, shifted windows, against the flax block with the
    JAX package's matching switches: "attention" (K4) against its
    window_attention_core, "full" (K5) against its window_attention_full_core
    — and with the corrected layout, where both packages run K3's core."""
    calls = {"block": 0, "attention": 0, "full": 0}
    for core, fn in (("block", "window_attention_block_core"), ("attention", "window_attention_core"),
                     ("full", "window_attention_full_core")):
        def spy(*args, _core=core, _fn=getattr(port_pgrm, fn)):
            calls[_core] += 1
            return _fn(*args)

        monkeypatch.setattr(port_pgrm, fn, spy)
    port = _check_swin_block_train(monkeypatch, (1, 2, 4), faithful, train_core)
    ran = "block" if train_core == "full" and not faithful else train_core
    assert port.attn.train_core == ran
    assert calls == {core: int(core == ran) for core in calls}


def test_train_core_resolves_from_the_environment(monkeypatch):
    """None reads DPMN_TPU_FUSE_QKV / DPMN_TPU_FUSE_SKCONV with the JAX
    package's defaults and precedence; an explicit core wins."""
    table = [((None, None), "block"), (("1", "0"), "block"), ((None, "1"), "full"), (("1", "1"), "full"),
             (("0", None), "attention"), (("0", "1"), "attention"), (("0", "0"), "attention")]
    for (qkv, sk), want in table:
        for name, value in (("DPMN_TPU_FUSE_QKV", qkv), ("DPMN_TPU_FUSE_SKCONV", sk)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        assert port_pgrm.resolve_train_core() == want, (qkv, sk)
        assert port_pgrm.resolve_train_core("attention") == "attention"
        for faithful in (True, False):
            wa = port_pgrm.WindowAttention(48, [2, 4, 8], [1, 2, 4], 6, (8, 32), faithful=faithful)
            assert wa.train_core == ("block" if want == "full" and not faithful else want)
    with pytest.raises(ValueError):
        port_pgrm.resolve_train_core("fused")


@pytest.fixture(scope="module")
def small_state():
    """A random JAX train state of the small configuration (numpy leaves)."""
    jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**TRAIN), glyph_mode="atlas")
    return _jax_state(jsys, 2)


@pytest.mark.parametrize("train_core", port_pgrm.TRAIN_CORES)
def test_weights_load_under_every_core(small_state, train_core):
    """One JAX state fills the port system under each core with no missing or
    extra leaf (from_jax raises on either); the cores share one tree, as the
    JAX package's three paths do."""
    system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", train_core=train_core)
    from_jax(small_state, system)
    cores = {m.train_core for m in system.modules() if isinstance(m, port_pgrm.WindowAttention)}
    assert cores == {train_core}


def test_dropout_rate_zero_is_the_identity_and_draws_nothing():
    x = torch.randn(4, 8, 6)
    rng = TrainRng(0, "cpu")
    state = rng.device.get_state().clone()
    assert dropout(x, 0.0, rng) is x and drop_path(x, 0.0, rng) is x
    assert dropout(x, 0.0, None) is x and drop_path(x, 0.0, None) is x
    assert torch.equal(rng.device.get_state(), state)
    with pytest.raises(ValueError):
        dropout(x, 0.1, None)


def test_dropout_is_seeded_and_scaled():
    x = torch.ones(64, 100, 10)
    a, b = dropout(x, 0.25, TrainRng(3, "cpu")), dropout(x, 0.25, TrainRng(3, "cpu"))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((a > 0).float().mean().item() - 0.75) < 0.01
    p = drop_path(x, 0.5, TrainRng(4, "cpu"))
    per_sample = p.reshape(64, -1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == 2.0).all(1))
    assert 0 < (per_sample[:, 0] == 0).sum() < 64
    assert TrainRng(5, "cpu").kernel_seed() == TrainRng(5, "cpu").kernel_seed()


# -------------------------------------------------------------- whole slice

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


def _grad_leaves(res, step):
    """(name, port grad, JAX grad in port layout) for every trainable parameter."""
    j = res["j"][step]
    view = _port_system(res["kw"], res["dtype"], dict(j["state"], params=j["grads"]))
    ref = [p.detach().numpy() for p in view.trainable_parameters()]
    names = _trainable_names(view)
    assert len(names) == len(ref) == len(res["p"][step]["grads"])
    return list(zip(names, res["p"][step]["grads"], ref))


@pytest.fixture(scope="module")
def strict():
    """Both packages in float64 with the smooth to_mask, step 2 from the JAX
    package's state after step 1.

    In float32 the slice's gradients are not determined to 1e-3 at B = 2:
    the CMM's 1x4 bottleneck sees 8 values per channel, and a leaky-ReLU
    input within rounding of 0 changes slope there and moves the gradient of
    everything upstream — the port's own float32 gradients sit up to 2e-2 of
    a leaf's largest value from its float64 ones, the JAX package's likewise.
    Both in float64, the two compute the same function to ~1e-7 (the JAX
    cascade casts its losses to float32).  Adam's first step is ~lr * sign(g)
    for every element, so an element whose gradient is at rounding level on
    both sides (a fifth of the CMM's, whose deep weights get almost none)
    takes a full step either way; the second step therefore starts from the
    JAX package's state, which the chained run (the float32 test below) does
    not need."""
    return _two_steps(TRAIN, mask_patch=True, dtype=torch.float64, resync=True)


@pytest.fixture(scope="module")
def float32_real_mask():
    return _two_steps(TRAIN, mask_patch=False, dtype=torch.float32, images_seed=21)


def test_train_step_loss_and_grad_norm(strict):
    for step, rtol in ((0, 1e-5), (1, 1e-4)):
        j, p = strict["j"][step], strict["p"][step]
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-4)


def test_train_step_student_ids(strict):
    j_ids, p_ids = strict["ids"]
    assert len(j_ids) == len(p_ids) == 4  # b1 = 2 students, two steps
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)


def test_train_step_gradients(strict):
    """Every gradient leaf of both steps: rtol 1e-3, atol 1e-5."""
    for step in (0, 1):
        for name, got, want in _grad_leaves(strict, step):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=f"step {step + 1}: {name}")


def test_train_step_batch_stats(strict):
    """CMM and distill running statistics after each step, rtol 1e-4."""
    for step in (0, 1):
        view = _port_system(strict["kw"], strict["dtype"], strict["j"][step]["state"])
        got = strict["p"][step]["state"]
        n = 0
        for name, buf in view.named_buffers():
            if name.startswith(("cmm.", "distills.")) and name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[name].numpy(), buf.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
                n += 1
        assert n == 2 * (25 + 4)  # 25 CMM BatchNorms, 2 distills x 2; mean and var each


def test_train_step_params(strict):
    """The state after each step (the second from the JAX package's first):
    trainable parameters at atol 1e-5 (1 % of one lr = 1e-3 step), except
    elements whose gradients on the two sides differ in sign on that step,
    where Adam's step (~lr * sign(g) at step 1) may go either way: their
    share is counted and must stay under 1 %.  The BatchNorm statistics at
    rtol 1e-4; everything else in the state_dict unchanged and exact."""
    for step in (0, 1):
        view = _port_system(strict["kw"], strict["dtype"], strict["j"][step]["state"])
        got = strict["p"][step]["state"]
        flips = {name: np.sign(g_p) != np.sign(g_j) for name, g_p, g_j in _grad_leaves(strict, step)}
        share = sum(int(f.sum()) for f in flips.values()) / sum(f.size for f in flips.values())
        assert share < 0.01, f"step {step + 1}: {share:.2%} of the elements have gradients of opposite signs"
        for name, want in view.state_dict().items():
            have, want = got[name].numpy(), want.numpy()
            if name in flips:
                off = (np.abs(have - want) > 1e-5) & ~flips[name]
                assert not off.any(), f"step {step + 1}: {name}: {off.sum()} elements off by more than 1e-5"
            elif name.endswith(("running_mean", "running_var")) and name.startswith(("cmm.", "distills.")):
                np.testing.assert_allclose(have, want, rtol=1e-4, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)


def test_train_step_float32_real_mask(float32_real_mask):
    """In float32 (how the port trains) and with the real to_mask: the ids
    exact; step 1's loss within 1e-5 and grad_norm within 1e-4; step 2, after
    an Adam step whose sign is undetermined for the elements with a
    rounding-level gradient, loss within 1e-4 and grad_norm within 1e-2; the
    parameters after two steps within 5 lr = 5e-3 everywhere and 1e-4 on
    average (2.6e-5 seen)."""
    res = float32_real_mask
    j_ids, p_ids = res["ids"]
    assert len(j_ids) == len(p_ids) == 4
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    for step, (l_tol, g_tol) in enumerate(((1e-5, 1e-4), (1e-4, 1e-2))):
        j, p = res["j"][step], res["p"][step]
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=l_tol)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=g_tol)
    view = _port_system(res["kw"], torch.float32, res["j"][1]["state"])
    got = res["p"][1]["state"]
    diffs = np.concatenate([np.abs(got[n].numpy() - p.detach().numpy()).ravel()
                            for n, p in zip(_trainable_names(view), view.trainable_parameters())])
    assert diffs.max() <= 5e-3 and diffs.mean() <= 1e-4, (diffs.max(), diffs.mean())


def test_train_step_entry_point():
    """`train_step` chains the two halves the tests above hold: same loss and
    grad_norm, 0-d tensors; the trainable modules go back to eval mode, and
    a later sr_forward still runs the eval path."""
    hr, lr = _images(5)
    a = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", seed=1)
    b = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", seed=1)
    m = a.train_step(hr, lr, seed=3)
    loss, grads = b._micro_grads(hr, lr, 3)
    m2 = b._apply_update(grads, loss)
    assert m["loss"].dim() == 0 and m["grad_norm"].dim() == 0
    assert torch.equal(m["loss"], m2["loss"]) and torch.equal(m["grad_norm"], m2["grad_norm"])
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    assert not any(mod.training for mod in a.modules())
    assert a.sr_forward(lr).shape == (2, 32, 128, 3)


def test_train_step_cores_agree_in_float64(monkeypatch, small_state):
    """One train step of the port in float64 under each training core, from
    one state, with the smooth to_mask of the float64 tests above: loss,
    grad_norm and every gradient of "attention" and "full" equal "block"'s
    to rtol 1e-9 ("block" is held against the JAX package by the `strict`
    tests).  Gradients at rounding level (the biases ahead of a BatchNorm)
    are held at 1e-9 of grad_norm."""
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    hr, lr = _images(7)
    runs = {}
    for core in port_pgrm.TRAIN_CORES:
        system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**TRAIN), device="cpu", train_core=core).double()
        from_jax(small_state, system)
        loss, grads = system._micro_grads(hr, lr, 0)
        metrics = system._apply_update(grads, loss)
        runs[core] = (metrics["loss"].item(), metrics["grad_norm"].item(), grads)
    loss, norm, grads = runs["block"]
    for core in ("attention", "full"):
        np.testing.assert_allclose(runs[core][0], loss, rtol=1e-9)
        np.testing.assert_allclose(runs[core][1], norm, rtol=1e-9)
        assert len(runs[core][2]) == len(grads)
        for a, b in zip(runs[core][2], grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9 * norm)


def test_train_step_with_dropout_is_seeded():
    """At the flagship rates of 0.1 the step is a function of its seed."""
    hr, lr = _images(6)
    kw = dict(SMALL, gradient=True, drop_rate="0.1,", attn_drop_rate="0.1,", drop_path_rate="0.1,")
    runs = []
    for seed in (1, 1, 2):
        s = TS.DPMNSystem(TrainCfg(batch_size=2, optimizer="AdamW"), Args(**kw), device="cpu", seed=0)
        runs.append(s.train_step(hr, lr, seed=seed)["loss"].item())
    assert runs[0] == runs[1] != runs[2]
    assert np.isfinite(runs).all()


@pytest.mark.slow
def test_train_step_flagship_geometry():
    """The flagship configuration (3+3 PGRMs at embed 96, 5 SRBs) at B = 2,
    rates 0, smooth to_mask, both in float64: loss and grad_norm of two
    steps."""
    kw = dict(vars(flagship_args()), drop_rate="0,", attn_drop_rate="0,", drop_path_rate="0,")
    res = _two_steps(kw, mask_patch=True, dtype=torch.float64, seed=3)
    for step in (0, 1):
        np.testing.assert_allclose(res["p"][step]["loss"], res["j"][step]["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["p"][step]["grad_norm"], res["j"][step]["grad_norm"], rtol=1e-4)
