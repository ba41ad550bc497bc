"""The port's train-mode modules against the JAX package's, on the same
numpy-seeded weights and inputs: the losses, the flax-style BatchNorm (CMM
and DistillModule in train mode: output, loss, feature and the new
batch_stats), SKConv's forward, and dropout / DropPath.  Tolerances: rtol
1e-4, atol 1e-5 for values.  The train-mode Swin blocks under each training
core are in tests/test_torch_train_blocks.py; the whole train step in
tests/test_torch_train_strict.py (float64) and
tests/test_torch_train_float32.py.

BatchNorm statistics: flax computes the batch variance as E[x^2] - E[x]^2
(`use_fast_variance`), torch in two passes.  At B = 2 the CMM's deep
BatchNorms see 8 to 32 values per channel with means large against their
spread, and the one-pass form cancels: held against a float64 run of the
port, flax's float32 CMM gradients are off by up to 2.6e-2 of their leaf's
largest value, the port's by 3.7e-6, and flax's with the two-pass variance
by 3.5e-6 (test_cmm_gradients_against_float64).  So the tests with train-mode
BatchNorms run the JAX side with the two-pass variance (`two_pass_variance`),
a test-local patch of flax; the port keeps torch's two-pass statistics."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.losses as JL
from dpmn_tpu.models.cmm import CMM as JCMM
from dpmn_tpu.models.distill import DistillModule as JDistill
from dpmn_tpu.models.pgrm import SKConv as JSKConv
from dpmn_tpu_torch import losses as TL
from dpmn_tpu_torch.models.cmm import CMM
from dpmn_tpu_torch.models.distill import DistillModule
from dpmn_tpu_torch.models.pgrm import SKConv
from dpmn_tpu_torch.ops.batch_norm import BatchNorm2d
from dpmn_tpu_torch.ops.dropout import TrainRng, drop_path, dropout
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc
from test_torch_train_helpers import _np, _patch_two_pass

RTOL, ATOL = 1e-4, 1e-5


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
