"""The port's train-mode SwinTransformerBlock under each training core
against flax value_and_grad with deterministic=False, on the same
numpy-seeded weights and inputs (on the CPU the JAX block takes its XLA path
or, with the JAX package's switches, its K4 / K5 kernels in interpret mode;
the port its autograd Function over the plain version): output and every
parameter gradient, rtol 2e-3, atol 2e-4 for the gradients (the JAX
package's own for its training kernel, tests/test_pallas_train.py:173-182).
Also: the core's resolution from the environment, one JAX state loading
under every core, and a float64 train step of the port under the three
cores, which must agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as jax_pgrm
import dpmn_tpu.system as JS
import dpmn_tpu_torch.models.pgrm as port_pgrm
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu.models.pgrm import SwinTransformerBlock as JBlock
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
from dpmn_tpu_torch.weights import from_jax, module_from_jax
from test_torch_helpers import init_variables
from test_torch_train_helpers import TRAIN, _images, _jax_state, _np


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
