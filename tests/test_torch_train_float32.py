"""The port's train step against the JAX package's in float32 with the real
to_mask (how the port trains), the `train_step` entry point, and seeded
dropout; the flagship-geometry run behind `-m slow`.  The float64 slice with
the smooth to_mask is tests/test_torch_train_strict.py."""

import numpy as np
import pytest
import torch

import dpmn_tpu_torch.system as TS
from dpmn_tpu_torch.config import Args, TrainCfg, flagship_args
from test_torch_system import SMALL
from test_torch_train_helpers import TRAIN, _images, _port_system, _trainable_names, _two_steps


@pytest.fixture(scope="module")
def float32_real_mask():
    return _two_steps(TRAIN, mask_patch=False, dtype=torch.float32, images_seed=21)


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
