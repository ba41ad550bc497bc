"""The port's train step against the JAX package's for the whole slice, in
float64: the SMALL configuration of tests/test_torch_system.py with the
gradient loss and every dropout rate at 0, B = 2, two train steps on both
sides (so Adam's bias correction at step 2 is covered); the JAX side is
`_micro_grads` + `_apply_update`, the port's `_micro_grads` +
`_apply_update` (which `train_step` chains), with a test-local patch that
swaps to_mask for the same smooth function on both sides (its uint8
thresholds can flip on a 1e-6 difference).  The float32 run with the real
to_mask is tests/test_torch_train_float32.py."""

import numpy as np
import pytest
import torch

from test_torch_train_helpers import TRAIN, _grad_leaves, _state_view, _two_steps


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
        view = _state_view(strict, step)
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
        view = _state_view(strict, step)
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
