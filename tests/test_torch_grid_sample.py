"""The port's grid sampling, rotation, TPS warp and STN head against
dpmn_tpu's on the same seeded numpy inputs and weights (atol 1e-5: float32
sums of a few terms in other orders; bf16 images are compared on the
float32 blend's bf16 rounding, which both packages take once)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu_torch.models import stn as TS
from dpmn_tpu_torch.models import tps as TT
from dpmn_tpu_torch.ops import grid_sample as TG
from dpmn_tpu_torch.ops import rotate as TR
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc

# dpmn_tpu.ops exports functions under its modules' names
JS, JT, JG, JR = (importlib.import_module(f"dpmn_tpu.{m}") for m in ("models.stn", "models.tps", "ops.grid_sample",
                                                                      "ops.rotate"))
ATOL = 1e-5


def _image(seed, shape=(2, 12, 20, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", [0.9, 1.4])
def test_grid_sample_matches(align_corners, dtype, span):
    """Grids inside [-1, 1] (span 0.9) and reaching past it (span 1.4, the
    zeros padding)."""
    x = _image(0)
    grid = np.random.RandomState(1).uniform(-span, span, (2, 9, 17, 2)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = JG.grid_sample(jx, jnp.asarray(grid), align_corners=align_corners)
    out = TG.grid_sample(nchw(x).to(getattr(torch, dtype)), torch.from_numpy(grid), align_corners=align_corners)
    assert out.dtype == getattr(torch, dtype) and str(ref.dtype) == dtype
    out32 = nhwc(out.float())
    ref32 = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out32, ref32, atol=ATOL, rtol=0)
        if span > 1:
            assert (ref32 == 0).any()  # some taps fell outside the image
    else:
        # the float32 blends agree to ATOL; their bf16 roundings agree unless
        # a blend lies within that of a rounding boundary (then 1 bf16 ulp)
        blend = np.asarray(JG.grid_sample(jnp.asarray(jx.astype(jnp.float32)), jnp.asarray(grid),
                                          align_corners=align_corners))
        differ = out32 != ref32
        assert differ.mean() < 1e-3
        np.testing.assert_allclose(out32[differ], ref32[differ], rtol=2.0**-7)
        np.testing.assert_allclose(out32, blend, atol=2.0**-8 + ATOL)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid_and_rotate_match(align_corners):
    rng = np.random.RandomState(2)
    theta = rng.randn(3, 2, 3).astype(np.float32)
    ref = np.asarray(JG.affine_grid(jnp.asarray(theta), (3, 7, 11), align_corners=align_corners))
    out = TG.affine_grid(torch.from_numpy(theta), (3, 7, 11), align_corners=align_corners).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    x = _image(3, (3, 16, 64, 3))
    arc = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    offs = rng.rand(3).astype(np.float32)
    ref = np.asarray(JR.rotate_images(jnp.asarray(x), jnp.asarray(arc), jnp.asarray(offs)))
    out = nhwc(TR.rotate_images(nchw(x), torch.from_numpy(arc), torch.from_numpy(offs)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_random_rotate_draws_from_the_generator():
    lr, hr = torch.rand(2, 3, 16, 64), torch.rand(2, 3, 32, 128)
    a = TR.random_rotate(lr, hr, torch.Generator().manual_seed(5), 15.0)
    b = TR.random_rotate(lr, hr, torch.Generator().manual_seed(5), 15.0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].shape == lr.shape and a[1].shape == hr.shape
    assert not torch.equal(a[0], TR.random_rotate(lr, hr, torch.Generator().manual_seed(6), 15.0)[0])


def test_tps_constants_and_warp_match():
    for got, want in zip(TT._tps_constants(32, 100, 20, (0.05, 0.05)), JT._tps_constants(32, 100, 20, (0.05, 0.05))):
        np.testing.assert_array_equal(got, want)
    tps = TT.TPSSpatialTransformer((32, 100), 20, (0.05, 0.05))
    assert not tps.state_dict()  # the constants are derived, never read from a checkpoint
    x = _image(4, (2, 32, 128, 3))
    ctrl = (TS.init_ctrl_points(20)[None] + 0.05 * np.random.RandomState(5).randn(2, 20, 2)).astype(np.float32)
    ref, ref_coord = JT.TPSSpatialTransformer((32, 100), 20, (0.05, 0.05))(jnp.asarray(x), jnp.asarray(ctrl))
    out, coord = tps(nchw(x), torch.from_numpy(ctrl))
    ref, ref_coord = np.asarray(ref), np.asarray(ref_coord)
    np.testing.assert_allclose(coord.numpy(), ref_coord, atol=ATOL, rtol=0)
    # the warp on the same coordinates: the sampler alone
    grid = torch.from_numpy(np.clip(ref_coord, 0, 1).reshape(2, 32, 100, 2) * 2 - 1)
    np.testing.assert_allclose(nhwc(TG.grid_sample(nchw(x), grid)), ref, atol=ATOL, rtol=0)
    # end to end: float32 coordinates carry ~4e-6 of rounding in either
    # package (JAX's against a float64 product here), which moves a sample
    # by that times the width in pixels; bilinear sampling changes by at most
    # the image's largest step between neighbours per pixel moved
    step = max(np.abs(np.diff(x, axis=1)).max(), np.abs(np.diff(x, axis=2)).max())
    moved = np.abs(coord.numpy() - ref_coord).max(axis=(0, 1)) @ np.array([128.0, 32.0])
    np.testing.assert_allclose(nhwc(out), ref, atol=ATOL + moved * step, rtol=0)


@pytest.mark.parametrize("variant, shape", [("psn", (2, 16, 64, 4)), ("recognizer", (2, 32, 64, 3))])
def test_stn_head_matches(variant, shape):
    x = _image(6, shape) * 2 - 1
    jm = JS.STNHead(num_ctrlpoints=20, activation="none", variant=variant)
    variables = init_variables(jm, 7, jnp.zeros((1,) + shape[1:]))
    ref_feat, ref_ctrl = jm.apply(variables, jnp.asarray(x))
    head = TS.STNHead(shape[-1], 20, variant)
    module_from_jax(head, variables)
    with torch.no_grad():
        feat, ctrl = head.eval()(nchw(x))
    assert tuple(ctrl.shape) == (2, 20, 2)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(ref_ctrl), atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(TS.init_ctrl_points(20), JS.init_ctrl_points(20))
