"""The port's GRU scan (plain version of the CUDA kernel) and BiGRU against the
JAX package: pallas_gru_scan in interpret mode and gru._gru_scan, forward and
reverse; tolerance rtol=1e-5, atol=1e-6 as in tests/test_pallas_kernels.py.
The port takes w_hh in torch's (3H, H) layout, the JAX package (H, 3H)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops.gru import BiGRU as JBiGRU
from dpmn_tpu.ops.gru import _gru_scan
from dpmn_tpu.ops.pallas_kernels import pallas_gru_scan
from dpmn_tpu_torch.ops.gru import BiGRU, gru_scan, gru_scan_counter, gru_scan_plain
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables


@pytest.mark.parametrize("n,t,h", [(12, 7, 8), (10, 16, 32)])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_pallas_and_lax(n, t, h, reverse):
    rng = np.random.RandomState(n + t)
    x_proj = (rng.randn(n, t, 3 * h) * 0.3).astype(np.float32)
    w_hh = (rng.randn(h, 3 * h) * 0.3).astype(np.float32)
    b_hh = (rng.randn(3 * h) * 0.1).astype(np.float32)
    ref_lax = np.asarray(_gru_scan(jnp.asarray(x_proj), jnp.asarray(w_hh), jnp.asarray(b_hh), reverse=reverse))
    ref_pallas = np.asarray(pallas_gru_scan(jnp.asarray(x_proj), jnp.asarray(w_hh), jnp.asarray(b_hh),
                                            reverse=reverse, tile_n=8, interpret=True))
    args = (torch.from_numpy(x_proj), torch.from_numpy(np.ascontiguousarray(w_hh.T)), torch.from_numpy(b_hh))
    before = gru_scan_counter.launches
    out = gru_scan(*args, reverse)
    assert gru_scan_counter.launches == before  # CPU tensors run the plain version
    assert torch.equal(out, gru_scan_plain(*args, reverse))
    np.testing.assert_allclose(out.numpy(), ref_pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), ref_lax, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("features", [12, 64])
def test_bigru_matches_module(features):
    rng = np.random.RandomState(features)
    x = (rng.randn(4, 9, 10) * 0.5).astype(np.float32)
    module = JBiGRU(features=features)
    variables = init_variables(module, 1, jnp.asarray(x))
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = BiGRU(10, features // 2)
    module_from_jax(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_bigru_broadcast_steps():
    """`steps`: one input projected once and repeated along time equals the
    repeated input (the faithful gru_encoding)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 1, 10).astype(np.float32))
    module = JBiGRU(features=8)
    variables = init_variables(module, 3, jnp.zeros((3, 5, 10)))
    port = BiGRU(10, 4)
    module_from_jax(port, variables)
    ref = np.asarray(module.apply(variables, jnp.broadcast_to(jnp.asarray(x.numpy()), (3, 5, 10))))
    with torch.no_grad():
        out = port(x, steps=5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
