"""The port's GRU scan (plain versions of the CUDA kernel, one direction and
both) and BiGRU against the JAX package: pallas_gru_scan and pallas_bigru in
interpret mode, gru._gru_scan and the fused bidirectional scan, forward and
reverse; tolerance rtol=1e-5, atol=1e-6 as in tests/test_pallas_kernels.py.
The port takes w_hh in torch's (3H, H) layout, the JAX package (H, 3H)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import gru as jgru
from dpmn_tpu.ops.gru import BiGRU as JBiGRU
from dpmn_tpu.ops.gru import _gru_scan
from dpmn_tpu.ops.pallas_kernels import pallas_bigru, pallas_gru_scan
from dpmn_tpu_torch.ops.gru import (
    BiGRU,
    gru_bidir,
    gru_bidir_counter,
    gru_bidir_plain,
    gru_scan,
    gru_scan_counter,
    gru_scan_plain,
)
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


def _bigru_params(rng, in_dim, h):
    """A BiGRU param dict in the JAX package's layout (w_* (in, 3H))."""
    shapes = {"w_ih": (in_dim, 3 * h), "w_hh": (h, 3 * h), "b_ih": (3 * h,), "b_hh": (3 * h,)}
    return {f"{k}_{tag}": (rng.randn(*shape) * 0.3).astype(np.float32)
            for tag in ("fw", "bw") for k, shape in shapes.items()}


def _port_bidir_args(x, params):
    """gru_bidir's arguments from a JAX-layout param dict: the projections
    of x and the recurrent weights in torch's layout."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()}
    xt = torch.from_numpy(x)
    xps = [xt @ t[f"w_ih_{tag}"] + t[f"b_ih_{tag}"] for tag in ("fw", "bw")]
    return (*xps, t["w_hh_fw"].T.contiguous(), t["w_hh_bw"].T.contiguous(), t["b_hh_fw"], t["b_hh_bw"])


@pytest.mark.parametrize("n,t,h", [(6, 7, 8), (10, 16, 32)])
def test_bidir_matches_pallas_bigru(n, t, h):
    """Both directions against pallas_bigru in interpret mode; on CPU
    tensors gru_bidir is its plain version and launches nothing."""
    rng = np.random.RandomState(n * t)
    x = (rng.randn(n, t, 5) * 0.5).astype(np.float32)
    params = _bigru_params(rng, 5, h)
    ref = np.asarray(pallas_bigru(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, tile_n=8,
                                  interpret=True))
    args = _port_bidir_args(x, params)
    before = (gru_bidir_counter.launches, gru_scan_counter.launches)
    out = gru_bidir(*args)
    assert (gru_bidir_counter.launches, gru_scan_counter.launches) == before
    assert out.shape == (n, t, 2 * h)
    assert torch.equal(out, gru_bidir_plain(*args))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("features", [12, 64])
def test_bidir_matches_fused_bidir_scan(monkeypatch, features):
    """gru_bidir_plain and the port's BiGRU against the JAX package's fused
    bidirectional lax.scan (USE_FUSED_BIDIR)."""
    monkeypatch.setattr(jgru, "USE_FUSED_BIDIR", True)
    monkeypatch.setattr(jgru, "USE_PALLAS_GRU", False)
    rng = np.random.RandomState(features + 1)
    x = (rng.randn(3, 8, 10) * 0.5).astype(np.float32)
    module = JBiGRU(features=features)
    variables = init_variables(module, 4, jnp.asarray(x))
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    params = {k: np.asarray(v) for k, v in variables["params"].items()}
    np.testing.assert_allclose(gru_bidir_plain(*_port_bidir_args(x, params)).numpy(), ref, rtol=1e-5, atol=1e-6)
    port = BiGRU(10, features // 2)
    module_from_jax(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_bigru_steps_time_stride_zero():
    """`steps` passes the projection broadcast along time (stride 0) and
    equals the input repeated along time, in both directions; the plain
    scan reads a stride-0 input as its contiguous copy."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 1, 10).astype(np.float32))
    port = BiGRU(10, 6)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.4, 0.4, p.shape).astype(np.float32)))
        out = port(x, steps=7)
        ref = port(x.expand(-1, 7, -1).contiguous())
        assert out.shape == (4, 7, 12)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        xp = [torch.matmul(x, getattr(port, f"weight_ih_{s}").T) + getattr(port, f"bias_ih_{s}")
              for s in ("l0", "l0_reverse")]
        weights = (port.weight_hh_l0, port.weight_hh_l0_reverse, port.bias_hh_l0, port.bias_hh_l0_reverse)
        wide = [v.expand(-1, 7, -1) for v in xp]
        assert wide[0].stride(1) == 0
        assert torch.equal(gru_bidir(*wide, *weights), gru_bidir(*[v.contiguous() for v in wide], *weights))
        assert torch.equal(out, gru_bidir(*wide, *weights))


def test_cpu_tensors_launch_nothing():
    """On CPU tensors neither entry point nor BiGRU counts a launch."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 4, 10).astype(np.float32))
    port = BiGRU(10, 8)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)))
        before = (gru_bidir_counter.launches, gru_scan_counter.launches)
        port(x)
        port(x[:, :1], steps=4)
        xp = torch.randn(3, 4, 24)
        gru_scan(xp, port.weight_hh_l0, port.bias_hh_l0, True)
        gru_bidir(xp, xp, port.weight_hh_l0, port.weight_hh_l0_reverse, port.bias_hh_l0, port.bias_hh_l0_reverse)
    assert (gru_bidir_counter.launches, gru_scan_counter.launches) == before
