"""The port's training attention core on projected q, k, v (kernel K4's plain
version and its autograd Function) against the JAX package's
window_attention_core in interpret mode, composed with build_packed_bias
under jax.vjp so the bias gradient arrives per group as (heads, N, N) on
both sides.

Geometries: the flagship 16x64 grid at dim 96 with 6 heads, and the 8x32 grid
at dim 48 of tests/test_pallas_train.py (head dim 8, the ws=8 group clamped
to the grid with shift 0); B = 2, both shift sets, keep = 1.  Tolerances are
the JAX package's own for this kernel (tests/test_pallas_train.py:264-273):
output rtol = atol = 2e-5, dq, dk, dv and dbias rtol = atol = 5e-4.  With
dropout on, the Function equals autograd through the plain version, and K4
draws K3's mask for the same seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_core as WC
from dpmn_tpu_torch.ops import window_attention_train as WT
from dpmn_tpu_torch.ops.window_attention import layer_norm
from test_torch_window_attention_train import B, GEOMETRIES, SHIFTS, _case_inputs


def _qkv_inputs(geom, shift, seed=5):
    """K3's case (weights, biases, masks, cotangent) plus q, k, v drawn on
    their own at the scale of projected tokens."""
    d = _case_inputs(geom, shift, seed)
    rng = np.random.RandomState(seed + 100)
    shape = d["x"]["xq"].shape
    d["qkv"] = [np.asarray(rng.randn(*shape) * 0.5, np.float32) for _ in range(3)]
    return d


@functools.lru_cache(maxsize=None)
def _jax_case(geom, shift):
    """JAX output and gradients (dq, dk, dv, per-group dbias) of one case, computed once."""
    d = _qkv_inputs(geom, shift)
    h, w = d["hw"]
    c = d["qkv"][0].shape[-1]
    masks = [None if m is None else jnp.asarray(m) for m in d["masks"]]

    def f(q, k, v, *biases):
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        out = PWT.window_attention_core(*(t.reshape(B, h, w, c) for t in (q, k, v)), packed,
                                        jnp.zeros((1,), jnp.int32), tuple(d["win"]), tuple(d["shf"]), d["gh"],
                                        d["scale"], 1.0, True)
        return out.reshape(B, h * w, c)

    out, vjp = jax.vjp(f, *[jnp.asarray(t) for t in d["qkv"]], *[jnp.asarray(b) for b in d["biases"]])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(d["cot"]))]


def _run(d, fn, seed=0, keep=1.0):
    leaves = [torch.from_numpy(a).requires_grad_() for a in d["qkv"]]
    biases = [torch.from_numpy(b).requires_grad_() for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    out = fn(*leaves, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    grads = torch.autograd.grad(out, leaves + biases, torch.from_numpy(d["cot"]))
    return out.detach(), [g.numpy() for g in grads]


def _check_against_jax(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    assert len(grads) == len(ref_grads) == 6
    for name, a, b in zip(["dq", "dk", "dv", "dbias_0", "dbias_1", "dbias_2"], grads, ref_grads):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4, err_msg=name)


CASES = [(g, s) for g in GEOMETRIES for s in SHIFTS]


@pytest.mark.parametrize("geom,shift", CASES)
def test_plain_matches_jax_kernel(geom, shift):
    d = _qkv_inputs(geom, shift)
    _check_against_jax(*_run(d, WC.window_attention_core_plain), *_jax_case(geom, shift))


@pytest.mark.parametrize("geom,shift", CASES)
def test_function_matches_jax_kernel_and_plain(geom, shift):
    """The Function's CPU path against JAX, and exactly equal to autograd
    through the plain version; a CPU tensor never launches a kernel."""
    d = _qkv_inputs(geom, shift)
    before = (WC.forward_counter.launches, WC.backward_counter.launches)
    out, grads = _run(d, WC.window_attention_core)
    assert (WC.forward_counter.launches, WC.backward_counter.launches) == before
    _check_against_jax(out, grads, *_jax_case(geom, shift))
    p_out, p_grads = _run(d, WC.window_attention_core_plain)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift", SHIFTS)
def test_function_with_dropout_matches_plain_and_k3(shift):
    """keep = 0.9: the Function's forward and gradients equal autograd through
    the plain version with the same seed, another seed differs; and on the
    q, k, v that K3's LN + projections make, K4 gives K3's output mask for
    mask."""
    d = _qkv_inputs("8x32", shift, seed=9)
    out, grads = _run(d, WC.window_attention_core, seed=77, keep=0.9)
    p_out, p_grads = _run(d, WC.window_attention_core_plain, seed=77, keep=0.9)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)
    other, _ = _run(d, WC.window_attention_core_plain, seed=78, keep=0.9)
    no_drop, _ = _run(d, WC.window_attention_core_plain)
    assert not torch.allclose(out, other) and not torch.allclose(out, no_drop)

    x = {k: torch.from_numpy(v) for k, v in d["x"].items()}
    dim = x["xq"].shape[-1]
    q = layer_norm(x["xq"], x["qs"], x["qb"]) @ x["wq"] + x["bq"]
    kv = layer_norm(x["xkv"], x["ks"], x["kb"]) @ x["wkv"] + x["bkv"]
    biases = [torch.from_numpy(b) for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    static = (d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    k4 = WC.window_attention_core(q, kv[..., :dim].contiguous(), kv[..., dim:].contiguous(), biases, masks, 77, 0.9,
                                  *static)
    k3 = WT.window_attention_block_core(x["xq"], x["xkv"], x["qs"], x["qb"], x["ks"], x["kb"], x["wq"].T, x["bq"],
                                        x["wkv"].T, x["bkv"], biases, masks, 77, 0.9, *static)
    torch.testing.assert_close(k4, k3, rtol=1e-6, atol=1e-6)


def test_keep_outside_the_unit_interval_raises():
    d = _qkv_inputs("8x32", (1, 2, 4))
    with pytest.raises(ValueError):
        _run(d, WC.window_attention_core, keep=0.0)
