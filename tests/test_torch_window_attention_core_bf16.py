"""Kernel K4 on bf16 io (the bf16 AMP train step under "attention"): the
port's plain version, the oracle of the card's bf16 kernel, against the JAX
package's window_attention_core in interpret mode on the same bf16 q, k, v
and float32 biases (as dpmn_tpu/models/pgrm.py:488-490 passes them),
composed with build_packed_bias under jax.vjp.  The 8x32 grid at dim 48 of
tests/test_torch_window_attention_train.py (6 heads, head dim 8, so the
scale 8^-0.5 is not a power of two; the ws=8 group clamped with shift 0),
B = 2, both shift sets, keep = 1.

Both sides keep the TPU kernel's rounding points (q * bf16(scale) and P
rounded, the output once; P*M and dS rounded before their products, dq /
dk / dv at the store), so they differ by float32 summation order, which can
put a value on either side of a bf16 rounding boundary.  Limits: the output
within 2^-7 max|ref| (one bf16 step of the largest value), each gradient
within 2^-6 of its largest value (a flipped rounding of dS moves a row of dq
or dk by one bf16 step of its largest term).

Also here, bit for bit: the stage the three bf16 cores share, q times the
scale (`scale_q`), against JAX's `q_bf16 * scale` (the scale rounded to bf16
as a weakly typed Python float), and its gradient, g times the float32
scale."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_core as WC
from dpmn_tpu_torch.ops import window_attention_train as WT
from test_torch_window_attention_core import _qkv_inputs
from test_torch_window_attention_train import B, SHIFTS

GEOM = "8x32"


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(shift):
    """K4's case with q, k, v and the cotangent rounded to bf16; the biases
    float32 with bf16 values (a bf16 table cast up)."""
    d = _qkv_inputs(GEOM, shift)
    d["qkv"] = [_bf16(t) for t in d["qkv"]]
    d["biases"] = [_bf16(b) for b in d["biases"]]
    d["cot"] = _bf16(d["cot"])
    return d


@functools.lru_cache(maxsize=None)
def _jax(shift):
    d = _case(shift)
    h, w = d["hw"]
    c = d["qkv"][0].shape[-1]
    masks = [None if m is None else jnp.asarray(m) for m in d["masks"]]

    def f(q, k, v, *biases):
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        out = PWT.window_attention_core(*(t.reshape(B, h, w, c) for t in (q, k, v)), packed,
                                        jnp.zeros((1,), jnp.int32), tuple(d["win"]), tuple(d["shf"]), d["gh"],
                                        d["scale"], 1.0, True)
        return out.reshape(B, h * w, c)

    args = [jnp.asarray(t, jnp.bfloat16) for t in d["qkv"]]
    out, vjp = jax.vjp(f, *args, *[jnp.asarray(b) for b in d["biases"]])
    grads = vjp(jnp.asarray(d["cot"], jnp.bfloat16))
    return out.dtype, np.asarray(out.astype(jnp.float32)), [g.dtype for g in grads], \
        [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(d, fn, seed=0, keep=1.0, kv_views=False):
    """fn on the case in bf16; with kv_views, k and v as the halves of one
    (B, L, 2D) tensor, as the "attention" core hands them over."""
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(t).to(bf).requires_grad_() for t in d["qkv"])
    leaves = [q, k, v]
    if kv_views:
        kv = torch.cat([k, v], dim=-1).detach().requires_grad_()
        leaves = [q, kv]
        k, v = kv[..., :k.shape[-1]], kv[..., k.shape[-1]:]
    biases = [torch.from_numpy(b).requires_grad_() for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    out = fn(q, k, v, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    grads = torch.autograd.grad(out, leaves + biases, torch.from_numpy(d["cot"]).to(bf))
    return out.detach(), grads


@pytest.mark.parametrize("shift", SHIFTS)
def test_plain_bf16_matches_jax_kernel(shift):
    out, grads = _port(_case(shift), WC.window_attention_core_plain)
    ref_dtype, ref, ref_dtypes, ref_grads = _jax(shift)
    assert out.dtype == torch.bfloat16 and ref_dtype == jnp.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2.0**-7 * np.abs(ref).max(), err
    names = ["dq", "dk", "dv"] + [f"bias_{i}" for i in range(len(grads) - 3)]
    assert len(grads) == len(ref_grads) == 6
    for name, g, r, rdt in zip(names, grads, ref_grads, ref_dtypes):
        want = torch.float32 if name.startswith("bias") else torch.bfloat16
        assert g.dtype == want and rdt == (jnp.float32 if want == torch.float32 else jnp.bfloat16), name
        err = np.abs(g.float().numpy() - r).max()
        assert err <= 2.0**-6 * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_function_bf16_equals_plain(keep):
    """The autograd Function's CPU path on bf16 io, k and v as views of one kv
    tensor, is autograd through the plain version on contiguous k and v:
    equal bit for bit, with and without dropout; a CPU tensor launches
    nothing."""
    d = _case((1, 2, 4))
    before = (WC.forward_bf16_counter.launches, WC.backward_bf16_counter.launches)
    out, grads = _port(d, WC.window_attention_core, seed=5, keep=keep, kv_views=True)
    assert (WC.forward_bf16_counter.launches, WC.backward_bf16_counter.launches) == before
    p_out, p_grads = _port(d, WC.window_attention_core_plain, seed=5, keep=keep)
    assert torch.equal(out, p_out)
    dkv = torch.cat([p_grads[1], p_grads[2]], dim=-1)
    for a, b in zip(grads, [p_grads[0], dkv, *p_grads[3:]]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mixed_dtypes_raise():
    """q, k, v of one dtype, float32 biases with bf16 ones; nothing is cast."""
    d = _case((0, 0, 0))
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in d["qkv"])
    biases = [torch.from_numpy(b) for b in d["biases"]]
    tail = (d["masks"], 0, 1.0, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    with pytest.raises(TypeError, match="mixed primal dtypes"):
        WC.window_attention_core(q, k.float(), v, biases, *tail)
    with pytest.raises(TypeError, match="take torch.float32 biases"):
        WC.window_attention_core(q, k, v, [b.to(torch.bfloat16) for b in biases], *tail)


@pytest.mark.parametrize("scale", [8**-0.5, 12**-0.5, 0.25])
def test_scaled_q_bit_exact(scale):
    """`scale_q` on bf16 values equals JAX's bf16 q * scale bit for bit, and
    its gradient is g * float32(scale), as the kernels' dq = (dS K) * scale."""
    rng = np.random.RandomState(3)
    q = _bf16(rng.randn(4096) * 2.0)
    ref = np.asarray((jnp.asarray(q, jnp.bfloat16) * scale).astype(jnp.float32))
    t = torch.from_numpy(q).requires_grad_()
    got = WT.scale_q(t, scale)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    g = np.asarray(rng.randn(4096), np.float32)
    (gq,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_array_equal(gq.numpy(), g * np.float32(scale))
