"""Kernel K5 on bf16 io (the bf16 AMP train step under "full"): the port's
plain version, the oracle of the card's bf16 kernel, against the JAX
package's window_attention_full_core in interpret mode on the same bf16
inputs (the 18 primals) and float32 biases, composed with build_packed_bias
under jax.vjp.  The 8x32 grid at dim 48 of
tests/test_torch_window_attention_train.py (6 heads, head dim 8, scale
8^-0.5; the ws=8 group clamped with shift 0), B = 2, both shift sets, the
faithful layout, keep = 1.

Both sides keep the TPU kernel's rounding points (K3's bf16 ones up to P v;
the tokens float32 and unrounded; SKConv in float32 on widened weights; the
output rounded once; in the backward the tokens' gradient rounded before
the attention backward, the weight gradients summed in float32 and rounded
once), so they differ by float32 summation order.  Limits: the output
within 2^-7 max|ref|, each of the 18 primal gradients and the bias
gradients within 2^-6 of its largest value, as for K3 on bf16 io."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_full as WF
from test_torch_window_attention_full import JAX_ORDER, _full_inputs, _torch_layout
from test_torch_window_attention_train import B, GRAD_NAMES, SHIFTS

GEOM = "8x32"
NAMES = GRAD_NAMES + ["proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ph_w", "ph_b"]


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(shift):
    d = _full_inputs(GEOM, shift)
    d["x"] = {k: _bf16(v) for k, v in d["x"].items()}
    d["biases"] = [_bf16(b) for b in d["biases"]]
    d["cot"] = _bf16(d["cot"])
    return d


@functools.lru_cache(maxsize=None)
def _jax(shift):
    d = _case(shift)
    x, (h, w) = d["x"], d["hw"]
    c = x["xq"].shape[-1]
    masks = [None if m is None else jnp.asarray(m) for m in d["masks"]]

    def f(*args):
        prim, biases = args[:18], args[18:]
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        return PWT.window_attention_full_core(
            prim[0].reshape(B, h, w, c), prim[1].reshape(B, h, w, c), *prim[2:], packed, jnp.zeros((1,), jnp.int32),
            tuple(d["win"]), tuple(d["shf"]), d["gh"], d["scale"], 1.0, (h, w), True).reshape(B, h * w, c)

    args = [jnp.asarray(x[k], jnp.bfloat16) for k in JAX_ORDER]
    out, vjp = jax.vjp(f, *args, *[jnp.asarray(b) for b in d["biases"]])
    grads = vjp(jnp.asarray(d["cot"], jnp.bfloat16))
    return out.dtype, np.asarray(out.astype(jnp.float32)), [g.dtype for g in grads], \
        [_torch_layout(i, np.asarray(g.astype(jnp.float32))) for i, g in enumerate(grads)]


def _port(d, fn, seed=0, keep=1.0):
    bf = torch.bfloat16
    prim = [torch.from_numpy(_torch_layout(i, d["x"][k])).to(bf).requires_grad_() for i, k in enumerate(JAX_ORDER)]
    biases = [torch.from_numpy(b).requires_grad_() for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    out = fn(*prim, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    grads = torch.autograd.grad(out, prim + biases, torch.from_numpy(d["cot"]).to(bf))
    return out.detach(), grads


@pytest.mark.parametrize("shift", SHIFTS)
def test_plain_bf16_matches_jax_kernel(shift):
    out, grads = _port(_case(shift), WF.window_attention_full_core_plain)
    ref_dtype, ref, ref_dtypes, ref_grads = _jax(shift)
    assert out.dtype == torch.bfloat16 and ref_dtype == jnp.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2.0**-7 * np.abs(ref).max(), err
    names = NAMES + [f"bias_{i}" for i in range(len(grads) - 18)]
    assert len(grads) == len(ref_grads) == 21
    for name, g, r, rdt in zip(names, grads, ref_grads, ref_dtypes):
        want = torch.float32 if name.startswith("bias") else torch.bfloat16
        assert g.dtype == want and rdt == (jnp.float32 if want == torch.float32 else jnp.bfloat16), name
        err = np.abs(g.float().numpy() - r).max()
        assert err <= 2.0**-6 * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_function_bf16_equals_plain(keep):
    """The autograd Function's CPU path on bf16 io is autograd through the
    plain version: equal bit for bit, with and without dropout; a CPU tensor
    launches nothing."""
    d = _case((1, 2, 4))
    before = (WF.forward_bf16_counter.launches, WF.backward_bf16_counter.launches)
    out, grads = _port(d, WF.window_attention_full_core, seed=5, keep=keep)
    assert (WF.forward_bf16_counter.launches, WF.backward_bf16_counter.launches) == before
    p_out, p_grads = _port(d, WF.window_attention_full_core_plain, seed=5, keep=keep)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_plain_bf16_is_not_k3_then_bf16_skconv():
    """The tokens stay float32 before SKConv: rounding them (K3's bf16 plain
    version, then SKConv on bf16 values) gives another output."""
    d = _case((0, 0, 0))
    out, _ = _port(d, WF.window_attention_full_core_plain)
    rounded, _ = _port(d, lambda *a: _k3_then_skconv(*a))
    assert not torch.equal(out, rounded)


def _k3_then_skconv(*args):
    from dpmn_tpu_torch.ops.window_attention import skconv
    from dpmn_tpu_torch.ops.window_attention_train import window_attention_block_core_plain
    prim, tail = args[:18], args[18:]
    tokens = window_attention_block_core_plain(*prim[:10], *tail)
    return skconv(tokens.float(), *(t.float() for t in prim[10:]), 3).to(torch.bfloat16)
