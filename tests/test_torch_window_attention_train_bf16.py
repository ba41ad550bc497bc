"""Kernel K3 on bf16 io (the bf16 AMP train step): the port's plain version,
the oracle of the card's bf16 kernel, against the JAX package's
window_attention_block_core in interpret mode on the same bf16 inputs and
float32 biases (as dpmn_tpu/models/pgrm.py:405-407 passes them), composed
with build_packed_bias under jax.vjp.  The 8x32 grid at dim 48 of
tests/test_torch_window_attention_train.py (6 heads, head dim 8, the ws=8
group clamped with shift 0), B = 2, both shift sets, faithful layout,
keep = 1.

Both sides keep the TPU kernel's rounding points (LN, q / kv, q * scale, P
and the output rounded to bf16; P*M, dS and dq / dkv rounded before their
products), so they differ by float32 summation order, which can put a value
on either side of a bf16 rounding boundary.  Limits: the output within
2^-7 max|ref| (one bf16 step of the largest value); each gradient within
2^-6 of its largest value, since a flipped rounding of dq / dkv before the
projection backward moves a whole row of the weight gradient by one bf16
step of that row's largest term."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_train as WT
from test_torch_window_attention_train import B, GRAD_NAMES, SHIFTS, _case_inputs

GEOM = "8x32"


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(shift):
    """_case_inputs with every primal and the cotangent rounded to bf16; the
    biases stay float32 with bf16 values (a bf16 table cast up)."""
    d = _case_inputs(GEOM, shift)
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

    def f(xq, xkv, qs, qb, ks, kb, wq, bq, wkv, bkv, *biases):
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        out = PWT.window_attention_block_core(
            xq.reshape(B, h, w, c), xkv.reshape(B, h, w, c), qs, qb, ks, kb, wq, bq, wkv, bkv, packed,
            jnp.zeros((1,), jnp.int32), tuple(d["win"]), tuple(d["shf"]), d["gh"], d["scale"], 1.0, (h, w), True)
        return out.reshape(B, h * w, -1)

    args = [jnp.asarray(x[k], jnp.bfloat16) for k in ("xq", "xkv", "qs", "qb", "ks", "kb", "wq", "bq", "wkv", "bkv")]
    out, vjp = jax.vjp(f, *args, *[jnp.asarray(b) for b in d["biases"]])
    grads = vjp(jnp.asarray(d["cot"], jnp.bfloat16))
    dtypes = [g.dtype for g in grads]
    g = [np.asarray(t.astype(jnp.float32)) for t in grads]
    g[6], g[8] = g[6].T, g[8].T  # flax kernels (in, out) -> torch (out, in)
    return out.dtype, np.asarray(out.astype(jnp.float32)), dtypes, g


def _port(d, fn, seed=0, keep=1.0):
    x = d["x"]
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).requires_grad_()
    bf = torch.bfloat16
    prim = [t(x[k], bf) for k in ("xq", "xkv", "qs", "qb", "ks", "kb")]
    prim += [t(x["wq"].T, bf), t(x["bq"], bf), t(x["wkv"].T, bf), t(x["bkv"], bf)]
    biases = [t(b, torch.float32) for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    out = fn(*prim, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    grads = torch.autograd.grad(out, prim + biases, torch.from_numpy(d["cot"]).to(bf))
    return out.detach(), grads


@pytest.mark.parametrize("shift", SHIFTS)
def test_plain_bf16_matches_jax_kernel(shift):
    out, grads = _port(_case(shift), WT.window_attention_block_core_plain)
    ref_dtype, ref, ref_dtypes, ref_grads = _jax(shift)
    assert out.dtype == torch.bfloat16 and ref_dtype == jnp.bfloat16
    err = (out.float().numpy() - ref).__abs__().max()
    assert err <= 2.0**-7 * np.abs(ref).max(), err
    names = GRAD_NAMES + [f"bias_{i}" for i in range(len(grads) - 10)]
    assert len(grads) == len(ref_grads) == 13
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
    before = (WT.forward_bf16_counter.launches, WT.backward_bf16_counter.launches)
    out, grads = _port(d, WT.window_attention_block_core, seed=5, keep=keep)
    assert (WT.forward_bf16_counter.launches, WT.backward_bf16_counter.launches) == before
    p_out, p_grads = _port(d, WT.window_attention_block_core_plain, seed=5, keep=keep)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mixed_dtypes_raise():
    """All-float32 or all-bf16 primals, float32 biases with bf16 ones; the
    wrapper casts nothing."""
    d = _case((0, 0, 0))
    x = d["x"]
    bf = torch.bfloat16
    prim = [torch.from_numpy(x[k]).to(bf) for k in ("xq", "xkv", "qs", "qb", "ks", "kb")]
    prim += [torch.from_numpy(np.ascontiguousarray(x["wq"].T)).to(bf), torch.from_numpy(x["bq"]).to(bf),
             torch.from_numpy(np.ascontiguousarray(x["wkv"].T)).to(bf), torch.from_numpy(x["bkv"]).to(bf)]
    biases = [torch.from_numpy(b) for b in d["biases"]]
    tail = (d["masks"], 0, 1.0, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    mixed = list(prim)
    mixed[6] = mixed[6].float()
    with pytest.raises(TypeError, match="mixed primal dtypes"):
        WT.window_attention_block_core(*mixed, biases, *tail)
    with pytest.raises(TypeError, match="take torch.float32 biases"):
        WT.window_attention_block_core(*prim, [b.to(bf) for b in biases], *tail)
    with pytest.raises(TypeError, match="take torch.float32 biases"):
        WT.window_attention_block_core_plain(*[p.float() for p in prim], [b.double() for b in biases], *tail)
