"""The premise of the bf16 backwards of the training cores K3 and K5 on the
card: a product of two bf16 values is exact in float32, and a bf16 value is
exact in TF32.  So one bf16 tensor-core pass with float32 accumulation
(mma.sync m16n8k16) computes what the earlier three TF32 passes computed on
the widened values, up to the order of the float32 sums.  The port's plain
bf16 backward of K3, whose products all take bf16 operands, therefore gives
the same gradients when each of its products is evaluated in float64 from
the same rounded operands, to float32 summation error."""

import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
from dpmn_tpu_torch.ops import window_attention_train as WT
from dpmn_tpu_torch.system import init_weights

BF16_BITS = st.integers(0, 0xFFFF)
F32_TINY, F32_MAX = np.float64(2.0**-126), np.float64(np.finfo(np.float32).max)


@pytest.fixture(autouse=True)
def _no_stub_modules(monkeypatch):
    """Hypothesis reads every loaded module's `__file__`; the reference-tree
    tests' stub modules (tests/reference_bridge.py), when they share this
    worker, answer any attribute with a class.  Hide them from sys.modules
    for the test."""
    for name, mod in list(sys.modules.items()):
        if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
            monkeypatch.delitem(sys.modules, name)


def _bf16(bits: int) -> np.float32:
    """The float32 value of a bf16 bit pattern (its 16 high bits)."""
    return np.array([bits << 16], np.uint32).view(np.float32)[0]


@settings(max_examples=3000, deadline=None)
@given(BF16_BITS, BF16_BITS)
def test_bf16_products_are_exact_in_float32(a_bits, b_bits):
    """8-bit significands give a product of at most 16 bits, within float32's
    24, wherever the product is a normal float32."""
    a, b = _bf16(a_bits), _bf16(b_bits)
    exact = np.float64(a) * np.float64(b)
    if not np.isfinite(exact) or abs(exact) > F32_MAX or 0 < abs(exact) < F32_TINY:
        return  # outside float32's normal range: overflow or a subnormal result
    with np.errstate(all="ignore"):
        assert np.float64(np.float32(a) * np.float32(b)) == exact


@settings(max_examples=3000, deadline=None)
@given(BF16_BITS)
def test_bf16_values_are_exact_in_tf32(bits):
    """TF32 keeps 10 significand bits, bf16 7: rounding a bf16 value to TF32
    (round to nearest, the kernels' split_tf32_fast and cvt.rna alike) gives
    it back, and the split's low part is zero."""
    x = np.array([bits << 16], np.uint32)
    if not np.isfinite(x.view(np.float32)[0]):
        return
    hi = (x + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    assert hi[0] == x[0]
    assert x.view(np.float32)[0] - hi.view(np.float32)[0] == 0.0


def test_split_tf32_fast_of_every_bf16_value():
    """split_tf32_fast (csrc/tc_common.cuh) on each of the 65,536 bf16 bit
    patterns widened to float32: for every finite value hi is the value
    itself and lo = x - hi is +0 (all bits clear).  So SKConv's pass of a's
    high part times the low part of a bf16 weight adds exact zeros, and its
    two remaining passes (mma_2xtf32) give the three passes' sums, up to the
    sign of a zero sum."""
    x = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    f = x.view(np.float32)
    finite = np.isfinite(f)
    hi = (x + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    lo = (f - hi.view(np.float32)).view(np.uint32)
    assert finite.sum() == (1 << 16) - 2 * 128  # exponent all ones: 2 signs x 128 significands
    assert np.array_equal(hi[finite], x[finite])
    assert not lo[finite].any()


class _MatmulF64(torch.autograd.Function):
    """a @ b evaluated in float64 and rounded to float32 once, forward and
    backward: the exact products' sums, without float32's summation error."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(a.double(), b.double()).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.matmul(g.double(), b.double().transpose(-1, -2)).float()
        gb = torch.matmul(a.double().transpose(-1, -2), g.double()).float()
        return ga.sum_to_size(a.shape), gb.sum_to_size(b.shape)


def _k3_bf16_grads(dim=16, windows=(2, 4), heads=2, shifts=(0, 1), hw=(8, 8), seed=0):
    """The plain bf16 K3 on one tiny block (keep 0.9), its output and the
    gradients of its 10 bf16 primals and its float32 biases."""
    gen = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(dim, hw, heads, list(windows), list(shifts))
    init_weights(blk, seed=seed + 1)
    a = blk.attn
    bf = lambda t: t.detach().bfloat16().requires_grad_()
    rnd = lambda *s: 0.1 * torch.randn(*s, generator=gen)
    l = hw[0] * hw[1]
    prim = [bf(torch.randn(1, l, dim, generator=gen)), bf(torch.randn(1, l, dim, generator=gen)),
            bf(1 + rnd(dim)), bf(rnd(dim)), bf(1 + rnd(dim)), bf(rnd(dim)), bf(a.q.weight), bf(rnd(dim)),
            bf(a.kv.weight), bf(rnd(2 * dim))]
    biases = [rnd(*b.shape).requires_grad_() for b in a.biases()]
    cot = torch.randn(1, l, dim, generator=gen).bfloat16()
    out = WT.window_attention_block_core_plain(*prim, biases, a.masks(), 7, 0.9, a.win, a.shf, a.gnum_heads,
                                               a.scale, a.hw)
    return out, torch.autograd.grad(out, prim + biases, cot)


def test_k3_bf16_plain_backward_products_are_exact(monkeypatch):
    """Every product of the plain bf16 K3 (the projections, q k^T, P v and
    their gradients: operands rounded to bf16 at the kernel's rounding
    points) evaluated in float64 from the same operands: the output and
    every gradient agree with the float32 evaluation within float32
    summation error of their largest value (K-term sums, K <= 48 here:
    about 48 x 2^-24 relative), far inside one bf16 step (2^-8)."""
    out32, grads32 = _k3_bf16_grads()
    calls = []
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: calls.append(1) or _MatmulF64.apply(a, b))
    out64, grads64 = _k3_bf16_grads()
    assert len(calls) == 2 + 2 * 2  # the two projections, q k^T and P v of each of the two groups
    assert out64.dtype == out32.dtype == torch.bfloat16
    tol = 64 * 2.0**-24
    assert (out64.float() - out32.float()).abs().max() <= tol * out32.float().abs().max()
    for g32, g64 in zip(grads32, grads64):
        scale = g32.float().abs().max().item()
        assert scale > 0
        assert (g64.float() - g32.float()).abs().max().item() <= tol * scale
