"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch sees no card.  On the machine with
the card (which has no JAX, so the repository's conftest is skipped):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock
from dpmn_tpu_torch.ops import window_attention_train as WT
from dpmn_tpu_torch.ops.gru import gru_scan, gru_scan_counter, gru_scan_plain
from dpmn_tpu_torch.ops.window_attention import (
    window_attention_block,
    window_attention_block_plain,
    window_attention_counter,
)
from dpmn_tpu_torch.system import init_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("with_ln", [True, False])
def test_window_attention_kernel(dev, shift, faithful, with_ln):
    gen = torch.Generator().manual_seed(0)
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], list(shift), faithful=faithful)
    init_weights(blk, seed=1)
    with torch.no_grad():
        for i in range(3):
            getattr(blk.attn, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
    blk = blk.to(dev)
    kw = blk.attn.block_args(blk.ln_params() if with_ln else None)
    xq = torch.randn(2, 1024, 96, generator=gen).to(dev)
    xkv = torch.randn(2, 1024, 96, generator=gen).to(dev)
    before = window_attention_counter.launches
    with torch.no_grad():
        out = window_attention_block(xq, xkv, **kw)
        ref = window_attention_block_plain(xq, xkv, **kw)
    torch.cuda.synchronize()
    assert window_attention_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,t,h", [(300, 16, 32), (40, 9, 64), (64, 5, 128), (600, 3, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_kernel(dev, n, t, h, reverse):
    gen = torch.Generator().manual_seed(n)
    x_proj = (0.5 * torch.randn(n, t, 3 * h, generator=gen)).to(dev)
    w_hh = ((torch.rand(3 * h, h, generator=gen) * 2 - 1) / h**0.5).to(dev)
    b_hh = ((torch.rand(3 * h, generator=gen) * 2 - 1) / h**0.5).to(dev)
    before = gru_scan_counter.launches
    out = gru_scan(x_proj, w_hh, b_hh, reverse)
    ref = gru_scan_plain(x_proj, w_hh, b_hh, reverse)
    torch.cuda.synchronize()
    assert gru_scan_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 6, 96, device=dev)
    w = torch.randn(96, 32, device=dev)
    b = torch.randn(96, device=dev)
    with pytest.raises(ValueError):
        gru_scan(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        gru_scan(x, w.T.contiguous().T, b)  # not contiguous
    with pytest.raises(ValueError):
        gru_scan(torch.randn(4, 6, 30, device=dev), torch.randn(30, 10, device=dev), torch.randn(30, device=dev))
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], [0, 0, 0]).to(dev)
    kw = blk.attn.block_args(blk.ln_params())
    with pytest.raises(ValueError):
        window_attention_block(torch.randn(2, 1000, 96, device=dev), torch.randn(2, 1000, 96, device=dev), **kw)
    x = torch.randn(2, 1024, 96, device=dev)
    for heads in (3, 12):  # head dims 32 and 8
        blk = SwinTransformerBlock(96, (16, 64), heads, [2, 4, 8], [0, 0, 0]).to(dev)
        with pytest.raises(ValueError):
            window_attention_block(x, x, **blk.attn.block_args(blk.ln_params()))


def train_core_inputs(dev, shift, batch=2, seed=0):
    """Random pre-norm tokens, LN, projection and relative-bias parameters of
    one flagship block (16x64 grid, dim 96, windows 2/4/8, 6 heads), leaves
    that require grad, and the core's static arguments."""
    gen = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], list(shift))
    init_weights(blk, seed=seed + 1)
    leaf = lambda t: t.detach().clone().to(dev).requires_grad_()
    rnd = lambda *s, scale=1.0: leaf(scale * torch.randn(*s, generator=gen))
    a = blk.attn
    prim = [rnd(batch, 1024, 96), rnd(batch, 1024, 96),
            leaf(1 + 0.1 * torch.randn(96, generator=gen)), rnd(96, scale=0.1),
            leaf(1 + 0.1 * torch.randn(96, generator=gen)), rnd(96, scale=0.1),
            leaf(a.q.weight), rnd(96, scale=0.1), leaf(a.kv.weight), rnd(192, scale=0.1)]
    biases = [rnd(*b.shape, scale=0.1) for b in a.biases()]
    masks = [getattr(a, f"shift_mask_{i}").to(dev) if sh > 0 else None for i, sh in enumerate(a.shf)]
    return prim, biases, dict(masks=masks, window_sizes=a.win, shifts=a.shf, gnum_heads=a.gnum_heads,
                              scale=a.scale, hw_shape=a.hw)


def run_train_core(fn, prim, biases, static, seed, keep, layout, cot):
    out = fn(*prim, biases, static["masks"], seed, keep, static["window_sizes"], static["shifts"],
             static["gnum_heads"], static["scale"], static["hw_shape"])
    if layout == "corrected":
        out = WT.corrected_relayout(out, static["window_sizes"], static["shifts"], static["hw_shape"])
    return out, torch.autograd.grad(out, prim + biases, cot)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("layout", ["faithful", "corrected"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_train_kernel(dev, shift, layout, keep):
    """K3 forward and backward against autograd through the plain version on
    the card, dropout mask for mask; each launch counter moves by one."""
    prim, biases, static = train_core_inputs(dev, shift)
    cot = torch.randn(2, 1024, 96, generator=torch.Generator().manual_seed(9)).to(dev)
    before = (WT.forward_counter.launches, WT.backward_counter.launches)
    out, grads = run_train_core(WT.window_attention_block_core, prim, biases, static, 123, keep, layout, cot)
    torch.cuda.synchronize()
    assert (WT.forward_counter.launches, WT.backward_counter.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_grads = run_train_core(WT.window_attention_block_core_plain, prim, biases, static, 123, keep,
                                    layout, cot)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item() + 1e-5


def test_kernels_without_backward_refuse_autograd(dev):
    """K1 and K2 raise on the card when autograd would need their gradient,
    and run under no_grad."""
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], [0, 0, 0]).to(dev)
    x = torch.randn(2, 1024, 96, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        window_attention_block(x, x, **blk.attn.block_args(blk.ln_params()))
    with torch.no_grad():
        window_attention_block(x, x, **blk.attn.block_args(blk.ln_params()))
    w = torch.randn(96, 32, device=dev, requires_grad=True)
    b = torch.randn(96, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        gru_scan(torch.randn(4, 6, 96, device=dev), w, b)
    with torch.no_grad():
        gru_scan(torch.randn(4, 6, 96, device=dev), w, b)
