"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch sees no card.  On the machine with
the card (the port runs no JAX there, so the repository's conftest is skipped):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from dpmn_tpu_torch.models.pgrm import SwinTransformerBlock, WindowAttention
from dpmn_tpu_torch.ops import dropout_mask as DM
from dpmn_tpu_torch.ops import grouped_window_attention as GW
from dpmn_tpu_torch.ops import mlp_convs as MC
from dpmn_tpu_torch.ops import window_attention_core as WC
from dpmn_tpu_torch.ops import window_attention_full as WF
from dpmn_tpu_torch.ops import window_attention_train as WT
from dpmn_tpu_torch.ops.gru import (
    gru_bidir,
    gru_bidir_counter,
    gru_bidir_plain,
    gru_scan,
    gru_scan_counter,
    gru_scan_plain,
)
from dpmn_tpu_torch.ops import window_tile_attention as WTA
from dpmn_tpu_torch.ops.window_attention import (
    window_attention_block,
    window_attention_block_plain,
    window_attention_counter,
)
from dpmn_tpu_torch.tools import debug_train_dropout
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


# the SRB sweeps at B = 16 and 64 (H = 32, the register regime), the
# faithful gru_encoding and more sequences than one chunk (H = 512), smaller
# H of the cooperative regime; H below 32 (idle lanes: the mid and toy
# geometries' SRBs at hd_u 4), above 32 but not a multiple of 32, and not of
# 8 (37: the last CTA's units masked)
GRU_SHAPES = [(300, 16, 32), (1024, 64, 32), (64, 64, 512), (600, 3, 512), (40, 9, 64), (64, 5, 128),
              (70, 7, 1), (1024, 16, 4), (130, 9, 20), (40, 9, 48), (64, 5, 96), (90, 6, 37)]


def gru_inputs(dev, n, t, h, stride0=False, seed=0):
    """Projections of both directions (broadcast along time with stride 0
    when `stride0`), recurrent weights and biases of both directions."""
    gen = torch.Generator().manual_seed(n + t + seed)
    xps = [(0.5 * torch.randn(n, 1 if stride0 else t, 3 * h, generator=gen)).to(dev) for _ in range(2)]
    if stride0:
        xps = [x.expand(-1, t, -1) for x in xps]
    w_hh = [((torch.rand(3 * h, h, generator=gen) * 2 - 1) / h**0.5).to(dev) for _ in range(2)]
    b_hh = [((torch.rand(3 * h, generator=gen) * 2 - 1) / h**0.5).to(dev) for _ in range(2)]
    return xps, w_hh, b_hh


@pytest.mark.parametrize("n,t,h", GRU_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_kernel(dev, n, t, h, reverse):
    xps, w_hh, b_hh = gru_inputs(dev, n, t, h)
    before = gru_scan_counter.launches
    out = gru_scan(xps[0], w_hh[0], b_hh[0], reverse)
    ref = gru_scan_plain(xps[0], w_hh[0], b_hh[0], reverse)
    torch.cuda.synchronize()
    assert gru_scan_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,t,h", GRU_SHAPES)
@pytest.mark.parametrize("stride0", [False, True])
def test_gru_bidir_kernel(dev, n, t, h, stride0):
    """Both directions in one launch (the reversed one indexing time from
    T - 1 down), with and without a time stride of 0, one launch counted."""
    xps, w_hh, b_hh = gru_inputs(dev, n, t, h, stride0)
    args = (*xps, *w_hh, *b_hh)
    before = (gru_bidir_counter.launches, gru_scan_counter.launches)
    out = gru_bidir(*args)
    ref = gru_bidir_plain(*args)
    torch.cuda.synchronize()
    assert (gru_bidir_counter.launches, gru_scan_counter.launches) == (before[0] + 1, before[1])
    assert out.shape == (n, t, 2 * h)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,t,h", [(4096, 16, 32), (1024, 64, 32), (64, 64, 512)])
def test_gru_kernel_reruns_agree_bit_for_bit(dev, n, t, h):
    """Sums in a fixed order, no atomics: two runs are equal, both entry
    points, at the main path's shapes."""
    xps, w_hh, b_hh = gru_inputs(dev, n, t, h, stride0=h == 512)
    args = (*xps, *w_hh, *b_hh)
    assert torch.equal(gru_bidir(*args), gru_bidir(*args))
    assert torch.equal(gru_scan(xps[1], w_hh[1], b_hh[1], True), gru_scan(xps[1], w_hh[1], b_hh[1], True))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 6, 96, device=dev)
    w = torch.randn(96, 32, device=dev)
    b = torch.randn(96, device=dev)
    with pytest.raises(ValueError):
        gru_scan(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        gru_scan(x, w.T.contiguous().T, b)  # not contiguous
    with pytest.raises(ValueError):  # 3H columns with H beyond 512
        gru_scan(torch.randn(2, 3, 1539, device=dev), torch.randn(1539, 513, device=dev),
                 torch.randn(1539, device=dev))
    with pytest.raises(ValueError):  # x_proj's columns not 3 w_hh's
        gru_scan(torch.randn(4, 6, 31, device=dev), torch.randn(30, 10, device=dev), torch.randn(30, device=dev))
    with pytest.raises(ValueError):
        gru_bidir(x.double(), x.double(), w.double(), w.double(), b.double(), b.double())
    with pytest.raises(ValueError):
        gru_bidir(x, x, w, w.T.contiguous().T, b, b)  # not contiguous
    with pytest.raises(ValueError):
        gru_bidir(x, x[:, :, :].transpose(0, 1).contiguous().transpose(0, 1), w, w, b, b)  # other strides
    with pytest.raises(ValueError):
        x30 = torch.randn(4, 6, 30, device=dev)
        w30 = torch.randn(30, 11, device=dev)
        gru_bidir(x30, x30, w30, w30, torch.randn(30, device=dev), torch.randn(30, device=dev))
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], [0, 0, 0]).to(dev)
    kw = blk.attn.block_args(blk.ln_params())
    with pytest.raises(ValueError):
        window_attention_block(torch.randn(2, 1000, 96, device=dev), torch.randn(2, 1000, 96, device=dev), **kw)
    x = torch.randn(2, 1024, 96, device=dev)
    for heads, windows in ((4, [4, 8]), (1, [8])):  # head dims 24 and 96
        blk = SwinTransformerBlock(96, (16, 64), heads, windows, [0] * len(windows)).to(dev)
        with pytest.raises(ValueError, match="head dims 8, 16, 32"), torch.no_grad():
            window_attention_block(x, x, **blk.attn.block_args(blk.ln_params()))


def train_core_inputs(dev, shift, batch=2, seed=0, dim=96, windows=(2, 4, 8), heads=6):
    """Random pre-norm tokens, LN, projection, SKConv and relative-bias
    parameters of one block on the flagship's 16x64 grid (by default the
    flagship's: dim 96, windows 2/4/8, 6 heads), leaves that require grad
    (the 18 primals of K5, whose first 10 are K3's), and the core's static
    arguments."""
    gen = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(dim, (16, 64), heads, list(windows), list(shift))
    init_weights(blk, seed=seed + 1)
    leaf = lambda t: t.detach().clone().to(dev).requires_grad_()
    rnd = lambda *s, scale=1.0: leaf(scale * torch.randn(*s, generator=gen))
    a = blk.attn
    prim = [rnd(batch, 1024, dim), rnd(batch, 1024, dim),
            leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim, scale=0.1),
            leaf(1 + 0.1 * torch.randn(dim, generator=gen)), rnd(dim, scale=0.1),
            leaf(a.q.weight), rnd(dim, scale=0.1), leaf(a.kv.weight), rnd(2 * dim, scale=0.1)]
    prim += [leaf(t) if t.dim() == 2 else rnd(*t.shape, scale=0.1) for t in a.SKConv.weights()]
    biases = [rnd(*b.shape, scale=0.1) for b in a.biases()]
    masks = [m.to(dev) if m is not None else None for m in a.masks()]
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
    check_core_on_card(WT, WT.window_attention_block_core, WT.window_attention_block_core_plain, prim[:10], biases,
                       static, keep, layout)


def check_core_on_card(mod, fn, plain, prim, biases, static, keep, layout):
    """A training core's kernels against autograd through its plain version on
    the card (forward max abs 1e-4, each gradient within 1e-4 of its largest
    value + 1e-5); its launch counters move by one each."""
    cot = torch.randn(*prim[0].shape, generator=torch.Generator().manual_seed(9)).to(prim[0].device)
    before = (mod.forward_counter.launches, mod.backward_counter.launches)
    out, grads = run_train_core(fn, prim, biases, static, 123, keep, layout, cot)
    torch.cuda.synchronize()
    assert (mod.forward_counter.launches, mod.backward_counter.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_grads = run_train_core(plain, prim, biases, static, 123, keep, layout, cot)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    assert len(grads) == len(ref_grads) == len(prim) + len(biases)
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item() + 1e-5


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("layout", ["faithful", "corrected"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_core_kernel(dev, shift, layout, keep):
    """K4 on random projected q, k, v (the relayout after it)."""
    _, biases, static = train_core_inputs(dev, shift)
    gen = torch.Generator().manual_seed(3)
    qkv = [torch.randn(2, 1024, 96, generator=gen).to(dev).requires_grad_() for _ in range(3)]
    check_core_on_card(WC, WC.window_attention_core, WC.window_attention_core_plain, qkv, biases, static, keep,
                       layout)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_full_kernel(dev, shift, keep):
    """K5, faithful layout: all 18 primal gradients and the bias gradients."""
    prim, biases, static = train_core_inputs(dev, shift)
    check_core_on_card(WF, WF.window_attention_full_core, WF.window_attention_full_core_plain, prim, biases,
                       static, keep, "faithful")


def test_window_attention_full_backward_leaves_what_the_forward_kept(dev):
    """K5's backward reads the tokens, GAP sums and gate its forward kept and
    changes none of them: two backward passes over one forward give
    identical gradients."""
    prim, biases, static = train_core_inputs(dev, (1, 2, 4), batch=3)
    cot = torch.randn(*prim[0].shape, generator=torch.Generator().manual_seed(9)).to(dev)
    out = WF.window_attention_full_core(*prim, biases, static["masks"], 123, 0.9, static["window_sizes"],
                                        static["shifts"], static["gnum_heads"], static["scale"], static["hw_shape"])
    first = torch.autograd.grad(out, prim + biases, cot, retain_graph=True)
    second = torch.autograd.grad(out, prim + biases, cot)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_training_cores_save_what_their_backward_reads(dev):
    """K3 and K4 save their inputs alone; K5 saves its inputs and the three
    tensors its forward kept (tokens, GAP sums, gate)."""
    prim, biases, static = train_core_inputs(dev, (1, 2, 4))
    args = (biases, static["masks"], 123, 0.9, static["window_sizes"], static["shifts"], static["gnum_heads"],
            static["scale"], static["hw_shape"])
    q = prim[0]
    for fn, inputs in ((WT.window_attention_block_core, prim[:10]), (WC.window_attention_core, [q, q, q])):
        out = fn(*inputs, *args)
        saved = out.grad_fn.saved_tensors
        assert len(saved) == len(inputs) + len(biases)
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(saved, inputs + biases))
    out = WF.window_attention_full_core(*prim, *args)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 18 + len(biases) + 3
    assert [tuple(t.shape) for t in saved[-3:]] == list(WF.kept_shapes(2, 1024, 96))


# the widths the wrappers admit (D % 32 == 0, D <= 96, head dim 16): dim,
# windows, heads, shifts; 2 heads a group at D = 96 and 64, 1 at D = 32
WIDTHS = [(96, (2, 4, 8), 6, (1, 2, 4)), (64, (2, 8), 4, (1, 4)), (32, (4, 8), 2, (2, 4))]
# 16 tiles of 64 tokens an image: on a 132-SM card the persistent CTAs take
# one tile each up to 8 images and walk more than one, unevenly, at 9
BATCHES = [1, 3, 5, 9]


def geometry(width, shifted):
    dim, windows, heads, shift = width
    return dim, windows, heads, shift if shifted == "shifted" else (0,) * len(windows)


def k1_inputs(dev, batch, dim=96, windows=(2, 4, 8), heads=6, shift=(1, 2, 4), faithful=True, with_ln=True,
              seed=0):
    """Tokens and the keyword arguments of `window_attention_block` for one
    block on the 16x64 grid, with perturbed norms and relative biases."""
    gen = torch.Generator().manual_seed(seed)
    blk = SwinTransformerBlock(dim, (16, 64), heads, list(windows), list(shift), faithful=faithful)
    init_weights(blk, seed=seed + 1)
    with torch.no_grad():
        for ln in (blk.norm1_q, blk.norm1_kv):
            ln.weight.add_(0.1 * torch.randn(dim, generator=gen))
            ln.bias.add_(0.1 * torch.randn(dim, generator=gen))
        for i in range(len(windows)):
            getattr(blk.attn, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
    blk = blk.to(dev)
    xq = torch.randn(batch, 1024, dim, generator=gen).to(dev)
    xkv = torch.randn(batch, 1024, dim, generator=gen).to(dev)
    return xq, xkv, blk.attn.block_args(blk.ln_params() if with_ln else None)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("width", WIDTHS, ids=lambda wd: f"D{wd[0]}")
@pytest.mark.parametrize("faithful", [True, False])
def test_window_attention_kernel_batches_and_widths(dev, batch, width, faithful):
    """K1 against its plain version at every width the wrapper admits and at
    batches where the persistent CTAs take one tile each or walk several."""
    dim, windows, heads, shift = width
    xq, xkv, kw = k1_inputs(dev, batch, dim, windows, heads, shift, faithful, with_ln=batch != 3)
    with torch.no_grad():
        out = window_attention_block(xq, xkv, **kw)
        ref = window_attention_block_plain(xq, xkv, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("width", WIDTHS, ids=lambda wd: f"D{wd[0]}")
def test_window_attention_train_kernel_batches_and_widths(dev, batch, width):
    """K3 forward and every gradient against autograd through its plain
    version (dropout on), as test_window_attention_train_kernel."""
    dim, windows, heads, shift = width
    prim, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    check_core_on_card(WT, WT.window_attention_block_core, WT.window_attention_block_core_plain, prim[:10], biases,
                       static, 0.9, "faithful")


@pytest.mark.parametrize("width", WIDTHS[1:], ids=lambda wd: f"D{wd[0]}")
def test_window_attention_full_kernel_widths(dev, width):
    """K5 at the narrower widths (SKConv's proj_head weight gradient over 16
    or 32 channels), B = 9."""
    dim, windows, heads, shift = width
    prim, biases, static = train_core_inputs(dev, shift, 9, dim=dim, windows=windows, heads=heads)
    check_core_on_card(WF, WF.window_attention_full_core, WF.window_attention_full_core_plain, prim, biases, static,
                       0.9, "faithful")


# K4's narrower widths (D = 64: 2 heads a group; D = 32: 1 head) and D = 96
# in two groups of 3 heads (windows of 4 tokens on a block that is not a
# whole number of warps; 8x8 windows with more warp tiles than warps)
K4_WIDTHS = WIDTHS[1:] + [(96, (2, 8), 6, (1, 4))]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("width", K4_WIDTHS, ids=lambda wd: f"D{wd[0]}g{len(wd[1])}")
def test_window_attention_core_kernel_batches_and_widths(dev, batch, width):
    """K4 forward and backward at B = 1 and 3, shifted, keep 0.9, against
    autograd through its plain version."""
    dim, windows, heads, shift = width
    _, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    gen = torch.Generator().manual_seed(11)
    qkv = [torch.randn(batch, 1024, dim, generator=gen).to(dev).requires_grad_() for _ in range(3)]
    check_core_on_card(WC, WC.window_attention_core, WC.window_attention_core_plain, qkv, biases, static, 0.9,
                       "faithful")


def test_window_attention_core_kernel_unaligned_rows(dev):
    """K4 on q, k, v whose rows are not 16-byte aligned (views one float
    into their storage): the kernels stage element by element, the
    backward's 4x4 and 8x8 windows go to the thread-per-row kernel."""
    _, biases, static = train_core_inputs(dev, (1, 2, 4))
    gen = torch.Generator().manual_seed(13)
    qkv = [torch.randn(2 * 1024 * 96 + 1, generator=gen).to(dev)[1:].view(2, 1024, 96).requires_grad_()
           for _ in range(3)]
    assert all(t.data_ptr() % 16 for t in qkv)
    check_core_on_card(WC, WC.window_attention_core, WC.window_attention_core_plain, qkv, biases, static, 0.9,
                       "faithful")


def test_window_attention_kernels_rerun_bit_for_bit(dev):
    """K1's output, and K3's and K5's forward output and every gradient, are
    equal across two runs (fixed-order sums, no float atomics)."""
    xq, xkv, kw = k1_inputs(dev, 9)
    with torch.no_grad():
        assert torch.equal(window_attention_block(xq, xkv, **kw), window_attention_block(xq, xkv, **kw))
    prim, biases, static = train_core_inputs(dev, (1, 2, 4), batch=9)
    cot = torch.randn(*prim[0].shape, generator=torch.Generator().manual_seed(9)).to(dev)
    for fn, n in ((WT.window_attention_block_core, 10), (WF.window_attention_full_core, 18)):
        (o1, g1), (o2, g2) = (run_train_core(fn, prim[:n], biases, static, 123, 0.9, "faithful", cot) for _ in range(2))
        assert torch.equal(o1, o2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def bf16_block_args(kw):
    """`window_attention_block` keyword arguments with the weights, the LN
    parameters and the relative biases in bf16 (the masks stay float32)."""
    bf = lambda d: None if d is None else {k: t.bfloat16() for k, t in d.items()}
    return dict(kw, weights=bf(kw["weights"]), ln=bf(kw["ln"]), biases=[b.bfloat16() for b in kw["biases"]])


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda wd: f"D{wd[0]}")
@pytest.mark.parametrize("shift", ["unshifted", "shifted"])
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("with_ln", [True, False])
def test_window_attention_kernel_bf16(dev, batch, width, shift, faithful, with_ln):
    """K1 on bf16 io against its plain version on the same bf16 inputs, one
    launch, bf16 out: max abs <= 2^-7 max|out|, one bf16 rounding of the
    largest value (tests/test_torch_window_attention_bf16.py)."""
    dim, windows, heads, shifts = width
    shifts = shifts if shift == "shifted" else (0,) * len(windows)
    xq, xkv, kw = k1_inputs(dev, batch, dim, windows, heads, shifts, faithful, with_ln)
    xq, xkv, kw = xq.bfloat16(), xkv.bfloat16(), bf16_block_args(kw)
    before = window_attention_counter.launches
    with torch.no_grad():
        out = window_attention_block(xq, xkv, **kw)
        ref = window_attention_block_plain(xq, xkv, **kw)
    torch.cuda.synchronize()
    assert window_attention_counter.launches == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0**-7 * ref.float().abs().max().item(), err


def test_window_attention_kernel_bf16_reruns_bit_for_bit_and_refuses_mixed_dtypes(dev):
    xq, xkv, kw = k1_inputs(dev, 9)
    xq16, xkv16, kw16 = xq.bfloat16(), xkv.bfloat16(), bf16_block_args(kw)
    with torch.no_grad():
        assert torch.equal(window_attention_block(xq16, xkv16, **kw16), window_attention_block(xq16, xkv16, **kw16))
        with pytest.raises(ValueError):  # bf16 tokens with float32 weights: no cast, no fallback
            window_attention_block(xq16, xkv16, **kw)
        with pytest.raises(ValueError):
            window_attention_block(xq, xkv, **kw16)
        with pytest.raises(ValueError):
            window_attention_block(xq.half(), xkv.half(), **kw)


def bf16_core_args(prim, biases):
    """K3's primals as bf16 leaves; the biases stay float32."""
    return [p.detach().bfloat16().requires_grad_() for p in prim[:10]], biases


def check_bf16_core_on_card(mod, fn, plain, prim, biases, static, keep, seed=123):
    """A training core on bf16 io against autograd through its plain version
    on the card (tests/test_torch_window_attention_*_bf16.py's limits: the
    output within 2^-7 of max|out|, each gradient within 2^-6 of its largest
    value); bf16 out and primal gradients, float32 dbias; the bf16 counters
    move by one each, the float32 ones not."""
    cot = torch.randn(*prim[0].shape, generator=torch.Generator().manual_seed(9)).to(prim[0].device, torch.bfloat16)
    counters = (mod.forward_bf16_counter, mod.backward_bf16_counter, mod.forward_counter, mod.backward_counter)
    before = [c.launches for c in counters]
    out, grads = run_train_core(fn, prim, biases, static, seed, keep, "faithful", cot)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 1, before[2], before[3]]
    ref, ref_grads = run_train_core(plain, prim, biases, static, seed, keep, "faithful", cot)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-7 * ref.float().abs().max().item()
    assert len(grads) == len(ref_grads) == len(prim) + len(biases)
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        assert g.dtype == (torch.bfloat16 if i < len(prim) else torch.float32)
        assert (g.float() - r.float()).abs().max().item() <= 2.0**-6 * r.float().abs().max().item(), i


# the bf16 backwards' geometries (K3, K5): head dim 16 at D = 96, 64, 32
# (WIDTHS), 32 at D = 96 (3 heads), 8 at D = 48 and 16 (the mid and toy
# blocks); windows 2, 4 and 8 among them
BF16_WIDTHS = WIDTHS + [(96, (2, 4, 8), 3, (1, 2, 4)), (48, (2, 4, 8), 6, (1, 2, 4)), (16, (2, 4), 2, (1, 2))]
BF16_IDS = [f"D{d}hd{d // h}" for d, _, h, _ in BF16_WIDTHS]


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("width", BF16_WIDTHS, ids=BF16_IDS)
@pytest.mark.parametrize("shifted", ["unshifted", "shifted"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_train_kernel_bf16(dev, batch, width, shifted, keep):
    """K3 on bf16 io forward and backward against autograd through its plain
    version on the card (check_bf16_core_on_card), at head dims 8, 16 and 32
    and D = 16 to 96, both shift sets."""
    dim, windows, heads, shift = geometry(width, shifted)
    prim, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    prim, biases = bf16_core_args(prim, biases)
    check_bf16_core_on_card(WT, WT.window_attention_block_core, WT.window_attention_block_core_plain, prim, biases,
                            static, keep)


# a scale that is not a power of two (head dim 12's), and 3 heads a group
# (D = 96 in two groups of 48: the thread-per-row attention backward)
BF16_SCALES = [0.25, 12**-0.5]
BF16_HEADS = [WIDTHS[0], K4_WIDTHS[-1]]


@pytest.mark.parametrize("scale", BF16_SCALES)
@pytest.mark.parametrize("width", BF16_HEADS, ids=lambda wd: f"g{len(wd[1])}h{wd[2] // len(wd[1])}")
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_train_kernel_bf16_heads_and_scales(dev, scale, width, keep):
    """K3 on bf16 io with 2 and 3 heads a group and any scale (q times the
    bf16-rounded scale, rounded once; dq with the float32 scale)."""
    dim, windows, heads, shift = width
    prim, biases, static = train_core_inputs(dev, shift, 3, dim=dim, windows=windows, heads=heads)
    prim, biases = bf16_core_args(prim, biases)
    check_bf16_core_on_card(WT, WT.window_attention_block_core, WT.window_attention_block_core_plain, prim, biases,
                            dict(static, scale=scale), keep)


def bf16_qkv(dev, batch, dim, seed=11, kv_views=False):
    """Random bf16 q, k, v leaves (B, 1024, dim); with kv_views, k and v the
    halves of one (B, 1024, 2 dim) leaf, as the "attention" core passes
    them (the leaves returned are then q and kv)."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda d: torch.randn(batch, 1024, d, generator=gen).to(dev, torch.bfloat16).requires_grad_()
    if not kv_views:
        return [rnd(dim) for _ in range(3)]
    q, kv = rnd(dim), rnd(2 * dim)
    return [q, kv[..., :dim], kv[..., dim:]]


@pytest.mark.parametrize("batch", [1, 9])
@pytest.mark.parametrize("width", BF16_WIDTHS + K4_WIDTHS[-1:], ids=BF16_IDS + ["D96hd16g2"])
@pytest.mark.parametrize("shifted", ["unshifted", "shifted"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("kv", ["kv_halves", "separate"])
def test_window_attention_core_kernel_bf16(dev, batch, width, shifted, keep, kv):
    """K4 on bf16 io against autograd through its plain version
    (check_bf16_core_on_card) at head dims 8, 16 and 32, D = 16 to 96,
    windows 2, 4 and 8 (and 3 heads a group: the thread-per-row backward),
    both shift sets, k and v the halves of one kv tensor (row stride 2D) or
    tensors of their own."""
    dim, windows, heads, shift = geometry(width, shifted)
    _, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    qkv = bf16_qkv(dev, batch, dim, kv_views=kv == "kv_halves")
    check_bf16_core_on_card(WC, WC.window_attention_core, WC.window_attention_core_plain, qkv, biases, static, keep)


@pytest.mark.parametrize("scale", BF16_SCALES)
@pytest.mark.parametrize("width", BF16_HEADS, ids=lambda wd: f"g{len(wd[1])}h{wd[2] // len(wd[1])}")
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_core_kernel_bf16_heads_and_scales(dev, scale, width, keep):
    dim, windows, heads, shift = width
    _, biases, static = train_core_inputs(dev, shift, 3, dim=dim, windows=windows, heads=heads)
    qkv = bf16_qkv(dev, 3, dim, kv_views=True)
    check_bf16_core_on_card(WC, WC.window_attention_core, WC.window_attention_core_plain, qkv, biases,
                            dict(static, scale=scale), keep)


@pytest.mark.parametrize("kv", ["kv_halves", "separate"])
def test_window_attention_core_bf16_backward_launches_and_layout(dev, kv):
    """K4's bf16 backward launches an attention backward and a dbias sum a
    window group, 6 at the flagship's three (the library's own count), and
    writes dk and dv at k's and v's row stride: the halves of one (B, L, 2D)
    buffer where k and v are the halves of one kv tensor, contiguous
    otherwise."""
    import ctypes

    from dpmn_tpu_torch.ops import kernels

    dim, windows, heads, shift = WIDTHS[0]
    _, biases, static = train_core_inputs(dev, shift, 3, dim=dim, windows=windows, heads=heads)
    qkv = [t.detach() for t in bf16_qkv(dev, 3, dim, kv_views=kv == "kv_halves")]
    st = WT.make_static(static["masks"], 123, 0.9, static["window_sizes"], static["shifts"], static["gnum_heads"],
                        static["scale"], static["hw_shape"])
    cot = torch.randn(3, 1024, dim, generator=torch.Generator().manual_seed(9)).to(dev, torch.bfloat16)
    count = kernels.bind("window_attention_core", "window_attention_core_kernel_launches", [], ctypes.c_ulonglong)
    torch.cuda.synchronize()
    before = count()
    dq, dk, dv, *_ = WC._backward_cuda(st, qkv, [b.detach() for b in biases], cot)
    torch.cuda.synchronize()
    assert count() - before == 6
    assert dq.is_contiguous() and all(t.dtype == torch.bfloat16 for t in (dq, dk, dv))
    if kv == "kv_halves":
        assert dk.stride(1) == dv.stride(1) == 2 * dim and dv.data_ptr() == dk.data_ptr() + 2 * dim
    else:
        assert dk.is_contiguous() and dv.is_contiguous()


@pytest.mark.parametrize("width", BF16_WIDTHS, ids=BF16_IDS)
@pytest.mark.parametrize("residual", [0, 1])
def test_skconv_bf16_weights_match_float32_weights(dev, width, residual):
    """SKConv's bf16-weight instances (two TF32 passes a product step: the
    widened weight is exact in TF32) against its float32-weight instances
    fed the same weights widened, on the same float32 tokens: feats, the GAP
    partials and the gate bit for bit, and out equal to the float32 result
    rounded to bf16."""
    import ctypes

    from dpmn_tpu_torch.ops import kernels

    dim, windows, heads, _ = width
    batch, n_group = 3, len(windows)
    blk = SwinTransformerBlock(dim, (16, 64), heads, list(windows), [0] * n_group)
    init_weights(blk, seed=4)
    gen = torch.Generator().manual_seed(4)
    w16 = [(t.detach() if t.dim() == 2 else 0.1 * torch.randn(*t.shape, generator=gen)).to(dev, torch.bfloat16)
           for t in blk.attn.SKConv.weights()]
    dz = w16[2].shape[0]
    attn = torch.randn(batch, 1024, dim, generator=gen).to(dev)
    xkv = torch.randn(batch, 1024, dim, generator=gen).to(dev, torch.bfloat16)
    vp = ctypes.c_void_p
    runs = []
    for name, w, x in (("window_attention_skconv", [t.float() for t in w16], xkv.float()),
                       ("window_attention_skconv_bf16", w16, xkv)):
        fn = kernels.bind("window_attention", name, [vp] * 7 + [ctypes.c_int] * 6 + [vp])
        bufs = [torch.empty(batch, 1024, dim, device=dev), torch.empty(batch, 1024 // 64, dim, device=dev),
                torch.empty(batch, n_group, dim // n_group, device=dev), torch.empty_like(x)]
        ptrs = (vp * 8)(*[t.data_ptr() for t in w])
        err = fn(vp(attn.data_ptr()), ptrs, vp(x.data_ptr()), *[vp(t.data_ptr()) for t in bufs], batch, 1024, dim,
                 n_group, dz, residual, kernels.stream_ptr(dev))
        assert err == 0
        runs.append(bufs)
    torch.cuda.synchronize()
    (feats, part, gate, out), (feats16, part16, gate16, out16) = runs
    assert torch.equal(feats16, feats) and torch.equal(part16, part) and torch.equal(gate16, gate)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, out.bfloat16())


@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("width", BF16_WIDTHS, ids=BF16_IDS)
@pytest.mark.parametrize("shifted", ["unshifted", "shifted"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_window_attention_full_kernel_bf16(dev, batch, width, shifted, keep):
    """K5 on bf16 io: all 18 primal gradients (bf16) and the bias gradients
    (float32) against autograd through its plain version, at the geometries
    of test_window_attention_train_kernel_bf16."""
    dim, windows, heads, shift = geometry(width, shifted)
    prim, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    prim = [p.detach().bfloat16().requires_grad_() for p in prim]
    check_bf16_core_on_card(WF, WF.window_attention_full_core, WF.window_attention_full_core_plain, prim, biases,
                            static, keep)


@pytest.mark.parametrize("scale", BF16_SCALES)
@pytest.mark.parametrize("width", BF16_HEADS, ids=lambda wd: f"g{len(wd[1])}h{wd[2] // len(wd[1])}")
def test_window_attention_full_kernel_bf16_heads_and_scales(dev, scale, width):
    dim, windows, heads, shift = width
    prim, biases, static = train_core_inputs(dev, shift, 3, dim=dim, windows=windows, heads=heads)
    prim = [p.detach().bfloat16().requires_grad_() for p in prim]
    check_bf16_core_on_card(WF, WF.window_attention_full_core, WF.window_attention_full_core_plain, prim, biases,
                            dict(static, scale=scale), 0.9)


def bf16_forward_static(static, keep, seed=123):
    return WT.make_static(static["masks"], seed, keep, static["window_sizes"], static["shifts"],
                          static["gnum_heads"], static["scale"], static["hw_shape"])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("width", BF16_WIDTHS, ids=BF16_IDS)
@pytest.mark.parametrize("shifted", ["unshifted", "shifted"])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_block_forward_bf16_equals_ln_proj_and_core_forward(dev, batch, width, shifted, keep):
    """K3's one-launch bf16 forward (LN, projections and attention; q and kv
    never reach device memory) equals, bit for bit, the LN + projection
    kernel's bf16 q and kv (`ln_proj_bf16_cuda`) run through K4's bf16
    forward (each q / k / v value is the same dot product in the same order,
    and the attention step is one routine), and K5's bf16 forward keeps the
    same attention in float32 tokens (rounded, K3's output), at head dims 8,
    16 and 32, D = 16 to 96, both shift sets."""
    dim, windows, heads, shift = geometry(width, shifted)
    prim, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    prim = [p.detach().bfloat16() for p in prim]
    biases = [b.detach() for b in biases]
    st = bf16_forward_static(static, keep)
    out = WT._forward_bf16_cuda(st, prim[:10], biases)[0]
    q, kv = WT.ln_proj_bf16_cuda(prim[:10])
    ref = WC._forward_cuda(st, [q, kv[..., :dim], kv[..., dim:]], biases)[0]
    tok = WF._forward_cuda(st, prim, biases)[1][0]
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert torch.equal(out, ref)
    assert tok.dtype == torch.float32 and torch.equal(tok.bfloat16(), out)


def test_bf16_forwards_launch_once_and_k5_four_times(dev):
    """A bf16 forward call launches, by its library's own count, one kernel
    for K3 (LN, projections, attention) and K4 (the attention of every
    group), four for K5 (K3's with float32 tokens, SKConv's three)."""
    import ctypes

    from dpmn_tpu_torch.ops import kernels

    prim, biases, static = train_core_inputs(dev, (1, 2, 4), 2)
    prim = [p.detach().bfloat16() for p in prim]
    biases = [b.detach() for b in biases]
    st = bf16_forward_static(static, 0.9)
    qkv = [t.detach() for t in bf16_qkv(dev, 2, 96, kv_views=True)]
    for mod, lib, p, want in ((WT, "window_attention_train", prim[:10], 1), (WC, "window_attention_core", qkv, 1),
                              (WF, "window_attention_full", prim, 4)):
        count = kernels.bind(lib, f"{lib}_kernel_launches", [], ctypes.c_ulonglong)
        torch.cuda.synchronize()
        before = count()
        mod._forward_cuda(st, p, biases)
        torch.cuda.synchronize()
        assert count() - before == want, lib


def test_window_attention_train_kernel_bf16_reruns_bit_for_bit_and_refuses(dev):
    """K3, K4 and K5 on bf16 io: forward and every gradient equal across two
    runs; mixed dtypes and bf16 biases raise on the card, and K4 refuses k
    and v of two row strides."""
    prim, biases, static = train_core_inputs(dev, (1, 2, 4), batch=9)
    prim16, biases = bf16_core_args(prim, biases)
    cot = torch.randn(*prim[0].shape, generator=torch.Generator().manual_seed(9)).to(dev, torch.bfloat16)
    full16 = prim16 + [p.detach().bfloat16().requires_grad_() for p in prim[10:]]
    qkv = bf16_qkv(dev, 9, 96, kv_views=True)
    for fn, p in ((WT.window_attention_block_core, prim16), (WC.window_attention_core, qkv),
                  (WF.window_attention_full_core, full16)):
        runs = [run_train_core(fn, p, biases, static, 123, 0.9, "faithful", cot) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0]) and all(torch.equal(a, b) for a, b in zip(*[r[1] for r in runs]))
    tail = (static["masks"], 0, 1.0, static["window_sizes"], static["shifts"], static["gnum_heads"], static["scale"],
            static["hw_shape"])
    with pytest.raises(TypeError):
        WT.window_attention_block_core(*prim16[:6], *prim[6:10], biases, *tail)
    with pytest.raises(TypeError):
        WT.window_attention_block_core(*prim16, [b.bfloat16() for b in biases], *tail)
    with pytest.raises(TypeError):
        WF.window_attention_full_core(*full16[:12], *prim[12:], biases, *tail)
    with pytest.raises(TypeError):
        WC.window_attention_core(qkv[0], qkv[1], qkv[2].float(), biases, *tail)
    with pytest.raises(ValueError):  # k a view of stride 2D, v contiguous
        WC.window_attention_core(qkv[0], qkv[1], qkv[0], biases, *tail)


def test_window_kernels_reject_other_widths(dev):
    """D = 128 (beyond the kernels' 96) and head dim 24 (D = 96 in two
    groups of 2 heads) raise in K1 and K3, naming the limit."""
    for dim, windows, heads, limit in ((128, (2, 4, 8, 4), 8, "up to 96"), (96, (4, 8), 4, "head dims 8, 16, 32")):
        zeros = (0,) * len(windows)
        xq, xkv, kw = k1_inputs(dev, 1, dim, windows, heads, zeros)
        with pytest.raises(ValueError, match=limit), torch.no_grad():
            window_attention_block(xq, xkv, **kw)
        prim, biases, static = train_core_inputs(dev, zeros, 1, dim=dim, windows=windows, heads=heads)
        with pytest.raises(ValueError, match=limit):
            WT.window_attention_block_core(*prim[:10], biases, static["masks"], 0, 1.0, static["window_sizes"],
                                           static["shifts"], static["gnum_heads"], static["scale"],
                                           static["hw_shape"])


# the geometries beyond head dim 16 (dim, windows, heads, shifts): head dim
# 32 (3 heads at D = 96, 2 at D = 64), head dim 8 with 4 heads a group (the
# flagship's --num_heads 12: the thread-per-row attention backward), and D =
# 48, 16, 80 at head dim 8 (the mid and toy geometries' blocks; D = 80 in 5
# groups of 16)
GEOM_WIDTHS = [(96, (2, 4, 8), 3, (1, 2, 4)), (64, (2, 8), 2, (1, 4)), (96, (2, 4, 8), 12, (1, 2, 4)),
               (48, (2, 4, 8), 6, (1, 2, 4)), (16, (2, 4), 2, (1, 2)), (80, (2, 4, 8, 4, 8), 10, (1, 2, 4, 2, 4))]
GEOM_IDS = [f"D{d}hd{d // h}" for d, _, h, _ in GEOM_WIDTHS]
GEOM_CASES = [(b, sh) for b in (1, 3) for sh in ("unshifted", "shifted")]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("batch,shifted", GEOM_CASES)
@pytest.mark.parametrize("width", GEOM_WIDTHS, ids=GEOM_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_window_attention_kernel_geometries(dev, batch, shifted, width, dtype):
    """K1 at head dims 8 and 32 and D = 16, 48, 80 against its plain
    version: float32 at 1e-4, bf16 io at 2^-7 of max|out|."""
    dim, windows, heads, shift = geometry(width, shifted)
    xq, xkv, kw = k1_inputs(dev, batch, dim, windows, heads, shift)
    if dtype == torch.bfloat16:
        xq, xkv, kw = xq.bfloat16(), xkv.bfloat16(), bf16_block_args(kw)
    before = window_attention_counter.launches
    with torch.no_grad():
        out = window_attention_block(xq, xkv, **kw)
        ref = window_attention_block_plain(xq, xkv, **kw)
    torch.cuda.synchronize()
    assert window_attention_counter.launches == before + 1 and out.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("batch,shifted", GEOM_CASES)
@pytest.mark.parametrize("width", GEOM_WIDTHS, ids=GEOM_IDS)
@pytest.mark.parametrize("keep", [1.0, 0.9])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("core", ["block", "attention", "full"])
def test_training_cores_geometries(dev, batch, shifted, width, keep, dtype, core):
    """K3, K4 and K5 forward and backward at head dims 8 and 32 and D = 16,
    48, 80 against autograd through their plain versions: float32 as
    check_core_on_card, bf16 io as check_bf16_core_on_card (K4's k and v
    the halves of one kv tensor)."""
    dim, windows, heads, shift = geometry(width, shifted)
    prim, biases, static = train_core_inputs(dev, shift, batch, dim=dim, windows=windows, heads=heads)
    mod, fn, plain = {"block": (WT, WT.window_attention_block_core, WT.window_attention_block_core_plain),
                      "attention": (WC, WC.window_attention_core, WC.window_attention_core_plain),
                      "full": (WF, WF.window_attention_full_core, WF.window_attention_full_core_plain)}[core]
    if core == "attention":
        gen = torch.Generator().manual_seed(11)
        prim = ([torch.randn(batch, 1024, dim, generator=gen).to(dev).requires_grad_() for _ in range(3)]
                if dtype == torch.float32 else bf16_qkv(dev, batch, dim, kv_views=True))
    elif core == "block":
        prim = prim[:10]
    if dtype == torch.float32:
        check_core_on_card(mod, fn, plain, prim, biases, static, keep, "faithful")
    else:
        if core != "attention":
            prim = [p.detach().bfloat16().requires_grad_() for p in prim]
        check_bf16_core_on_card(mod, fn, plain, prim, biases, static, keep)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("width", GEOM_WIDTHS, ids=GEOM_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_grouped_window_attention_kernel_geometries(dev, batch, width, dtype):
    """K7 at head dims 8 and 32 and D = 16, 48, 80 (check_k7)."""
    check_k7(*k7_inputs(dev, batch, width, dtype))


@pytest.mark.parametrize("width", [GEOM_WIDTHS[0], GEOM_WIDTHS[2]], ids=["hd32", "hd8"])
def test_window_kernels_rerun_bit_for_bit_at_new_head_dims(dev, width):
    """K1, and K3, K4 and K5 forward and every gradient, equal across two
    runs at head dims 32 and 8, float32 and bf16 io."""
    dim, windows, heads, shift = width
    xq, xkv, kw = k1_inputs(dev, 3, dim, windows, heads, shift)
    with torch.no_grad():
        assert torch.equal(window_attention_block(xq, xkv, **kw), window_attention_block(xq, xkv, **kw))
        kw16 = bf16_block_args(kw)
        assert torch.equal(window_attention_block(xq.bfloat16(), xkv.bfloat16(), **kw16),
                           window_attention_block(xq.bfloat16(), xkv.bfloat16(), **kw16))
    prim, biases, static = train_core_inputs(dev, shift, 3, dim=dim, windows=windows, heads=heads)
    gen = torch.Generator().manual_seed(9)
    qkv = [torch.randn(3, 1024, dim, generator=gen).to(dev).requires_grad_() for _ in range(3)]
    prim16 = [p.detach().bfloat16().requires_grad_() for p in prim]
    for fn, p in ((WT.window_attention_block_core, prim[:10]), (WC.window_attention_core, qkv),
                  (WF.window_attention_full_core, prim), (WT.window_attention_block_core, prim16[:10]),
                  (WC.window_attention_core, bf16_qkv(dev, 3, dim, kv_views=True)),
                  (WF.window_attention_full_core, prim16)):
        cot = torch.randn(*p[0].shape, generator=gen).to(dev, p[0].dtype)
        runs = [run_train_core(fn, p, biases, static, 123, 0.9, "faithful", cot) for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0]) and all(torch.equal(a, b) for a, b in zip(*[r[1] for r in runs]))


@pytest.mark.parametrize("head_dim", [8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("core", ["block", "attention", "full"])
def test_unshifted_4x4_backward_at_every_head_dim(dev, head_dim, dtype, core):
    """The null shift-mask fault's reproducer (ROADMAP §3): two groups of
    4x4 windows, unshifted, one head a group, keep 0.9, B = 1, at D = 2
    head_dim, so head dims 8, 16 and 32; each core on each io type against
    its plain version."""
    dim = 2 * head_dim
    prim, biases, static = train_core_inputs(dev, (0, 0), 1, dim=dim, windows=(4, 4), heads=2)
    mod, fn, plain = {"block": (WT, WT.window_attention_block_core, WT.window_attention_block_core_plain),
                      "attention": (WC, WC.window_attention_core, WC.window_attention_core_plain),
                      "full": (WF, WF.window_attention_full_core, WF.window_attention_full_core_plain)}[core]
    if core == "attention":
        gen = torch.Generator().manual_seed(11)
        prim = ([torch.randn(1, 1024, dim, generator=gen).to(dev).requires_grad_() for _ in range(3)]
                if dtype == torch.float32 else bf16_qkv(dev, 1, dim, kv_views=True))
    elif core == "block":
        prim = prim[:10]
    if dtype == torch.float32:
        check_core_on_card(mod, fn, plain, prim, biases, static, 0.9, "faithful")
    else:
        if core != "attention":
            prim = [p.detach().bfloat16().requires_grad_() for p in prim]
        check_bf16_core_on_card(mod, fn, plain, prim, biases, static, 0.9)


def test_training_cores_reject_what_the_kernels_do_not_take(dev):
    prim, biases, static = train_core_inputs(dev, (0, 0, 0))
    args = (biases, static["masks"], 0, 1.0, static["window_sizes"], static["shifts"], static["gnum_heads"],
            static["scale"], static["hw_shape"])
    q = prim[0]
    with pytest.raises(ValueError):
        WC.window_attention_core(q, q, q.double(), *args)
    with pytest.raises(ValueError):
        WC.window_attention_core(q, q, q.transpose(1, 2).contiguous().transpose(1, 2), *args)
    with pytest.raises(ValueError):
        WF.window_attention_full_core(*prim[:12], prim[12][:, :8].contiguous(), *prim[13:], *args)
    with pytest.raises(ValueError):
        WF.window_attention_full_core(*prim, *args[:-1], (16, 32))  # L != H * W


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
    x = torch.randn(4, 6, 96, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        gru_bidir(x, x, w, w, b, b)
    with torch.no_grad():
        gru_bidir(x, x, w, w, b, b)


def tile_inputs(dev, w, n, c, masked):
    """q, k, v (W, N, C), a bias and (masked) a mask of -100s on 30 % of the
    entries, from a seed."""
    gen = torch.Generator().manual_seed(w + n)
    q, k, v = ((0.5 * torch.randn(w, n, c, generator=gen)).to(dev) for _ in range(3))
    bias = (0.1 * torch.randn(w, n, n, generator=gen)).to(dev)
    mask = torch.where(torch.rand(w, n, n, generator=gen) < 0.3, -100.0, 0.0).to(dev) if masked else None
    return q, k, v, bias, mask


# the tensor-core tiles' ragged edges: N one past a 16-row tile (17, 33) and
# one short of the largest (63), padded to 32, 48 and 64 rows with padded
# keys; C = 1 and 9 (element-by-element staging, channels padded to 8 and
# 16) and 64 (16-byte pieces); 37 windows, so the last step is partial
TILE_EDGES = [(37, n, c) for n in (17, 33, 63) for c in (1, 9, 64)]


@pytest.mark.parametrize("wnc", [(10, 16, 8), (300, 4, 16), (96, 16, 16), (40, 64, 16), (7, 64, 64), (33, 9, 5)]
                         + TILE_EDGES)
@pytest.mark.parametrize("masked", [False, True])
def test_window_tile_attention_kernel(dev, wnc, masked):
    """K8 against its plain version: ragged block ends, every window size of
    the flagship, the largest N and C it takes, odd ones, and the edges of
    its tensor-core tiles."""
    q, k, v, bias, mask = tile_inputs(dev, *wnc, masked)
    before = WTA.window_tile_attention_counter.launches
    out = WTA.window_tile_attention(q, k, v, bias, mask)
    ref = WTA.window_tile_attention_plain(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert WTA.window_tile_attention_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_window_attention_core_and_tiles_rerun_bit_for_bit(dev):
    """K4's forward output and every gradient (dropout on), and K8's output,
    are equal across two runs (fixed-order sums, no float atomics)."""
    _, biases, static = train_core_inputs(dev, (1, 2, 4), batch=3)
    gen = torch.Generator().manual_seed(12)
    qkv = [torch.randn(3, 1024, 96, generator=gen).to(dev).requires_grad_() for _ in range(3)]
    cot = torch.randn(3, 1024, 96, generator=gen).to(dev)
    (o1, g1), (o2, g2) = (run_train_core(WC.window_attention_core, qkv, biases, static, 123, 0.9, "faithful", cot)
                          for _ in range(2))
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    args = tile_inputs(dev, 300, 64, 16, True)
    assert torch.equal(WTA.window_tile_attention(*args), WTA.window_tile_attention(*args))


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_window_attention_kernel(dev, shift, dtype):
    """K7 against its plain version in its io type: float32 to 1e-4; bf16 to
    one bf16 rounding of the largest value."""
    gen = torch.Generator().manual_seed(5)
    wa = WindowAttention(96, [2, 4, 8], list(shift), 6, (16, 64))
    with torch.no_grad():
        for i in range(3):
            getattr(wa, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
    wa = wa.to(dev)
    q, k, v = ((0.5 * torch.randn(2, 16, 64, 96, generator=gen)).to(dev, dtype) for _ in range(3))
    args = ([b.detach().to(dtype) for b in wa.biases()], wa.masks(), wa.win, wa.shf, wa.gnum_heads, wa.scale)
    before = GW.grouped_window_attention_counter.launches
    out = GW.grouped_window_attention(q, k, v, *args)
    ref = GW.grouped_window_attention_plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert GW.grouped_window_attention_counter.launches == before + 1
    assert out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item())


def device_kernels(fn, attempts=5):
    """The names of the kernels one call of fn launches (torch.profiler),
    after a warm-up call.  A profile that recorded no kernel is taken again:
    CUPTI drops every event of some later profiles of a process."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


# K7's widths: K1's and K4's (2 heads a group at D = 96 and 64, 1 at D = 32)
# and D = 96 in two groups of 3 heads
K7_WIDTHS = WIDTHS + [(96, (2, 8), 6, (1, 4))]


def k7_inputs(dev, batch, width, dtype, unaligned=False, seed=5):
    """q, k, v (B, 16, 64, D) in the io type, one element into their storage
    when `unaligned`, and the rest of grouped_window_attention's arguments."""
    dim, windows, heads, shift = width
    gen = torch.Generator().manual_seed(seed)
    wa = WindowAttention(dim, list(windows), list(shift), heads, (16, 64))
    with torch.no_grad():
        for i in range(len(windows)):
            getattr(wa, f"relative_position_bias_table_{i}").normal_(0, 0.1, generator=gen)
    wa = wa.to(dev)
    size = batch * 16 * 64 * dim
    qkv = [(0.5 * torch.randn(size + 1, generator=gen)).to(dev, dtype) for _ in range(3)]
    q, k, v = ((t[1:] if unaligned else t[:-1]).view(batch, 16, 64, dim) for t in qkv)
    return q, k, v, ([b.detach().to(dtype) for b in wa.biases()], wa.masks(), wa.win, wa.shf, wa.gnum_heads,
                     wa.scale)


def check_k7(q, k, v, args):
    """K7 against its plain version in its io type (float32 to 1e-4, bf16 to
    one bf16 rounding of the largest value), one counted launch."""
    before = GW.grouped_window_attention_counter.launches
    out = GW.grouped_window_attention(q, k, v, *args)
    ref = GW.grouped_window_attention_plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert GW.grouped_window_attention_counter.launches == before + 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (1e-4 if q.dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item())


@pytest.mark.parametrize("batch", [1, 3, 5])
@pytest.mark.parametrize("width", K7_WIDTHS, ids=lambda wd: f"D{wd[0]}g{len(wd[1])}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_window_attention_kernel_batches_and_widths(dev, batch, width, dtype):
    check_k7(*k7_inputs(dev, batch, width, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_window_attention_kernel_unaligned_rows(dev, dtype):
    """q, k, v whose rows are not 16-byte aligned: staged element by element
    into the same shared layout (ldmatrix still reads it in bf16); bias and
    mask tables one element into their storage, which the wrapper copies."""
    q, k, v, args = k7_inputs(dev, 3, K7_WIDTHS[0], dtype, unaligned=True)
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    shifted = lambda ts: [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in ts]
    biases, masks = shifted(args[0]), shifted(args[1])
    assert all(t.data_ptr() % 8 for t in biases + masks)
    check_k7(q, k, v, (biases, masks, *args[2:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_window_attention_kernel_one_launch_reruns_bit_for_bit(dev, dtype):
    """One kernel launch a call for all three groups; two runs agree exactly."""
    q, k, v, args = k7_inputs(dev, 5, K7_WIDTHS[0], dtype)
    names = device_kernels(lambda: GW.grouped_window_attention(q, k, v, *args))
    assert len(names) == 1 and "window_attn_fwd_kernel" in names[0], names
    assert torch.equal(GW.grouped_window_attention(q, k, v, *args), GW.grouped_window_attention(q, k, v, *args))


def mlp_inputs(dev, b, s, hidden):
    gen = torch.Generator().manual_seed(s)
    x = torch.randn(b, s * s, hidden, generator=gen).to(dev)
    dw_w = (torch.randn(hidden, 1, 3, 3, generator=gen) / 3).to(dev)
    pw_w = (torch.randn(hidden, hidden, 1, 1, generator=gen) / hidden**0.5).to(dev)
    dw_b, pw_b = ((0.1 * torch.randn(hidden, generator=gen)).to(dev) for _ in range(2))
    return x, dw_w, dw_b, pw_w, pw_b


@pytest.mark.parametrize("b,s,hidden", [(2, 8, 32), (2, 32, 384), (3, 5, 64)])
def test_mlp_convs_kernel(dev, b, s, hidden):
    """K6 against the cuDNN conv pair of its plain version (TF32 off)."""
    x, dw_w, dw_b, pw_w, pw_b = mlp_inputs(dev, b, s, hidden)
    before = MC.mlp_convs_counter.launches
    out = MC.mlp_convs(x, dw_w, dw_b, pw_w, pw_b)
    ref = MC.mlp_convs_plain(x, dw_w, dw_b, pw_w, pw_b)
    torch.cuda.synchronize()
    assert MC.mlp_convs_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", [5, 8, 16, 32])
@pytest.mark.parametrize("hidden", [32, 96, 384])
def test_mlp_convs_kernel_partial_tiles(dev, b, s, hidden):
    """K6 where its tiles (192 rows of y, 128 positions) are cut: hidden 32
    and 96 leave warpgroups without rows or with half a 64-row block, s = 5,
    8 and 16 leave a tile's positions past the image's end; the stencil's
    zero padding at columns 0 and s - 1."""
    x, dw_w, dw_b, pw_w, pw_b = mlp_inputs(dev, b, s, hidden)
    out = MC.mlp_convs(x, dw_w, dw_b, pw_w, pw_b)
    ref = MC.mlp_convs_plain(x, dw_w, dw_b, pw_w, pw_b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_mlp_convs_kernel_reruns_bit_for_bit(dev):
    """K6 sums in a fixed order: two runs agree exactly."""
    args = mlp_inputs(dev, 3, 32, 384)
    assert torch.equal(MC.mlp_convs(*args), MC.mlp_convs(*args))


@pytest.mark.parametrize("keep", [0.9, 0.5])
def test_dropout_mask_kernel(dev, keep):
    """K9 draws exactly the plain version's masks; the tool's check passes."""
    before = DM.dropout_mask_counter.launches
    got = DM.dropout_mask(99, 3, keep, (2, 4, 8), 2, (16, 64), dev)
    torch.cuda.synchronize()
    assert DM.dropout_mask_counter.launches == before + 1
    want = DM.dropout_mask_plain(99, 3, keep, (2, 4, 8), 2, (16, 64), dev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    r = debug_train_dropout.check(dev, batch=2)
    assert r["fwd_max_abs"] <= 1e-4 and r["grad_max_abs"] <= 1e-4 * r["grad_scale"] + 1e-5


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("keep", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("windows,hw", [((2, 4, 8), (16, 64)), ((2, 4), (8, 16)), ((2, 3, 4), (12, 24))],
                         ids=["flagship", "8x16", "any-window"])
def test_dropout_mask_kernel_batches_and_grids(dev, batch, keep, windows, hw):
    """K9 draws exactly the plain version's masks, one counted launch a call
    (3x3 windows: a lane an element, the next group's mask at a 16-byte
    aligned offset of the one allocation)."""
    before = DM.dropout_mask_counter.launches
    got = DM.dropout_mask(7, batch, keep, windows, 2, hw, dev)
    torch.cuda.synchronize()
    assert DM.dropout_mask_counter.launches == before + 1
    want = DM.dropout_mask_plain(7, batch, keep, windows, 2, hw, dev)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_dropout_mask_kernel_one_launch(dev):
    """One kernel launch a call for every group."""
    names = device_kernels(lambda: DM.dropout_mask(7, 3, 0.9, (2, 4, 8), 2, (16, 64), dev))
    assert len(names) == 1 and "dropout_mask_kernel" in names[0], names


def test_new_kernels_reject_what_they_do_not_take(dev):
    x = torch.randn(4, 16, 8, device=dev)
    bias = torch.zeros(4, 16, 16, device=dev)
    with pytest.raises(ValueError):
        WTA.window_tile_attention(x.double(), x.double(), x.double(), bias.double())
    with pytest.raises(ValueError):
        y = torch.randn(4, 80, 8, device=dev)  # N > 64
        WTA.window_tile_attention(y, y, y, torch.zeros(4, 80, 80, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        WTA.window_tile_attention(x.requires_grad_(), x, x, bias)
    h = torch.randn(2, 64, 48, device=dev)  # hidden not a multiple of 32
    with pytest.raises(ValueError):
        MC.mlp_convs(h, torch.zeros(48, 1, 3, 3, device=dev), torch.zeros(48, device=dev),
                     torch.zeros(48, 48, 1, 1, device=dev), torch.zeros(48, device=dev))
    wa = WindowAttention(96, [2, 4, 8], [0, 0, 0], 6, (16, 64)).to(dev)
    q = torch.randn(2, 16, 64, 96, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        GW.grouped_window_attention(q, q, q, [b.detach().half() for b in wa.biases()], wa.masks(), wa.win, wa.shf,
                                    wa.gnum_heads, wa.scale)
    qf = q.float()
    with pytest.raises(ValueError):  # float32 q with bf16 biases
        GW.grouped_window_attention(qf, qf, qf, [b.detach().bfloat16() for b in wa.biases()], wa.masks(), wa.win,
                                    wa.shf, wa.gnum_heads, wa.scale)


@pytest.mark.parametrize("kind", ["aster", "moran", "crnn"])
def test_judge_on_the_card_matches_the_cpu(dev, kind):
    """Each judge on the card against the same seeded judge on the CPU on 2
    images: the words equal (ASTER: its beam ids too); none of the port's
    kernels is launched."""
    from dpmn_tpu_torch.evaluator import build_evaluator

    images = torch.rand(2, 16, 64, 3, generator=torch.Generator().manual_seed(3))
    images = torch.nn.functional.interpolate(images.permute(0, 3, 1, 2), (32, 128), mode="bicubic")
    images = images.clamp(0, 1).permute(0, 2, 3, 1).contiguous()
    card, cpu = build_evaluator(kind, device=dev, seed=4), build_evaluator(kind, device="cpu", seed=4)
    before = (window_attention_counter.launches, gru_bidir_counter.launches, gru_scan_counter.launches)
    assert card.predict(images.to(dev)) == cpu.predict(images)
    if kind == "aster":
        assert (card.predict_ids(images) == cpu.predict_ids(images)).all()
    assert (window_attention_counter.launches, gru_bidir_counter.launches, gru_scan_counter.launches) == before


def test_prefetch_to_the_card(dev):
    """The prefetch's pinned copies on its side stream: every batch arrives on
    the card equal to its host arrays while the consumer's stream works on
    the previous one and frees it; entries without a shape pass through; an
    exception in the producer is raised in the consumer."""
    import numpy as np

    from dpmn_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.RandomState(0)
    batches = [(rng.rand(64, 32, 128, 4).astype(np.float32), None, ["w", str(i)]) for i in range(8)]
    got = []
    for i, (x, none, words) in enumerate(prefetch_to_device(iter(batches), size=2, device=dev)):
        assert x.device.type == "cuda" and none is None and words == ["w", str(i)]
        y = torch.empty_like(x).copy_(x) * 2.0  # consumer-stream work that allocates and frees
        got.append(y.double().sum().item() / 2.0)
        del x, y
    np.testing.assert_allclose(got, [b[0].astype(np.float64).sum() for b in batches], rtol=1e-9)

    def failing():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        for _ in prefetch_to_device(failing(), size=2, device=dev):
            pass


@pytest.mark.parametrize("mask", [True, False], ids=["mask", "rgb"])
@pytest.mark.parametrize("arch", ["tsrn", "tpgsr", "tbsrn"])
def test_psn_on_the_card_matches_the_cpu(dev, arch, mask):
    """TSRN, TSRN_TL and TBSRN (srb 2, hd_u 32, B = 3) on the card against
    the same seeded module on the CPU, max abs 1e-4; two K2 launches an SRB
    for the GRU PSNs, none for TBSRN."""
    from dpmn_tpu_torch.models.tbsrn import TBSRN
    from dpmn_tpu_torch.models.tsrn import TSRN, TSRN_TL

    cls = {"tsrn": TSRN, "tpgsr": TSRN_TL, "tbsrn": TBSRN}[arch]
    cpu = cls(srb_nums=2, mask=mask, hidden_units=32).eval()
    init_weights(cpu, seed=5)
    card = cls(srb_nums=2, mask=mask, hidden_units=32).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(3, 4 if mask else 3, 16, 64, generator=gen)
    prior = (torch.softmax(torch.randn(3, 37, 1, 26, generator=gen), dim=1),) if arch == "tpgsr" else ()
    before = gru_bidir_counter.launches
    with torch.no_grad():
        out = card(x.to(dev), *(p.to(dev) for p in prior)).cpu()
        ref = cpu(x, *prior)
    assert gru_bidir_counter.launches - before == (0 if arch == "tbsrn" else 4)
    assert out.shape == (3, 4 if mask else 3, 32, 128)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("kind", ["tatt", "tbsrn", "pgrm", "visionlan", "cmm"])
def test_reference_checkpoint_round_trip_on_the_card(dev, kind):
    """A module written in the reference's layout (convert._reference_state_dict,
    dead keys included) and read into a module on the card: every tensor
    equal to the source's, and the forward within 1e-4 of the source's on
    the CPU."""
    from dpmn_tpu_torch import convert
    from dpmn_tpu_torch.models.cmm import CMM
    from dpmn_tpu_torch.models.pgrm import PGRM
    from dpmn_tpu_torch.models.tatt import TSRN_TL_TRANS
    from dpmn_tpu_torch.models.tbsrn import TBSRN
    from dpmn_tpu_torch.models.visionlan import VisionLAN

    make = {"tatt": lambda: TSRN_TL_TRANS(srb_nums=1), "tbsrn": lambda: TBSRN(srb_nums=1, mask=True),
            "pgrm": lambda: PGRM(embed_dim=96, patch_size=2, window_size=(2, 4, 8), graphic_mode=True),
            "visionlan": VisionLAN, "cmm": CMM}[kind]
    src, card = make().eval(), make().eval()
    init_weights(src, seed=7)
    init_weights(card, seed=8)
    card = card.to(dev)
    convert.load_reference(card, convert._reference_state_dict(src), kind)
    mine = card.state_dict()
    for k, v in src.state_dict().items():
        assert k.endswith("num_batches_tracked") or torch.equal(v, mine[k].cpu()), k
    gen = torch.Generator().manual_seed(9)
    inputs = {"tatt": lambda: (torch.rand(2, 4, 16, 64, generator=gen),
                               torch.softmax(torch.randn(2, 37, 1, 26, generator=gen), dim=1)),
              "tbsrn": lambda: (torch.rand(2, 4, 16, 64, generator=gen),),
              "pgrm": lambda: (torch.rand(2, 2, 32, 128, generator=gen), torch.rand(2, 3, 32, 128, generator=gen)),
              "visionlan": lambda: (torch.rand(2, 3, 64, 256, generator=gen),),
              "cmm": lambda: (torch.rand(2, 3, 32, 128, generator=gen),
                              torch.rand(2, 3, 32, 128, generator=gen))}[kind]()
    with torch.no_grad():
        ref, out = src(*inputs), card(*(t.to(dev) for t in inputs))
    ref, out = (ref[0], out[0]) if isinstance(ref, tuple) else (ref, out)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4
