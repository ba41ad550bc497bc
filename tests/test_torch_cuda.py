"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch sees no card.  On the machine with
the card (which has no JAX, so the repository's conftest is skipped):

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
# H of the cooperative regime
GRU_SHAPES = [(300, 16, 32), (1024, 64, 32), (64, 64, 512), (600, 3, 512), (40, 9, 64), (64, 5, 128)]


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
    with pytest.raises(ValueError):
        gru_scan(torch.randn(4, 6, 30, device=dev), torch.randn(30, 10, device=dev), torch.randn(30, device=dev))
    with pytest.raises(ValueError):
        gru_bidir(x.double(), x.double(), w.double(), w.double(), b.double(), b.double())
    with pytest.raises(ValueError):
        gru_bidir(x, x, w, w.T.contiguous().T, b, b)  # not contiguous
    with pytest.raises(ValueError):
        gru_bidir(x, x[:, :, :].transpose(0, 1).contiguous().transpose(0, 1), w, w, b, b)  # other strides
    with pytest.raises(ValueError):
        x30 = torch.randn(4, 6, 30, device=dev)
        w30 = torch.randn(30, 10, device=dev)
        gru_bidir(x30, x30, w30, w30, torch.randn(30, device=dev), torch.randn(30, device=dev))
    blk = SwinTransformerBlock(96, (16, 64), 6, [2, 4, 8], [0, 0, 0]).to(dev)
    kw = blk.attn.block_args(blk.ln_params())
    with pytest.raises(ValueError):
        window_attention_block(torch.randn(2, 1000, 96, device=dev), torch.randn(2, 1000, 96, device=dev), **kw)
    x = torch.randn(2, 1024, 96, device=dev)
    for heads in (3, 12):  # head dims 32 and 8
        blk = SwinTransformerBlock(96, (16, 64), heads, [2, 4, 8], [0, 0, 0]).to(dev)
        with pytest.raises(ValueError):
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


def test_window_kernels_reject_other_widths(dev):
    """D = 128 (beyond the kernels' 96) raises in K1 and K3."""
    xq, xkv, kw = k1_inputs(dev, 1, 128, (2, 4, 8, 4), 8, (0, 0, 0, 0))
    with pytest.raises(ValueError), torch.no_grad():
        window_attention_block(xq, xkv, **kw)
    prim, biases, static = train_core_inputs(dev, (0, 0, 0, 0), 1, dim=128, windows=(2, 4, 8, 4), heads=8)
    with pytest.raises(ValueError):
        WT.window_attention_block_core(*prim[:10], biases, static["masks"], 0, 1.0, static["window_sizes"],
                                       static["shifts"], static["gnum_heads"], static["scale"], static["hw_shape"])


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
