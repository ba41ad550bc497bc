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
from dpmn_tpu_torch.ops.gru import gru_scan, gru_scan_counter, gru_scan_plain
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
    """Random pre-norm tokens, LN, projection, SKConv and relative-bias
    parameters of one flagship block (16x64 grid, dim 96, windows 2/4/8, 6
    heads), leaves that require grad (the 18 primals of K5, whose first 10
    are K3's), and the core's static arguments."""
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
    cot = torch.randn(2, 1024, 96, generator=torch.Generator().manual_seed(9)).to(prim[0].device)
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


@pytest.mark.parametrize("wnc", [(10, 16, 8), (300, 4, 16), (96, 16, 16), (40, 64, 16), (7, 64, 64), (33, 9, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_tile_attention_kernel(dev, wnc, masked):
    """K8 against its plain version: ragged block ends, every window size of
    the flagship, the largest N and C it takes, and odd ones."""
    w, n, c = wnc
    gen = torch.Generator().manual_seed(w + n)
    q, k, v = ((0.5 * torch.randn(w, n, c, generator=gen)).to(dev) for _ in range(3))
    bias = (0.1 * torch.randn(w, n, n, generator=gen)).to(dev)
    mask = torch.where(torch.rand(w, n, n, generator=gen) < 0.3, -100.0, 0.0).to(dev) if masked else None
    before = WTA.window_tile_attention_counter.launches
    out = WTA.window_tile_attention(q, k, v, bias, mask)
    ref = WTA.window_tile_attention_plain(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert WTA.window_tile_attention_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("b,s,hidden", [(2, 8, 32), (2, 32, 384), (3, 5, 64)])
def test_mlp_convs_kernel(dev, b, s, hidden):
    """K6 against the cuDNN conv pair of its plain version (TF32 off)."""
    gen = torch.Generator().manual_seed(s)
    x = torch.randn(b, s * s, hidden, generator=gen).to(dev)
    dw_w = (torch.randn(hidden, 1, 3, 3, generator=gen) / 3).to(dev)
    pw_w = (torch.randn(hidden, hidden, 1, 1, generator=gen) / hidden**0.5).to(dev)
    dw_b, pw_b = ((0.1 * torch.randn(hidden, generator=gen)).to(dev) for _ in range(2))
    before = MC.mlp_convs_counter.launches
    out = MC.mlp_convs(x, dw_w, dw_b, pw_w, pw_b)
    ref = MC.mlp_convs_plain(x, dw_w, dw_b, pw_w, pw_b)
    torch.cuda.synchronize()
    assert MC.mlp_convs_counter.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


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
