"""The dumped attention-dropout masks (kernel K9's plain version) and the
port's counterpart of tools/debug_train_dropout.py, on the CPU.

K9 has no JAX counterpart on the CPU: the TPU kernel it replaces draws from
the TPU's hardware PRNG, which has no interpret mode.  So the masks are held
against what the port's training core applies, two ways: the tool's check
(the dropped forward rebuilt from the dumped masks as explicit factors,
against K4's plain version at keep 0.9: forward to 1e-6, the q-gradient of
sum(tanh(out)) within K3's gradient tolerance, max abs <= 1e-4 max|ref| +
1e-5), and the multipliers `window_attention_core_plain` draws, recorded as
it draws them, equal to `dropout_mask`'s exactly.  The hash chain itself is
held against a numpy uint32 evaluation of it, written here independently of
the port's int64 torch code, exactly."""

import numpy as np
import pytest
import torch

from dpmn_tpu_torch.models.pgrm import _shift_attn_mask
from dpmn_tpu_torch.ops import dropout_mask as DM
from dpmn_tpu_torch.ops import window_attention_train as WT
from dpmn_tpu_torch.tools import debug_train_dropout as tool


def test_tool_check_on_cpu():
    r = tool.check("cpu", batch=2)
    assert abs(r["keep_fraction"] - tool.KEEP) < 0.01
    assert r["fwd_max_abs"] <= 1e-6
    assert r["grad_max_abs"] <= 1e-4 * r["grad_scale"] + 1e-5


def test_masks_are_the_draws_the_core_applies(monkeypatch):
    drawn, multiplier = [], WT.keep_multiplier

    def spy(bits, keep):
        drawn.append(multiplier(bits, keep))
        return drawn[-1]

    monkeypatch.setattr(WT, "keep_multiplier", spy)
    b, (h, w), seed, keep = 2, (16, 32), 1234, 0.8
    q, k, v, biases, _ = tool.inputs(b, "cpu")
    q, k, v = (t[:, :h, :w].reshape(b, h * w, tool.DIM).contiguous() for t in (q, k, v))
    masks = [torch.from_numpy(_shift_attn_mask(h, w, ws, sh)) for ws, sh in zip(tool.WINDOWS, tool.SHIFTS)]
    WT.window_attention_core_plain(q, k, v, biases, masks, seed, keep, tool.WINDOWS, tool.SHIFTS, tool.HEADS,
                                   tool.SCALE, (h, w))
    dumped = DM.dropout_mask(seed, b, keep, tool.WINDOWS, tool.HEADS, (h, w), "cpu")
    assert len(drawn) == len(dumped) == 3
    for got, want in zip(dumped, drawn):  # the core draws (B, nW, heads, N, N)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, want.permute(0, 2, 1, 3, 4))
    assert set(torch.cat([t.reshape(-1) for t in dumped]).unique().tolist()) == {0.0, float(torch.tensor(1 / keep))}
    other = DM.dropout_mask(seed + 1, b, keep, tool.WINDOWS, tool.HEADS, (h, w), "cpu")
    assert not torch.equal(other[2], dumped[2])


def test_tool_main_prints(capsys):
    tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mask keep fraction:" in out and "fwd core vs explicit-mask ref" in out and "grad core vs" in out


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        DM.dropout_mask(0, 1, 0.0, (2,), 2, (4, 4), "cpu")
    with pytest.raises(ValueError):
        DM.dropout_mask(0, 1, 0.9, (3,), 2, (4, 4), "cpu")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DM.dropout_mask(0, 1, 0.9, (2,), 2, (4, 4))


def _fmix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _numpy_masks(seed, batch, keep, windows, heads, hw_shape):
    """The masks by the chain seed -> image -> group -> head -> window ->
    query -> key of fmix32(h ^ (v + 0x9e3779b9)) in uint32 arithmetic, (B,
    heads, nW, N, N) per group: 1/keep where the low 31 bits are below
    min(keep * 2^31, 2^31 - 1), else 0."""
    h, w = hw_shape
    thresh = min(int(keep * 2.0**31), 2**31 - 1)
    step = lambda key, v: _fmix32(key ^ (np.asarray(v, np.uint32) + np.uint32(0x9E3779B9)))
    out = []
    for g, ws in enumerate(windows):
        n, nw = ws * ws, (h // ws) * (w // ws)
        ax = lambda k, i: np.arange(k, dtype=np.uint32).reshape([k if d == i else 1 for d in range(5)])
        key = step(np.full((1,) * 5, seed, np.uint32), ax(batch, 0))
        key = step(step(step(step(step(key, g), ax(heads, 1)), ax(nw, 2)), ax(n, 3)), ax(n, 4))
        out.append(np.where((key & np.uint32(0x7FFFFFFF)) < thresh, np.float32(1 / keep), np.float32(0)))
    return out


@pytest.mark.parametrize("keep", [0.7, 1.0])
def test_plain_masks_match_a_numpy_uint32_chain(keep):
    """dropout_mask_plain (the port's int64 torch chain) equals the numpy
    uint32 chain exactly: B = 3, windows (2, 4) on an 8x16 grid."""
    args = (2024, 3, keep, (2, 4), 2, (8, 16))
    got = DM.dropout_mask_plain(*args)
    want = _numpy_masks(*args)
    assert [tuple(t.shape) for t in got] == [m.shape for m in want] == [(3, 2, 32, 4, 4), (3, 2, 8, 16, 16)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    kept = sum(int((m > 0).sum()) for m in want) / sum(m.size for m in want)
    assert (kept == 1.0) if keep == 1.0 else abs(kept - keep) < 0.02
