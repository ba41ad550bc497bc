"""The dumped attention-dropout masks (kernel K9's plain version) and the
port's counterpart of tools/debug_train_dropout.py, on the CPU.

K9 has no JAX counterpart on the CPU: the TPU kernel it replaces draws from
the TPU's hardware PRNG, which has no interpret mode.  So the masks are held
against what the port's training core applies, two ways: the tool's check
(the dropped forward rebuilt from the dumped masks as explicit factors,
against K4's plain version at keep 0.9: forward to 1e-6, the q-gradient of
sum(tanh(out)) within K3's gradient tolerance, max abs <= 1e-4 max|ref| +
1e-5), and the multipliers `window_attention_core_plain` draws, recorded as
it draws them, equal to `dropout_mask`'s exactly."""

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
