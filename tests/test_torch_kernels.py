"""The kernel build and launch helpers of dpmn_tpu_torch.ops.kernels, on the
CPU: the build key covers every header a source may include, kernels
without a backward refuse autograd, the launch-side tensor check refuses
a tensor that is not on the card, and the attention-forward ablations of
tools/attention_groups.py still find their text in the sources."""

import pytest
import torch

from dpmn_tpu_torch.ops import kernels


def test_build_key_covers_the_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = kernels._target("k")
    assert first == kernels._target("k") and first.parent == tmp_path / "_build"
    assert first.name.startswith("k-") and first.suffix == ".so"
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = kernels._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = kernels._target("k")
    assert third != second
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert kernels._target("k") != third


def test_every_source_has_a_key():
    names = {kernels._target(name).name for name in kernels.SOURCES}
    assert len(names) == len(kernels.SOURCES) == 9
    for name in ("window_attention_train", "window_attention_core", "window_attention_full", "mlp_convs",
                 "grouped_window_attention", "window_tile_attention", "dropout_mask"):
        assert name in kernels.SOURCES


def test_refuse_autograd():
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_autograd("k", (x, w))
    kernels.refuse_autograd("k", (x, None))  # nothing needs a gradient
    with torch.no_grad():
        kernels.refuse_autograd("k", (x, w))
    with torch.inference_mode():
        kernels.refuse_autograd("k", (x,))


def test_check_cuda_tensor_refuses_other_devices():
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="expected a tensor on cuda"):
            kernels.check_cuda_tensor("x", torch.zeros(2, dtype=dtype), (2,), dtype=dtype)


def test_attention_ablations_find_their_source_text():
    """Each variant of tools/attention_groups.py takes out text that occurs
    exactly once in the current kernel sources."""
    from dpmn_tpu_torch.tools import attention_groups

    for variant, edits in attention_groups.ABLATIONS.items():
        for name, text, _ in edits:
            assert (kernels.CSRC / name).read_text().count(text) == 1, (variant, name)
