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


def test_training_attention_ablations_find_their_source_text():
    """Each --train variant of tools/attention_groups.py (those of
    window_attn_fwd_train_kernel) and each --block variant (those of
    window_block_fwd_bf16_kernel) takes out text that occurs exactly once
    in the current kernel sources, and the trimmed K4 library keeps its
    forwards and the launch count alone."""
    import re

    from dpmn_tpu_torch.tools import attention_groups

    for mode, variants in (("train", attention_groups.TRAIN_ABLATIONS), ("block", attention_groups.BLOCK_ABLATIONS)):
        for variant, edits in variants.items():
            for name, text, _ in edits:
                assert (kernels.CSRC / name).read_text().count(text) == 1, (mode, variant, name)
    source = (kernels.CSRC / f"{attention_groups.TRAIN_LIB}.cu").read_text()
    kept = re.findall(r'extern "C" [^(]*?(\w+)\(', attention_groups.trim_to_forward(source))
    assert kept == ["window_attention_core_forward", "window_attention_core_forward_bf16",
                    "window_attention_core_kernel_launches"]


@pytest.mark.parametrize("shifts", [(0, 0, 0), (1, 0, 4), (1, 2, 4)])
def test_table_pointers_are_the_tables_as_they_are(shifts):
    """The bf16 forwards' per-group tables: each group's bias pointer, its
    mask pointer where the group is shifted and null where not (the kernels
    read an unshifted group's mask never), its window and shift, in group
    order; no table is copied.  On the CPU the launch-side check refuses
    them."""
    import ctypes

    from dpmn_tpu_torch.ops import window_attention_train as WT

    windows, hw, heads = (2, 4, 8), (16, 64), 2
    biases = [torch.randn(heads, ws * ws, ws * ws) for ws in windows]
    masks = [torch.randn((hw[0] // ws) * (hw[1] // ws), ws * ws, ws * ws) if sh else None
             for ws, sh in zip(windows, shifts)]
    st = WT.make_static(masks, 0, 1.0, windows, shifts, heads, 0.25, hw)
    bias_arr, mask_arr, ws_arr, sh_arr = WT.table_pointers(st, biases)
    assert all(isinstance(a, ctypes.Array) and len(a) == 3 for a in (bias_arr, mask_arr, ws_arr, sh_arr))
    assert list(bias_arr) == [b.data_ptr() for b in biases]
    assert list(mask_arr) == [m.data_ptr() if sh else None for m, sh in zip(masks, shifts)]
    assert list(ws_arr) == list(windows) and list(sh_arr) == list(shifts)
    with pytest.raises(ValueError, match="bias 0: expected a tensor on cuda"):
        WT.group_tables(st, biases, torch.device("cuda:0"))


def test_hash_step_in_two_parts_draws_the_same_bits():
    """The training forward's dropout draw hash_step(h, j) =
    fmix32(h ^ (j + 0x9e3779b9)) taken as hash_step_row(hash_row(h), j)
    (csrc/window_common.cuh): fmix32's first step distributes over the xor
    and (j + 0x9e3779b9) >> 16 = 0x9e37 for 0 <= j < 2^15, so every key draws
    the same bits."""
    import numpy as np

    def fmix32(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))

    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**32, size=(4096, 1), dtype=np.uint64).astype(np.uint32)
    j = np.concatenate([np.arange(64), rng.integers(64, 2**15, 64), [2**15 - 1]]).astype(np.uint32)[None, :]
    with np.errstate(over="ignore"):
        v = j + np.uint32(0x9E3779B9)
        whole = fmix32(h ^ v)
        hr = h ^ (h >> np.uint32(16)) ^ np.uint32(0x9E37)
        x = (hr ^ v) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        parts = x ^ (x >> np.uint32(16))
    assert whole.dtype == parts.dtype == np.uint32
    assert np.array_equal(whole, parts)
