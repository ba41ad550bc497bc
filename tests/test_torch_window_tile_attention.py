"""Per-window attention tiles (kernel K8's plain version) against the JAX
package's pallas_window_attention in interpret mode.

Shapes: the JAX test's (W, N, C) = (10, 16, 8) without a mask
(tests/test_pallas_kernels.py), and a folded shifted group with its mask —
B = 2 images of an 8x16 grid, windows of 4 (nW = 8) shifted by 2, 2 heads of
16 channels: (32, 16, 16), the shift mask repeated per image and head.  The
JAX side pads W to its tile of windows (tile_w 4 and 12 here, so both pad);
the port has no tile.  Tolerances rtol 1e-4, atol 1e-5, the JAX test's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.models.pgrm import _shift_attn_mask
from dpmn_tpu.ops.pallas_kernels import pallas_window_attention
from dpmn_tpu_torch.ops import window_tile_attention as WTA


def _unmasked():
    rng = np.random.RandomState(2)
    w, n, c = 10, 16, 8
    q, k, v = (rng.randn(w, n, c).astype(np.float32) * 0.5 for _ in range(3))
    return q, k, v, rng.randn(w, n, n).astype(np.float32) * 0.1, None, 4


def _masked():
    rng = np.random.RandomState(3)
    b, heads, c = 2, 2, 16
    mask = _shift_attn_mask(8, 16, 4, 2)  # (nW, N, N)
    nw, n = mask.shape[:2]
    w = b * nw * heads
    q = rng.randn(w, n, c).astype(np.float32) * 0.25  # pre-scaled
    k, v = (rng.randn(w, n, c).astype(np.float32) for _ in range(2))
    bias = np.broadcast_to((rng.randn(heads, n, n) * 0.1)[None, None], (b, nw, heads, n, n))
    masks = np.broadcast_to(mask[None, :, None], (b, nw, heads, n, n))
    return (q, k, v, np.ascontiguousarray(bias.reshape(w, n, n), np.float32),
            np.ascontiguousarray(masks.reshape(w, n, n), np.float32), 12)


@pytest.mark.parametrize("make", [_unmasked, _masked], ids=["jax_test_shape", "shifted_group"])
def test_plain_matches_jax_kernel(make):
    q, k, v, bias, mask, tile_w = make()
    ref = pallas_window_attention(*(jnp.asarray(t) for t in (q, k, v, bias)),
                                  None if mask is None else jnp.asarray(mask), tile_w=tile_w, interpret=True)
    before = WTA.window_tile_attention_counter.launches
    out = WTA.window_tile_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)),
                                    None if mask is None else torch.from_numpy(mask))
    assert WTA.window_tile_attention_counter.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_mask_none_is_a_zero_mask():
    q, k, v, bias, _, _ = _unmasked()
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    assert torch.equal(WTA.window_tile_attention(*t), WTA.window_tile_attention(*t, torch.zeros_like(t[3])))
