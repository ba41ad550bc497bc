"""sr_forward_bf16, the bf16 serving forward, in both glyph modes against the
JAX package's sr_forward_bf16 and against the port's float32 forward, at
test_torch_system.py's SMALL geometry on the same numpy-seeded weights:
float32 out, finite, mean abs < 0.05 (tests/test_prefetch_bf16.py:19-60).
The JAX side runs un-jitted on its own bf16 state (DPMNSystem.bf16_state)."""

import numpy as np
import pytest
import torch

from test_torch_serving import _jax_forward, _port_forward
from test_torch_system import SMALL, _lr, _pair


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


@pytest.mark.parametrize("glyph_from_psn", [False, True])
def test_sr_forward_bf16_tracks_jax_and_float32(small, glyph_from_psn):
    jsys, state, psys = small
    lr = _lr(7)
    ref16, _ = _jax_forward(jsys, state, lr, glyph_from_psn, bf16=True)
    out16, _ = _port_forward(psys, lr, glyph_from_psn, bf16=True)
    out32, _ = _port_forward(psys, lr, glyph_from_psn)
    assert out16.dtype == np.float32 and out16.shape == (2, 32, 128, 3)
    assert np.isfinite(out16).all()
    assert np.abs(out16 - ref16).mean() < 0.05
    assert np.abs(out16 - out32).mean() < 0.05
    assert psys.glyph.table.dtype == torch.float32  # the atlas tables stay float32
