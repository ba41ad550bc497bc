"""The eval attention on projected q, k, v (kernel K7's plain version) against
the JAX package's fused_grouped_window_attention in interpret mode.

Geometry: B = 2, a 16x32 grid, dim 96, windows 2/4/8, 6 heads (2 of 16 per
group), both shift sets.  The relative biases come from a numpy seed into the
flax WindowAttention's tree, reach the port's WindowAttention through
`weights.module_from_jax`, and go to both sides as its `.biases()`; the shift
masks are each package's own.  float32: rtol 1e-4, atol 1e-5.  bf16 (q, k, v
and the biases in bf16, every sum in float32, the result rounded once):
max abs <= 2^-7 max|out|, one bf16 rounding of the largest value, since the
two packages may round a value that lies near a rounding boundary to
neighbouring bf16 values."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as jax_pgrm
from dpmn_tpu.ops.pallas_window import fused_grouped_window_attention
from dpmn_tpu_torch.models.pgrm import WindowAttention
from dpmn_tpu_torch.ops import grouped_window_attention as GW
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables

B, H, W, DIM, HEADS = 2, 16, 32, 96, 6
WINDOWS = (2, 4, 8)
SHIFTS = [(0, 0, 0), (1, 2, 4)]


def _case(shift):
    rng = np.random.RandomState(sum(shift))
    x = rng.randn(B, H, W, DIM).astype(np.float32)
    jm = jax_pgrm.WindowAttention(dim=DIM, window_size=WINDOWS, shift_size=shift, num_heads=HEADS,
                                  input_resolution=(H, W))
    variables = init_variables(jm, 3, jnp.asarray(x), jnp.asarray(x))
    port = WindowAttention(DIM, list(WINDOWS), list(shift), HEADS, (H, W))
    module_from_jax(port, variables)
    qkv = [(rng.randn(B, H, W, DIM) * 0.5).astype(np.float32) for _ in range(3)]
    biases = [b.detach().numpy() for b in port.biases()]
    jax_masks = [jnp.asarray(jax_pgrm._shift_attn_mask(H, W, ws, sh)) if sh > 0 else None
                 for ws, sh in zip(WINDOWS, shift)]
    return port, qkv, biases, jax_masks


def _run_jax(qkv, biases, masks, shift, dtype):
    out = fused_grouped_window_attention(*[jnp.asarray(t, dtype) for t in qkv], [jnp.asarray(b, dtype) for b in biases],
                                         masks, WINDOWS, shift, HEADS // 3, 16**-0.5, interpret=True)
    assert out.dtype == dtype
    return np.asarray(out.astype(jnp.float32))


def _run_port(port, qkv, biases, shift, dtype):
    before = GW.grouped_window_attention_counter.launches
    out = GW.grouped_window_attention(*[torch.from_numpy(t).to(dtype) for t in qkv],
                                      [torch.from_numpy(b).to(dtype) for b in biases], port.masks(), port.win,
                                      port.shf, port.gnum_heads, port.scale)
    assert GW.grouped_window_attention_counter.launches == before  # a CPU tensor runs the plain version
    assert out.dtype == dtype and out.shape == (B, H, W, DIM)
    return out.float().numpy()


@pytest.mark.parametrize("shift", SHIFTS)
def test_plain_matches_jax_kernel_float32(shift):
    port, qkv, biases, masks = _case(shift)
    np.testing.assert_allclose(_run_port(port, qkv, biases, shift, torch.float32),
                               _run_jax(qkv, biases, masks, shift, jnp.float32), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shift", SHIFTS)
def test_plain_matches_jax_kernel_bfloat16(shift):
    """bf16 io on both sides; the inputs are the float32 case's rounded to
    bf16 (ml_dtypes and torch both round to nearest even)."""
    port, qkv, biases, masks = _case(shift)
    ref = _run_jax(qkv, biases, masks, shift, jnp.bfloat16)
    out = _run_port(port, qkv, biases, shift, torch.bfloat16)
    for a in qkv + biases:  # the two packages start from the same bf16 values
        np.testing.assert_array_equal(torch.from_numpy(a).to(torch.bfloat16).float().numpy(),
                                      a.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert np.abs(out - ref).max() <= 2.0**-7 * np.abs(ref).max()
