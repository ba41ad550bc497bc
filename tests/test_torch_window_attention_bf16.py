"""The window-attention block K1 on bf16 io: the port's plain version (the
oracle of the card's bf16 kernel) against the JAX package's Pallas kernel
fused_window_attention_block in interpret mode on the same bf16 inputs.
B = 2, the 16x64 token grid at dim 96, windows 2/4/8 with 6 heads, both
shift sets, both layouts, with and without the fused LN and residual.

Both sides compute the LN in float32 and round it to bf16, sum the bf16
projections, the attention and SKConv in float32, and round the output once
to bf16.  Tolerance: max abs <= 2^-7 max|out|, one bf16 rounding of the
largest value (bf16 keeps 8 significant bits), since float32 sums in another
order can put a value on either side of a bf16 rounding boundary, and a flip
of the LN's rounding moves q / kv by one bf16 step of a normalized value."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as P
import dpmn_tpu.ops.pallas_window as PW
from dpmn_tpu_torch.ops.window_attention import window_attention_block, window_attention_counter

B, H, W, C = 2, 16, 64, 96
WIN = (2, 4, 8)
SHIFTS = [(0, 0, 0), (1, 2, 4)]
NAMES = {"q_w": "q", "kv_w": "kv", "proj_w": "proj", "fc1_w": "fc1", "fc2_w": "fc2", "ph_w": "ph"}


def _bf16(a):
    """numpy float32 values rounded to bf16 and back (round to nearest even)."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _case(shift, with_ln, seed=11):
    rng = np.random.RandomState(seed)
    xq, xkv = (_bf16(rng.rand(B, H * W, C)) for _ in range(2))
    shapes = {"q": (C, C), "kv": (C, 2 * C), "proj": (C, C), "fc1": (C, 16), "fc2": (16, C), "ph": (32, C)}
    jw = {}
    for name, shape in shapes.items():
        jw[f"{name}_kernel"] = _bf16(rng.randn(*shape) / np.sqrt(shape[0]))
        jw[f"{name}_bias"] = _bf16(0.1 * rng.randn(shape[1]))
    ln = {k: _bf16((1.0 if k.endswith("s") else 0.0) + 0.1 * rng.randn(C))
          for k in ("qs", "qb", "ks", "kb")} if with_ln else None
    biases, masks = [], []
    for ws, sh in zip(WIN, shift):
        n = ws * ws
        table = _bf16(0.1 * rng.randn((2 * ws - 1) ** 2, 2))
        biases.append(table[P._relative_position_index(ws).reshape(-1)].reshape(n, n, 2).transpose(2, 0, 1))
        masks.append(P._shift_attn_mask(H, W, ws, sh) if sh > 0 else None)
    return xq, xkv, jw, ln, biases, masks


def _jax(case, shift, layout):
    xq, xkv, jw, ln, biases, masks = case
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    out = PW.fused_window_attention_block(
        bf(xq), bf(xkv), {k: bf(v) for k, v in jw.items()}, [bf(b) for b in biases],
        [None if m is None else jnp.asarray(m) for m in masks], WIN, shift, 2, 16**-0.5, (H, W),
        ln_params=None if ln is None else {k: bf(v) for k, v in ln.items()}, layout=layout, interpret=True)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


def _port(case, shift, layout):
    xq, xkv, jw, ln, biases, masks = case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    weights = {}
    for port_name, jax_name in NAMES.items():
        weights[port_name] = t(jw[f"{jax_name}_kernel"].T)
        weights[port_name[:-1] + "b"] = t(jw[f"{jax_name}_bias"])
    before = window_attention_counter.launches
    with torch.no_grad():
        out = window_attention_block(
            t(xq), t(xkv), weights, [t(b) for b in biases],
            [None if m is None else torch.from_numpy(m) for m in masks], WIN, shift, 2, 16**-0.5, (H, W),
            ln=None if ln is None else {k: t(v) for k, v in ln.items()}, layout=layout)
    assert window_attention_counter.launches == before  # a CPU tensor never launches the kernel
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("layout", ["faithful", "corrected"])
@pytest.mark.parametrize("with_ln", [True, False])
def test_bf16_plain_matches_pallas_interpret(shift, layout, with_ln):
    case = _case(shift, with_ln)
    ref = _jax(case, shift, layout)
    out = _port(case, shift, layout)
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 2.0**-7 * np.abs(ref).max()


def test_bf16_plain_tracks_float32():
    """The bf16 block against the float32 block on the same (bf16-valued)
    inputs: within the JAX kernel's own bf16-vs-float32 gap at this geometry
    (0.026 at max|out| 3.65, about 2^-7 of max|out|), taken as 2^-6 of
    max|out| (the LN's and the output's roundings add)."""
    shift = SHIFTS[1]
    case = _case(shift, True, seed=5)
    xq, xkv, jw, ln, biases, masks = case
    out16 = _port(case, shift, "faithful")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    weights = {}
    for port_name, jax_name in NAMES.items():
        weights[port_name] = t(jw[f"{jax_name}_kernel"].T)
        weights[port_name[:-1] + "b"] = t(jw[f"{jax_name}_bias"])
    with torch.no_grad():
        out32 = window_attention_block(t(xq), t(xkv), weights, [t(b) for b in biases],
                                       [None if m is None else t(m) for m in masks], WIN, shift, 2, 16**-0.5,
                                       (H, W), ln={k: t(v) for k, v in ln.items()}).numpy()
    assert np.abs(out16 - out32).max() <= 2.0**-6 * np.abs(out32).max()
