"""The port's window-attention block (plain version of the CUDA kernel) against
the JAX package: the Pallas kernel fused_window_attention_block in interpret
mode, and the XLA SwinTransformerBlock path.  B = 2, the 16x64 token grid at
dim 96, windows 2/4/8 with 6 heads; tolerance rtol=1e-4, atol=1e-5, as in
tests/test_pallas_window.py (float32, other summation orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.models.pgrm as P
import dpmn_tpu.ops.pallas_window as PW
from dpmn_tpu_torch.models import pgrm as TP
from dpmn_tpu_torch.ops.window_attention import (
    window_attention_block,
    window_attention_block_plain,
    window_attention_counter,
)
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables

B, H, W, C = 2, 16, 64, 96
WIN = (2, 4, 8)
SHIFTS = [(0, 0, 0), (1, 2, 4)]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(B, H * W, C).astype(np.float32), rng.rand(B, H * W, C).astype(np.float32)


def test_static_tables_match():
    for ws in WIN:
        np.testing.assert_array_equal(TP._relative_position_index(ws), P._relative_position_index(ws))
        for sh in (ws // 2,):
            np.testing.assert_array_equal(TP._shift_attn_mask(H, W, ws, sh), P._shift_attn_mask(H, W, ws, sh))


def _check_against_pallas(b, h, w, c, heads, win, shift, layout, with_ln):
    """The plain block (through its dispatching wrapper) against the Pallas
    kernel in interpret mode on one geometry: b images on an h x w grid at
    dim c, `heads` heads over the windows `win`."""
    rng = np.random.RandomState(11)
    xr = np.random.RandomState(3)
    xq, xkv = (xr.rand(b, h * w, c).astype(np.float32) for _ in range(2))
    gh, ch = heads // len(win), c // len(win)
    dz, scale = max(c // 6, 1), (ch // gh) ** -0.5
    sk = {"proj": (c, c), "fc1": (c, dz), "fc2": (dz, c), "ph": (ch, c)}
    jw = {"q_kernel": rng.randn(c, c) / np.sqrt(c), "kv_kernel": rng.randn(c, 2 * c) / np.sqrt(c)}
    jw["q_bias"], jw["kv_bias"] = 0.1 * rng.randn(c), 0.1 * rng.randn(2 * c)
    for name, shape in sk.items():
        jw[f"{name}_kernel"] = rng.randn(*shape) / np.sqrt(shape[0])
        jw[f"{name}_bias"] = 0.1 * rng.randn(shape[1])
    jw = {k: np.asarray(v, np.float32) for k, v in jw.items()}
    ln = {k: np.asarray((1.0 if k.endswith("s") else 0.0) + 0.1 * rng.randn(c), np.float32)
          for k in ("qs", "qb", "ks", "kb")} if with_ln else None
    biases, masks = [], []
    for ws, sh in zip(win, shift):
        n = ws * ws
        table = np.asarray(0.1 * rng.randn((2 * ws - 1) ** 2, gh), np.float32)
        biases.append(table[P._relative_position_index(ws).reshape(-1)].reshape(n, n, gh).transpose(2, 0, 1))
        masks.append(P._shift_attn_mask(h, w, ws, sh) if sh > 0 else None)

    ref = PW.fused_window_attention_block(
        jnp.asarray(xq), jnp.asarray(xkv), {k: jnp.asarray(v) for k, v in jw.items()},
        [jnp.asarray(bb) for bb in biases], [None if m is None else jnp.asarray(m) for m in masks],
        win, shift, gh, scale, (h, w),
        ln_params=None if ln is None else {k: jnp.asarray(v) for k, v in ln.items()},
        layout=layout, interpret=True,
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    weights = {"q_w": t(jw["q_kernel"].T), "q_b": t(jw["q_bias"]), "kv_w": t(jw["kv_kernel"].T),
               "kv_b": t(jw["kv_bias"]), "proj_w": t(jw["proj_kernel"].T), "proj_b": t(jw["proj_bias"]),
               "fc1_w": t(jw["fc1_kernel"].T), "fc1_b": t(jw["fc1_bias"]), "fc2_w": t(jw["fc2_kernel"].T),
               "fc2_b": t(jw["fc2_bias"]), "ph_w": t(jw["ph_kernel"].T), "ph_b": t(jw["ph_bias"])}
    before = window_attention_counter.launches
    out = window_attention_block(
        t(xq), t(xkv), weights, [t(bb) for bb in biases], [None if m is None else t(m) for m in masks],
        win, shift, gh, scale, (h, w), ln=None if ln is None else {k: t(v) for k, v in ln.items()},
        layout=layout,
    )
    assert window_attention_counter.launches == before  # a CPU tensor never launches the kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("layout", ["faithful", "corrected"])
@pytest.mark.parametrize("with_ln", [True, False])
def test_plain_matches_pallas_interpret(shift, layout, with_ln):
    _check_against_pallas(B, H, W, C, 6, WIN, shift, layout, with_ln)


# head dim 32 (3 heads over 3 windows at dim 96) and dim 16 (2 heads over
# windows 2 / 4: channel 8, head dim 8), on an 8x16 grid, one image
@pytest.mark.parametrize("c,heads,win", [(96, 3, (2, 4, 8)), (16, 2, (2, 4))], ids=["hd32", "d16"])
def test_plain_matches_pallas_interpret_other_geometries(c, heads, win):
    _check_against_pallas(1, 8, 16, c, heads, win, (1, 2, 4)[:len(win)], "faithful", True)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("faithful", [True, False])
def test_swin_block_matches_xla(shift, faithful):
    """The port's SwinTransformerBlock — the block call with the fused norm1_q /
    norm1_kv and residual, then norm2 and the Mlp — against the JAX module's
    XLA path (the Pallas path is off on the CPU)."""
    xq, xkv = _inputs(5)
    blk = P.SwinTransformerBlock(dim=C, input_resolution=(H, W), num_heads=6, window_size=list(WIN),
                                 shift_size=list(shift), faithful=faithful)
    variables = init_variables(blk, 7, jnp.asarray(xq), jnp.asarray(xkv))
    ref_q, ref_kv = blk.apply(variables, jnp.asarray(xq), jnp.asarray(xkv))

    port = TP.SwinTransformerBlock(C, (H, W), 6, list(WIN), list(shift), faithful=faithful).eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out_q, out_kv = port(torch.from_numpy(xq), torch.from_numpy(xkv))
    np.testing.assert_array_equal(out_q.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(out_kv.numpy(), np.asarray(ref_kv), rtol=1e-4, atol=1e-5)


def test_block_plain_and_wrapper_agree_on_cpu():
    """On the CPU the wrapper is exactly the plain version."""
    xq, xkv = _inputs(9)
    blk = TP.SwinTransformerBlock(C, (H, W), 6, list(WIN), [1, 2, 4])
    kw = blk.attn.block_args(blk.ln_params())
    with torch.no_grad():
        a = window_attention_block(torch.from_numpy(xq), torch.from_numpy(xkv), **kw)
        b = window_attention_block_plain(torch.from_numpy(xq), torch.from_numpy(xkv), **kw)
    assert torch.equal(a, b)
