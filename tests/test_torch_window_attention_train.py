"""The port's training window-attention core (kernel K3's plain version and its
autograd Function) against the JAX package's window_attention_block_core in
interpret mode, composed with build_packed_bias under jax.vjp so the bias
gradient arrives per group as (heads, N, N) on both sides.

Geometries: the flagship 16x64 grid at dim 96 with 6 heads, and the 8x32 grid
at dim 48 of tests/test_pallas_train.py (head dim 8, the ws=8 group clamped
to the grid with shift 0); B = 2, both shift sets, both layouts (for
`corrected` the relayout runs after the core on both sides), keep = 1.  On
an 8x16 grid, one image, shifted and faithful only: head dim 32 (dim 96, 3
heads over windows 2 / 4 / 8) and dim 16 (2 heads over windows 2 / 4, head
dim 8).
Tolerances are the JAX package's own for this kernel: output rtol = atol =
2e-5, gradients rtol 2e-3, atol 2e-4 (tests/test_pallas_train.py:173-182).
The dropout hash is checked on its own: determinism, rate, scale, the
threshold rule of the TPU kernel, and exactness against Python integers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.models.pgrm import _corrected_relayout, _relative_position_index, _shift_attn_mask
from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_train as WT

B = 2  # images a case; one at NEW_GEOMETRIES
# (grid h, w, dim, heads, windows)
GEOMETRIES = {"16x64": (16, 64, 96, 6, (2, 4, 8)), "8x32": (8, 32, 48, 6, (2, 4, 8)),
              "8x16-hd32": (8, 16, 96, 3, (2, 4, 8)), "8x16-d16": (8, 16, 16, 2, (2, 4))}
BASE_GEOMETRIES = ("16x64", "8x32")  # every shift set and layout
NEW_GEOMETRIES = ("8x16-hd32", "8x16-d16")  # one shift set, faithful
SHIFTS = [(0, 0, 0), (1, 2, 4)]
GRAD_NAMES = ["xq", "xkv", "qs", "qb", "ks", "kb", "q_w", "q_b", "kv_w", "kv_b"]


def _windows(h, w, shift, windows=(2, 4, 8)):
    """The window / shift after WindowAttention's min-resolution clamp."""
    win, shf = [], []
    for ws, sh in zip(windows, shift):
        clamp = min(h, w) <= ws
        win.append(min(h, w) if clamp else ws)
        shf.append(0 if clamp else sh)
    return win, shf


def _case_inputs(geom, shift, seed=5):
    h, w, c, heads, windows = GEOMETRIES[geom]
    win, shf = _windows(h, w, shift, windows)
    gh = heads // len(win)
    b = 1 if geom in NEW_GEOMETRIES else B
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = {"xq": f32(rng.randn(b, h * w, c) * 0.5), "xkv": f32(rng.randn(b, h * w, c) * 0.5)}
    for k in ("qs", "ks"):
        x[k] = f32(1.0 + 0.1 * rng.randn(c))
    for k in ("qb", "kb"):
        x[k] = f32(0.1 * rng.randn(c))
    x["wq"] = f32(rng.randn(c, c) / np.sqrt(c))
    x["bq"] = f32(0.1 * rng.randn(c))
    x["wkv"] = f32(rng.randn(c, 2 * c) / np.sqrt(c))
    x["bkv"] = f32(0.1 * rng.randn(2 * c))
    biases = []
    for ws in win:
        n = ws * ws
        table = f32(0.1 * rng.randn((2 * ws - 1) ** 2, gh))
        biases.append(np.ascontiguousarray(table[_relative_position_index(ws).reshape(-1)].reshape(n, n, gh)
                                           .transpose(2, 0, 1)))
    masks = [_shift_attn_mask(h, w, ws, sh) if sh > 0 else None for ws, sh in zip(win, shf)]
    cot = f32(rng.randn(b, h * w, c))
    scale = (c // len(win) // gh) ** -0.5
    return dict(x=x, biases=biases, masks=masks, cot=cot, win=win, shf=shf, gh=gh, scale=scale, hw=(h, w))


@functools.lru_cache(maxsize=None)
def _jax_case(geom, shift, layout):
    """JAX output and gradients (torch layouts) of one case, computed once."""
    d = _case_inputs(geom, shift)
    x, h, w = d["x"], *d["hw"]
    c = x["xq"].shape[-1]
    masks = [None if m is None else jnp.asarray(m) for m in d["masks"]]

    def f(xq, xkv, qs, qb, ks, kb, wq, bq, wkv, bkv, *biases):
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        out = PWT.window_attention_block_core(
            xq.reshape(-1, h, w, c), xkv.reshape(-1, h, w, c), qs, qb, ks, kb, wq, bq, wkv, bkv, packed,
            jnp.zeros((1,), jnp.int32), tuple(d["win"]), tuple(d["shf"]), d["gh"], d["scale"], 1.0, (h, w), True)
        if layout == "corrected":
            out = _corrected_relayout(out, d["win"], d["shf"], len(d["win"]))
        return out.reshape(xq.shape[0], h * w, -1)

    args = [jnp.asarray(x[k]) for k in ("xq", "xkv", "qs", "qb", "ks", "kb", "wq", "bq", "wkv", "bkv")]
    out, vjp = jax.vjp(f, *args, *[jnp.asarray(b) for b in d["biases"]])
    g = [np.asarray(t) for t in vjp(jnp.asarray(d["cot"]))]
    g[6], g[8] = g[6].T, g[8].T  # flax kernels (in, out) -> torch (out, in)
    return np.asarray(out), g


def _port_args(d, requires_grad=True):
    x = d["x"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(requires_grad)
    prim = [t(x[k]) for k in ("xq", "xkv", "qs", "qb", "ks", "kb")]
    prim += [t(x["wq"].T), t(x["bq"]), t(x["wkv"].T), t(x["bkv"])]
    biases = [t(b) for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    return prim, biases, masks


def _run_port(d, layout, fn, seed=0, keep=1.0):
    prim, biases, masks = _port_args(d)
    out = fn(*prim, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    if layout == "corrected":
        out = WT.corrected_relayout(out, d["win"], d["shf"], d["hw"])
    grads = torch.autograd.grad(out, prim + biases, torch.from_numpy(d["cot"]))
    return out.detach(), [g.numpy() for g in grads]


def _check_against_jax(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    names = GRAD_NAMES + [f"bias_{i}" for i in range(len(ref_grads) - 10)]
    assert len(grads) == len(ref_grads) == len(names)
    for name, a, b in zip(names, grads, ref_grads):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=name)


CASES = ([(g, s, lay) for g in BASE_GEOMETRIES for s in SHIFTS for lay in ("faithful", "corrected")]
         + [(g, SHIFTS[1], "faithful") for g in NEW_GEOMETRIES])


@pytest.mark.parametrize("geom,shift,layout", CASES)
def test_plain_matches_jax_kernel(geom, shift, layout):
    d = _case_inputs(geom, shift)
    out, grads = _run_port(d, layout, WT.window_attention_block_core_plain)
    _check_against_jax(out, grads, *_jax_case(geom, shift, layout))


@pytest.mark.parametrize("geom,shift,layout", CASES)
def test_function_matches_jax_kernel_and_plain(geom, shift, layout):
    """The autograd Function's CPU path against JAX, and exactly equal to
    autograd through the plain version (the same operations, recomputed);
    a CPU tensor never launches a kernel."""
    d = _case_inputs(geom, shift)
    before = (WT.forward_counter.launches, WT.backward_counter.launches)
    out, grads = _run_port(d, layout, WT.window_attention_block_core)
    assert (WT.forward_counter.launches, WT.backward_counter.launches) == before
    _check_against_jax(out, grads, *_jax_case(geom, shift, layout))
    p_out, p_grads = _run_port(d, layout, WT.window_attention_block_core_plain)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ dropout hash

def _py_fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _py_bits(seed, b, g, hd, widx, i, j):
    h = seed
    for v in (b, g, hd, widx, i, j):
        h = _py_fmix32(h ^ ((v + 0x9E3779B9) & 0xFFFFFFFF))
    return h


def test_hash_is_exact_against_python_integers():
    """The int64 chain (16-bit halves in every multiply) equals the same
    chain on unbounded Python integers, at every coordinate and at seeds
    near 2^31."""
    for seed in (0, 1, 12345, 2**31 - 2):
        bits = WT.dropout_bits(seed, 2, 1, 2, 3, 4)
        rng = np.random.RandomState(seed % 1000)
        for _ in range(40):
            b, hd, widx, i, j = (int(rng.randint(k)) for k in (2, 2, 3, 4, 4))
            assert int(bits[b, widx, hd, i, j]) == _py_bits(seed, b, 1, hd, widx, i, j)
    assert int(WT.dropout_bits(7, 1, 0, 1, 1, 1).max()) < 2**32


def test_dropout_mask_is_seeded_and_unbiased():
    keep = 0.9
    a = WT.dropout_bits(11, 4, 2, 2, 64, 16)
    assert a.numel() >= 10**5
    assert torch.equal(a, WT.dropout_bits(11, 4, 2, 2, 64, 16))
    other = WT.dropout_bits(12, 4, 2, 2, 64, 16)
    m, m2 = WT.keep_multiplier(a, keep), WT.keep_multiplier(other, keep)
    assert not torch.equal(m, m2)
    assert not torch.equal(m, WT.keep_multiplier(WT.dropout_bits(11, 4, 1, 2, 64, 16), keep))  # other group
    kept = (m > 0).double()
    n = kept.numel()
    assert abs(kept.mean().item() - keep) < 4 * (keep * (1 - keep) / n) ** 0.5
    assert torch.all(m[m > 0] == torch.tensor(np.float32(1 / keep)))
    assert m.dtype == torch.float32


def test_threshold_rule_matches_the_tpu_kernel(monkeypatch):
    """Fed the same 32 random bits, the port's keep rule and the TPU kernel's
    _dropout_mask (its PRNG swapped for fixed bits, as
    tests/test_pallas_train.py::test_dropout_mask_math does) agree."""
    rng = np.random.RandomState(0)
    bits = rng.randint(-(2**31), 2**31, size=(4, 128), dtype=np.int64).astype(np.int32)
    monkeypatch.setattr(PWT.pltpu, "prng_random_bits", lambda shape: jnp.asarray(bits))
    for keep in (0.9, 0.5, 1.0 - 1e-9):
        ref = np.asarray(PWT._dropout_mask((4, 128), keep))
        ours = WT.keep_multiplier(torch.from_numpy(bits.astype(np.int64) & 0xFFFFFFFF), keep).numpy()
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shift", SHIFTS)
def test_function_with_dropout_matches_plain_autograd(shift):
    """With keep = 0.9 the Function's CPU forward and gradients equal autograd
    through the plain version with the same seed; another seed differs."""
    d = _case_inputs("16x64", shift, seed=9)
    out, grads = _run_port(d, "faithful", WT.window_attention_block_core, seed=77, keep=0.9)
    p_out, p_grads = _run_port(d, "faithful", WT.window_attention_block_core_plain, seed=77, keep=0.9)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)
    no_drop, _ = _run_port(d, "faithful", WT.window_attention_block_core_plain)
    other, _ = _run_port(d, "faithful", WT.window_attention_block_core_plain, seed=78, keep=0.9)
    assert not torch.allclose(out, no_drop) and not torch.allclose(out, other)


def test_keep_one_is_the_identity_and_draws_nothing():
    d = _case_inputs("8x32", (1, 2, 4))
    a, _ = _run_port(d, "faithful", WT.window_attention_block_core_plain, seed=3, keep=1.0)
    b, _ = _run_port(d, "faithful", WT.window_attention_block_core_plain, seed=4, keep=1.0)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        WT.window_attention_block_core(*_port_args(d)[0], _port_args(d)[1], _port_args(d)[2], 0, 0.0,
                                       d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
