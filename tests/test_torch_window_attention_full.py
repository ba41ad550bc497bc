"""The port's training window attention with SKConv fused in (kernel K5's
plain version and its autograd Function) against the JAX package's
window_attention_full_core in interpret mode, composed with
build_packed_bias under jax.vjp so the bias gradient arrives per group as
(heads, N, N) on both sides.

Geometries: the flagship 16x64 grid at dim 96 with 6 heads, and the 8x32 grid
at dim 48 (head dim 8, the ws=8 group clamped to the grid with shift 0); B =
2, both shift sets, the faithful layout (the only one K5 takes), keep = 1;
and, shifted, the 8x16 grid at head dim 32 and at dim 16 (SKConv's channel
8) of test_torch_window_attention_train, one image.
Tolerances are the JAX package's own for its fused training kernels
(tests/test_pallas_train.py:173-182): output rtol = atol = 2e-5, all 18
primal gradients and the bias gradients rtol 2e-3, atol 2e-4.  With dropout
on, the Function equals autograd through the plain version."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops import pallas_window_train as PWT
from dpmn_tpu.ops.pallas_window import build_packed_bias
from dpmn_tpu_torch.ops import window_attention_full as WF
from dpmn_tpu_torch.ops import window_attention_train as WT
from test_torch_window_attention_train import BASE_GEOMETRIES, GRAD_NAMES, NEW_GEOMETRIES, SHIFTS, _case_inputs

# SKConv's Dense_0..3 (flax kernels (in, out)), after K3's ten primals
SK_NAMES = ["pk", "pb", "f1k", "f1b", "f2k", "f2b", "phk", "phb"]
JAX_ORDER = ["xq", "xkv", "qs", "qb", "ks", "kb", "wq", "bq", "wkv", "bkv"] + SK_NAMES
KERNELS = {6, 8, 10, 12, 14, 16}  # positions of (in, out) kernels: transposed for torch


def _full_inputs(geom, shift, seed=5):
    """K3's case plus SKConv's weights (dz = channel / 2)."""
    d = _case_inputs(geom, shift, seed)
    x = d["x"]
    c = x["xq"].shape[-1]
    ch = c // len(d["win"])
    dz = ch // 2
    rng = np.random.RandomState(seed + 200)
    f32 = lambda a: np.asarray(a, np.float32)
    for name, (fan_in, fan_out) in (("pk", (c, c)), ("f1k", (c, dz)), ("f2k", (dz, c)), ("phk", (ch, c))):
        x[name] = f32(rng.randn(fan_in, fan_out) / np.sqrt(fan_in))
        x[name[:-1] + "b"] = f32(0.1 * rng.randn(fan_out))
    return d


def _torch_layout(i, a):
    return np.ascontiguousarray(a.T if i in KERNELS else a)


@functools.lru_cache(maxsize=None)
def _jax_case(geom, shift):
    """JAX output and gradients (torch layouts) of one case, computed once."""
    d = _full_inputs(geom, shift)
    x, (h, w) = d["x"], d["hw"]
    c = x["xq"].shape[-1]
    masks = [None if m is None else jnp.asarray(m) for m in d["masks"]]

    def f(*args):
        prim, biases = args[:18], args[18:]
        packed = build_packed_bias(list(biases), masks, d["win"], h * w)
        return PWT.window_attention_full_core(
            prim[0].reshape(-1, h, w, c), prim[1].reshape(-1, h, w, c), *prim[2:], packed, jnp.zeros((1,), jnp.int32),
            tuple(d["win"]), tuple(d["shf"]), d["gh"], d["scale"], 1.0, (h, w), True)

    out, vjp = jax.vjp(f, *[jnp.asarray(x[k]) for k in JAX_ORDER], *[jnp.asarray(b) for b in d["biases"]])
    grads = [np.asarray(g) for g in vjp(jnp.asarray(d["cot"]))]
    return np.asarray(out), [_torch_layout(i, g) for i, g in enumerate(grads)]


def _run(d, fn, seed=0, keep=1.0):
    prim = [torch.from_numpy(_torch_layout(i, d["x"][k])).requires_grad_() for i, k in enumerate(JAX_ORDER)]
    biases = [torch.from_numpy(b).requires_grad_() for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    out = fn(*prim, biases, masks, seed, keep, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    grads = torch.autograd.grad(out, prim + biases, torch.from_numpy(d["cot"]))
    return out.detach(), [g.numpy() for g in grads]


def _check_against_jax(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)
    names = GRAD_NAMES + ["proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "ph_w", "ph_b"]
    names += [f"bias_{i}" for i in range(len(ref_grads) - 18)]
    assert len(grads) == len(ref_grads) == len(names)
    for name, a, b in zip(names, grads, ref_grads):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=name)


CASES = [(g, s) for g in BASE_GEOMETRIES for s in SHIFTS] + [(g, SHIFTS[1]) for g in NEW_GEOMETRIES]


@pytest.mark.parametrize("geom,shift", CASES)
def test_plain_matches_jax_kernel(geom, shift):
    d = _full_inputs(geom, shift)
    _check_against_jax(*_run(d, WF.window_attention_full_core_plain), *_jax_case(geom, shift))


@pytest.mark.parametrize("geom,shift", CASES)
def test_function_matches_jax_kernel_and_plain(geom, shift):
    """The Function's CPU path against JAX, and exactly equal to autograd
    through the plain version; a CPU tensor never launches a kernel."""
    d = _full_inputs(geom, shift)
    before = (WF.forward_counter.launches, WF.backward_counter.launches)
    out, grads = _run(d, WF.window_attention_full_core)
    assert (WF.forward_counter.launches, WF.backward_counter.launches) == before
    _check_against_jax(out, grads, *_jax_case(geom, shift))
    p_out, p_grads = _run(d, WF.window_attention_full_core_plain)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shift", SHIFTS)
def test_function_with_dropout_matches_plain_autograd(shift):
    """keep = 0.9: the Function's forward and gradients equal autograd through
    the plain version with the same seed; another seed differs."""
    d = _full_inputs("8x32", shift, seed=9)
    out, grads = _run(d, WF.window_attention_full_core, seed=77, keep=0.9)
    p_out, p_grads = _run(d, WF.window_attention_full_core_plain, seed=77, keep=0.9)
    assert torch.equal(out, p_out)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)
    other, _ = _run(d, WF.window_attention_full_core_plain, seed=78, keep=0.9)
    no_drop, _ = _run(d, WF.window_attention_full_core_plain)
    assert not torch.allclose(out, other) and not torch.allclose(out, no_drop)


def test_cpu_path_saves_only_the_inputs():
    """On the CPU the cores' Function saves its inputs and nothing else (its
    backward runs autograd through the plain version): K5 and K3."""
    d = _full_inputs("8x32", (0, 0, 0))
    prim = [torch.from_numpy(_torch_layout(i, d["x"][k])).requires_grad_() for i, k in enumerate(JAX_ORDER)]
    biases = [torch.from_numpy(b).requires_grad_() for b in d["biases"]]
    masks = [None if m is None else torch.from_numpy(m) for m in d["masks"]]
    static = (masks, 0, 1.0, d["win"], d["shf"], d["gh"], d["scale"], d["hw"])
    for fn, n in ((WF.window_attention_full_core, 18), (WT.window_attention_block_core, 10)):
        saved = fn(*prim[:n], biases, *static).grad_fn.saved_tensors
        assert len(saved) == n + len(biases)
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(saved, prim[:n] + biases))


def test_kernel_core_hands_the_kept_tensors_to_the_backward():
    """KernelCore off the CPU, through a stand-in core on the meta device:
    the tensors the forward kept are saved beside the inputs and reach the
    backward, which gives one gradient per input."""
    seen = {}

    def forward_cuda(st, primals, biases):
        seen["kept"] = tuple(torch.empty(s, device="meta") for s in WF.kept_shapes(2, 128, 32))
        return 2 * primals[0], seen["kept"]

    def backward_cuda(st, primals, biases, dout, kept):
        seen["got"] = kept
        return (2 * dout, torch.zeros_like(primals[1]), *[torch.zeros_like(b) for b in biases])

    impl = WT.CoreImpl(2, None, forward_cuda, backward_cuda)
    x, w, bias = (torch.empty(s, device="meta", requires_grad=True) for s in ((2, 128, 32), (32,), (2, 4, 4)))
    out = WT.KernelCore.apply(impl, None, x, w, bias)
    assert len(out.grad_fn.saved_tensors) == 3 + 3
    grads = torch.autograd.grad(out, (x, w, bias), torch.ones(2, 128, 32, device="meta"))
    assert [g.shape for g in grads] == [x.shape, w.shape, bias.shape]
    assert [tuple(t.shape) for t in seen["got"]] == [(2, 128, 32), (4, 32), (2, 32)]
