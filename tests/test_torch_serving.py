"""The serving modes of the eval forward against the JAX package, at
test_torch_system.py's SMALL geometry (TATT PSN, b1 = b2 = 2, embed 48,
srb = 1, B = 2) on the same numpy-seeded weights (sr_forward_bf16:
test_torch_serving_bf16.py):

  * sr_forward(glyph_from_psn=True) against _sr_forward_impl(state, lr,
    True): the students' ids exactly, the SR at rtol 1e-4 / atol 1e-5 under
    the smooth to_mask patch of test_torch_system.py;
  * the vmapped students against the per-student loop: ids equal;
  * student_dtype="bfloat16": ids agree with float32 on >= 0.9 of the
    positions, and with the JAX package's bf16 students on >= 0.9 (bf16
    argmax may break near-ties differently in torch's and XLA's
    convolutions; tests/test_system.py:117-140 holds the same 0.9);
  * the bf16 copies: reused while nothing changed, made again after a
    train_step and after from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.models.visionlan import parse_visionlan_input
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import random_variables
from test_torch_system import SMALL, _lr, _pair


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


def _jax_forward(jsys, state, lr, glyph_from_psn=False, bf16=False):
    """The JAX SR (un-jitted) and the ids of every glyph render it made."""
    ids, glyph_fn = [], jsys._device_glyph

    def recording_glyph(i, lengths):
        ids.append(np.asarray(i))
        return glyph_fn(i, lengths)

    jsys._device_glyph = recording_glyph
    try:
        if bf16:
            out = jsys._sr_forward_bf16_impl(JS.DPMNSystem.bf16_state(state), jnp.asarray(lr), glyph_from_psn)
        else:
            out = jsys._sr_forward_impl(state, jnp.asarray(lr), glyph_from_psn)
    finally:
        jsys._device_glyph = glyph_fn
    return np.asarray(out.astype(jnp.float32)), ids


def _port_forward(psys, lr, glyph_from_psn=False, bf16=False):
    ids = []
    hook = psys.glyph.register_forward_hook(lambda m, inp, out: ids.append(inp[0].numpy().copy()))
    try:
        fn = psys.sr_forward_bf16 if bf16 else psys.sr_forward
        out = fn(lr, glyph_from_psn=glyph_from_psn)
    finally:
        hook.remove()
    return out.numpy(), ids


def test_glyph_from_psn_smooth_mask_strict(small, monkeypatch):
    jsys, state, psys = small
    monkeypatch.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    lr = _lr(4)
    ref, j_ids = _jax_forward(jsys, state, lr, glyph_from_psn=True)
    out, p_ids = _port_forward(psys, lr, glyph_from_psn=True)
    assert len(j_ids) == len(p_ids) == 1  # one render of b1 * B words
    assert p_ids[0].shape == (2 * 2, 25) and (p_ids[0] > 0).any()
    np.testing.assert_array_equal(p_ids[0], j_ids[0])
    assert out.shape == (2, 32, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_vmapped_students_match_the_loop(small):
    _, _, psys = small
    img = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 32, 128).astype(np.float32))
    with torch.no_grad():
        x = parse_visionlan_input(img)
        logits, lengths = TS.StackedStudents(psys.students)(x)
        loop = [psys.students[k](x) for k in range(psys.b1)]
        shared = psys._glyph_priors_shared(img)
        each = [psys._glyph_prior(k, img) for k in range(psys.b1)]
    for k, (lg, ln) in enumerate(loop):
        assert torch.equal(logits[k].argmax(-1), lg.argmax(-1))
        assert torch.equal(lengths[k], ln)
        torch.testing.assert_close(shared[k], each[k], rtol=1e-5, atol=1e-4)


def test_bf16_students_keep_the_ids(small):
    jsys, state, _ = small
    psys16 = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**SMALL), device="cpu", student_dtype="bfloat16")
    from_jax(state, psys16)
    img = np.random.RandomState(5).rand(2, 32, 128, 3).astype(np.float32)
    with torch.no_grad():
        x = parse_visionlan_input(torch.from_numpy(img).permute(0, 3, 1, 2))
        ids32 = psys16.students[0](x)[0].argmax(-1)
        students16 = psys16._students(psys16)
        assert students16[0].w_vrm.weight.dtype == torch.bfloat16
        ids16 = students16[0](x.bfloat16())[0].argmax(-1)
    assert (ids16 == ids32).float().mean().item() >= 0.9
    assert psys16.students[0].w_vrm.weight.dtype == torch.float32  # the float32 students stay

    # the JAX package's bf16 student (system.py:281-287) on the same input
    from dpmn_tpu.models.visionlan import parse_visionlan_input as j_parse

    cast = lambda t: t.astype(jnp.bfloat16) if hasattr(t, "dtype") and t.dtype == np.float32 else t
    sv16 = jax.tree_util.tree_map(cast, state["frozen"]["student_0"])
    j16, _ = jsys.student.apply(sv16, j_parse(jnp.asarray(img)).astype(jnp.bfloat16), train=False)
    assert np.mean(np.asarray(j16.argmax(-1)) == ids16.numpy()) >= 0.9

    out = psys16.sr_forward(_lr(6))
    assert out.shape == (2, 32, 128, 3) and torch.isfinite(out).all()


def test_bf16_copies_follow_the_float32_state():
    """The bf16 state (and the bf16 students) are reused while nothing
    changed, and made again after a train_step and after from_jax (the JAX
    package's test_bf16_state_cache_invalidates_on_new_state)."""
    jsys = JS.DPMNSystem(JS.TrainCfg(batch_size=2), JS.Args(**SMALL), glyph_mode="atlas")
    shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
    tree = {k: shapes[k] for k in ("params", "batch_stats", "frozen")}
    psys = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**SMALL), device="cpu", student_dtype="bfloat16")
    from_jax(random_variables(tree, 0), psys)
    lr = _lr(8)
    a = psys.sr_forward_bf16(lr)
    psys.sr_forward(lr)
    assert psys.state_bf16.made == 1 and psys.student_bf16.made == 1
    assert torch.equal(psys.sr_forward_bf16(lr), a)
    psys.sr_forward(lr)
    assert psys.state_bf16.made == 1 and psys.student_bf16.made == 1  # reused

    hr = np.random.RandomState(9).rand(2, 32, 128, 4).astype(np.float32)
    psys.train_step(hr, lr)
    b = psys.sr_forward_bf16(lr)
    assert psys.state_bf16.made == 2 and not torch.equal(a, b)

    from_jax(random_variables(tree, 1), psys)
    c = psys.sr_forward_bf16(lr)
    psys.sr_forward(lr)
    assert psys.state_bf16.made == 3 and psys.student_bf16.made == 2
    assert not torch.equal(b, c)
    fresh = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**SMALL), device="cpu")
    from_jax(random_variables(tree, 1), fresh)
    assert torch.equal(fresh.sr_forward_bf16(lr), c)
