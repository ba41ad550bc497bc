"""DPMNSystem.sr_forward of every arch the port gained (`tsrn`, `tg`,
`tpgsr`, `tbsrn`, and `tsrn` on unmasked 3-channel input) against the JAX
package's _sr_forward_impl, at tests/test_torch_system.py's SMALL PGRM
geometry (embed 48, windows 2 / 4 / 8, srb 1) with one student and one PGRM
a branch (the two-deep cascade is held for TATT there; this file holds
the PSN and its wiring), one image a case, on the same numpy-seeded
weights (carried by dpmn_tpu_torch.weights.from_jax): the students' glyph
ids equal, the SR within rtol=1e-4 and atol=1e-5.

Both sides run in float64: in float32 single SR values of the cascade move
by up to 3e-5 with the summation order (the JAX package's own jitted and
eager forwards differ by 9e-6), at the edge of the tolerance, as
test_torch_corrected.py found.  In float64 the JAX package's forward takes
seconds an image on a CPU (XLA's float64 convolutions), so its cascade
runs once over all cases (see `references`).  As in test_torch_system.py,
to_mask is swapped for the same smooth function on both sides: its
threshold is a uint8 truncation at which a 1e-6 difference can flip a
pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import init_variables, random_variables
from test_torch_system import SMALL

RTOL, ATOL = 1e-4, 1e-5


CASES = [("tsrn", True), ("tg", True), ("tpgsr", True), ("tbsrn", True), ("tsrn", False)]
PSN_CASES = [case for case in CASES if case[0] != "tg"]
CASCADE = {**SMALL, "stu_iter_b1": 1, "stu_iter_b2": 1}


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def references():
    """In float64, with the smooth to_mask on both sides: for every case its
    state (the cascade's weights shared, the PSN's its own), its LR image
    (B = 1) and the JAX package's _sr_forward_impl of it with the students'
    ids.  Each case's PSN stage runs on its own; the rest of
    _sr_forward_impl (system.py:583-594: _cascade and the α-blend), which
    treats every image alone and reads the PSN output's first 3 channels
    only, runs once over all cases' PSN outputs (an unmasked PSN's with a
    zero 4th channel).  `tg` builds TSRN in both packages: it shares the
    case of `tsrn`, its state, image and reference."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
        mp.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
        jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**CASCADE), glyph_mode="atlas")
        shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
        shared = _float64(random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, 30))
        students = {k: v for k, v in shared["frozen"].items() if k.startswith("student_")}
        cases, psn_out = [], []
        for i, (arch, mask) in enumerate(PSN_CASES):
            kw = {**CASCADE, "arch": arch, "mask": mask}
            csys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**kw), glyph_mode="atlas")
            lr = np.random.RandomState(31 + i).rand(1, 16, 64, 4 if mask else 3)
            emb = (jnp.zeros((1, 1, 26, 37)),) if csys.needs_text_prior else ()
            frozen = {"psn": _float64(init_variables(csys.psn, 32 + i, jnp.asarray(lr), *emb, train=False))}
            if csys.crnn_psn is not None:
                frozen["crnn_psn"] = shared["frozen"]["crnn_psn"]
            out = jax.jit(csys._psn_forward)(frozen, jnp.asarray(lr))
            psn_out.append(jnp.pad(out, ((0, 0), (0, 0), (0, 0), (0, 4 - out.shape[-1]))))
            cases.append(({**shared, "frozen": {**frozen, **students}}, lr))
        ids = []
        glyph_fn = jsys._device_glyph
        jsys._device_glyph = lambda i, n: jax.debug.callback(lambda v: ids.append(np.asarray(v)), i) or glyph_fn(i, n)
        images_lr_psn = jnp.concatenate(psn_out)
        _, sr, _ = jax.jit(jsys._cascade, static_argnums=(5,))(
            shared["params"], shared["batch_stats"], students, images_lr_psn,
            jnp.zeros_like(images_lr_psn[..., :3]), False, None)
        alpha = jsys.args.alpha
        ref = np.asarray(alpha * sr + (1 - alpha) * images_lr_psn[..., :3])
        assert len(ids) == 1
        refs = {case: (state, lr, ref[i:i + 1], ids[0][i:i + 1]) for i, (case, (state, lr)) in
                enumerate(zip(PSN_CASES, cases))}
        yield {(arch, mask): refs[("tsrn" if arch == "tg" else arch, mask)] for arch, mask in CASES}


@pytest.mark.parametrize("arch,mask", CASES, ids=[f"{a}-{'mask' if m else 'rgb'}" for a, m in CASES])
def test_sr_forward_matches(references, arch, mask):
    state, lr, ref, j_ids = references[(arch, mask)]
    with jax.enable_x64(True):
        kw = {**CASCADE, "arch": arch, "mask": mask}
        psys = TS.DPMNSystem(TrainCfg(batch_size=1), Args(**kw), device="cpu").double()
        from_jax(state, psys)
        p_ids = []
        hook = psys.glyph.register_forward_hook(lambda m, inp, out: p_ids.append(inp[0].numpy().copy()))
        out = psys.sr_forward(lr).numpy()
        hook.remove()
    assert len(p_ids) == 1
    np.testing.assert_array_equal(j_ids, p_ids[0])
    assert out.shape == (1, 32, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
