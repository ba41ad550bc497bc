"""The corrected layouts (`faithful=False`) and the shared-SR cascade
(`sr_share=True`) of the port against dpmn_tpu, on the same numpy-seeded
weights and inputs: the TATT PSN, both PGRM branches in eval (the path of the
window-attention kernel's corrected layout), and the whole sr_forward at the
slice tests' SMALL geometry.  Tolerances as the faithful tests': rtol 1e-4,
atol 1e-5, the students' ids equal.  The modules run in float32 (other
summation orders); the whole sr_forward runs in float64 on both sides,
because in float32 single SR values of its cascade move by up to 1.3e-5
with the CPU's thread count (its summation order), at the edge of the
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu.models.pgrm import PGRM as JPGRM
from dpmn_tpu.models.tatt import TSRN_TL_TRANS as JTATT
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.models.pgrm import PGRM
from dpmn_tpu_torch.models.tatt import TSRN_TL_TRANS
from dpmn_tpu_torch.weights import from_jax, module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc, random_variables
from test_torch_system import SMALL, _lr

RTOL, ATOL = 1e-4, 1e-5


def test_tatt_psn_corrected_matches():
    """faithful=False: the SRB's second GRU scans along W instead of reading
    the batch as time."""
    rng = np.random.RandomState(20)
    x = rng.rand(2, 16, 64, 4).astype(np.float32)
    emb = rng.dirichlet(np.ones(37), size=(2, 1, 26)).astype(np.float32)
    jm = JTATT(srb_nums=1, out_text_channels=64, faithful=False)
    variables = init_variables(jm, 21, jnp.asarray(x), jnp.asarray(emb), train=False)
    ref, ref_w = jm.apply(variables, jnp.asarray(x), jnp.asarray(emb), train=False)
    port = TSRN_TL_TRANS(srb_nums=1, out_text_channels=64, faithful=False).eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out, w = port(nchw(x), torch.from_numpy(emb.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("graphic", [True, False])
def test_pgrm_corrected_matches(graphic):
    """faithful=False in eval: the attention rows go back to their tokens
    (the kernel's corrected layout) and the Mlp runs its convs on the token
    grid."""
    rng = np.random.RandomState(22 + graphic)
    c = 2 if graphic else 3
    x_q = (rng.rand(2, 32, 128, c) * (255.0 if graphic else 1.0)).astype(np.float32)
    x_kv = rng.rand(2, 32, 128, 3).astype(np.float32)
    res = [rng.rand(2, 32, 128, 3).astype(np.float32) for _ in range(2)]
    kw = dict(embed_dim=48, num_heads=(6,), window_size=(2, 4, 8), iter=2, graphic_mode=graphic, faithful=False)
    jm = JPGRM(**kw)
    variables = init_variables(jm, 24, jnp.asarray(x_q), jnp.asarray(x_kv), ())
    ref = np.asarray(jm.apply(variables, jnp.asarray(x_q), jnp.asarray(x_kv), [jnp.asarray(r) for r in res]))
    port = PGRM(**kw).eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out = nhwc(port(nchw(x_q), nchw(x_kv), [nchw(r) for r in res]))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", [dict(sr_share=True), dict(faithful=False)], ids=["sr_share", "corrected"])
def test_sr_forward_variant_smooth_mask_strict(variant, monkeypatch):
    """sr_forward in float64 with the smooth to_mask on both sides (as
    test_torch_system.py's strict test): ids exact, the SR within rtol 1e-4 /
    atol 1e-5."""
    kw = dict(SMALL, **variant)
    monkeypatch.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    with jax.enable_x64(True):
        jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**kw), glyph_mode="atlas")
        shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
        state = jax.tree_util.tree_map(lambda a: a.astype(np.float64), random_variables(
            {k: shapes[k] for k in ("params", "batch_stats", "frozen")}, 25))
        psys = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**kw), device="cpu").double()
        from_jax(state, psys)
        lr = _lr(26).astype(np.float64)
        j_ids, p_ids = [], []
        glyph_fn = jsys._device_glyph

        def recording_glyph(ids, lengths):
            jax.debug.callback(lambda i: j_ids.append(np.asarray(i)), ids)
            return glyph_fn(ids, lengths)

        jsys._device_glyph = recording_glyph
        ref = np.asarray(jax.jit(jsys._sr_forward_impl)(state, jnp.asarray(lr)))
        hook = psys.glyph.register_forward_hook(lambda m, inp, out: p_ids.append(inp[0].numpy().copy()))
        out = psys.sr_forward(lr).numpy()
        hook.remove()
    assert len(j_ids) == len(p_ids) == 2
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    assert out.shape == (2, 32, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
