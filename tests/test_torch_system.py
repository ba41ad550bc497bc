"""The whole slice: the port's DPMNSystem.sr_forward against the JAX package's
DPMNSystem._sr_forward_impl with the device glyph atlas, on the same
numpy-seeded weights (carried by dpmn_tpu_torch.weights.from_jax) and the same
LR batch.  TATT PSN, b1 = b2 = 2, embed 48, srb = 1, B = 2.

Thresholds sit on this path — the uint8 truncations of to_mask and
parse_visionlan_input, and the students' argmax — so a 1e-6 difference can
flip a mask pixel or an id.  The tests therefore assert that the students'
ids agree exactly, hold the SR output strictly (rtol=1e-4, atol=1e-5: float32
in other summation orders) where a test-local patch swaps to_mask for the
same smooth function on both sides, and hold it with the real to_mask at a
tolerance that admits a few flipped mask pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch.config import Args, TrainCfg, flagship_args
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import random_variables

SMALL = dict(arch="tatt", mask=True, stu_iter_b1=2, stu_iter_b2=2, patch_size="2,",
             embed_dim="48,", window_size="2,4,8,", depths="1,", num_heads="6,", mlp_ratio="4,", srb=1)


def _pair(kw, seed=0):
    jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), JArgs(**kw), glyph_mode="atlas")
    shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
    state = random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, seed)
    psys = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**kw), device="cpu")
    from_jax(state, psys)
    return jsys, state, psys


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)


def _run_both(jsys, state, psys, lr):
    """SR outputs and every student's glyph ids, from both packages."""
    j_ids, p_ids = [], []
    glyph_fn = jsys._device_glyph

    def recording_glyph(ids, lengths):
        j_ids.append(np.asarray(ids))
        return glyph_fn(ids, lengths)

    jsys._device_glyph = recording_glyph
    try:  # un-jitted, so the recorder sees concrete ids
        ref = np.asarray(jsys._sr_forward_impl(state, jnp.asarray(lr)))
    finally:
        jsys._device_glyph = glyph_fn
    hook = psys.glyph.register_forward_hook(lambda m, inp, out: p_ids.append(inp[0].numpy().copy()))
    try:
        out = psys.sr_forward(lr).numpy()
    finally:
        hook.remove()
    return ref, out, j_ids, p_ids


def _lr(seed):
    return np.random.RandomState(seed).rand(2, 16, 64, 4).astype(np.float32)


def test_sr_forward_smooth_mask_strict(small, monkeypatch):
    jsys, state, psys = small
    monkeypatch.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    ref, out, j_ids, p_ids = _run_both(jsys, state, psys, _lr(1))
    assert len(j_ids) == len(p_ids) == 2
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    assert out.shape == (2, 32, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_sr_forward_matches(small):
    """With the real to_mask: ids exact; the SR within 1e-3 of the JAX output
    in mean and 5e-2 at the worst pixel (one flipped mask pixel moves the
    semantic branch locally), and strictly equal in 99 % of the values."""
    jsys, state, psys = small
    ref, out, j_ids, p_ids = _run_both(jsys, state, psys, _lr(2))
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    d = np.abs(out - ref)
    assert d.mean() < 1e-3 and d.max() < 5e-2
    assert np.mean(d <= 1e-5 + 1e-4 * np.abs(ref)) > 0.99


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_from_jax_raises(small, fault):
    jsys, state, _ = small
    st = jax.tree_util.tree_map(lambda x: x, state)  # fresh dicts, shared leaves
    blk = st["params"]["pgrm_0"]["BasicLayer_0"]["SwinTransformerBlock_0"]["norm2"]
    if fault == "missing":
        del blk["bias"]
    elif fault == "extra":
        blk["stray"] = np.zeros(3, np.float32)
    else:
        blk["bias"] = np.zeros(5, np.float32)
    psys = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**SMALL), device="cpu")
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        from_jax(st, psys)


def test_from_jax_layouts(small):
    """Spot checks of the carried layouts."""
    _, state, psys = small
    p = state["params"]["pgrm_0"]
    np.testing.assert_array_equal(psys.pgrms[0].patch_embed.weight.detach().numpy(),
                                  p["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    wa = p["BasicLayer_0"]["SwinTransformerBlock_1"]["WindowAttention_0"]
    np.testing.assert_array_equal(psys.pgrms[0].layers[0].blocks[1].attn.kv.weight.detach().numpy(),
                                  wa["kv"]["kernel"].T)
    gru = state["frozen"]["psn"]["params"]["infoGen"]["upsample_transformer"]["gru_encoding"]
    np.testing.assert_array_equal(psys.psn.infoGen.transformer.gru_encoding.weight_hh_l0_reverse.detach().numpy(),
                                  gru["w_hh_bw"].T)
    stats = state["batch_stats"]["cmm"]["de_5"]["BatchNorm_1"]
    np.testing.assert_array_equal(psys.cmm.de_5.bn2.running_var.numpy(), stats["var"])


@pytest.mark.slow
def test_sr_forward_flagship_geometry(monkeypatch):
    """The flagship configuration (3+3 PGRMs at embed 96, 5 SRBs) at B = 2.
    The deeper stack accumulates more float32 rounding: atol 5e-5 (1.7e-5
    seen at worst, on 3 of 24576 values)."""
    kw = {k: v for k, v in vars(flagship_args()).items()}
    jsys, state, psys = _pair(kw, seed=3)
    monkeypatch.setattr(JS, "to_mask", lambda img: jnp.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    ref, out, j_ids, p_ids = _run_both(jsys, state, psys, _lr(3))
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5)
