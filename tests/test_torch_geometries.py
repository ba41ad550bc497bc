"""The geometries the port's kernels take, checked without a card, and the JAX
package's "mid" geometry end to end on the CPU.

* `ops/geometry.py` `check_window_geometry` (K1, K3, K4, K5, K7) accepts
  each head dim 8 / 16 / 32 and each D a multiple of 16 up to 96 of the
  table the kernels are built for, and refuses head dim 24, D = 128 and
  window 16, naming the limit; with the backward, it refuses the
  thread-per-row attention backward's blocks the card cannot hold.
* `check_gru_hidden` (K2) takes every H from 1 to 512; K8's tiles take any
  head of up to 64 channels and K9's masks any head count.
* The "mid" geometry (__graft_entry__.py:188-193, `config.mid_args`: embed
  48, 6 heads over windows 2 / 4 / 8, so head dim 8; hd_u 4, so the SRB's
  GRU at H = 4): the port's sr_forward against the JAX package's
  _sr_forward_impl at B = 1 on the same seeded weights, with to_mask made
  smooth on both sides (tests/test_torch_system.py), ids exact and the SR
  within rtol 1e-4, atol 1e-5.  The JAX forward runs jitted (a quarter of
  its eager time), its students' ids read through jax.debug.callback.
"""

import dataclasses

import jax
import numpy as np
import pytest

import dpmn_tpu.system as JS
import dpmn_tpu_torch.system as TS
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch.config import TrainCfg, mid_args, toy_args
from dpmn_tpu_torch.ops import geometry as G
from dpmn_tpu_torch.ops.dropout_mask import _launch_geometry
from dpmn_tpu_torch.ops.window_tile_attention import check_tile_geometry
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import random_variables

# (grid, D, windows, heads): each head dim at each D of the table, the
# flagship with --num_heads 3 and 12, and the mid and toy geometries
ACCEPTED = [((16, 64), d, win, heads)
            for d, win in ((16, (2, 4)), (32, (2, 4)), (48, (2, 4, 8)), (64, (4, 8)), (80, (2, 4, 8, 4, 8)), (96, (2, 4, 8)))
            for heads in (len(win) * (d // len(win)) // hd for hd in (8, 16, 32) if (d // len(win)) % hd == 0)]
ACCEPTED += [((16, 64), 96, (2, 4, 8), 3), ((16, 64), 96, (2, 4, 8), 12), ((16, 64), 48, (2, 4, 8), 6),
             ((16, 16), 16, (2, 4), 2)]


@pytest.mark.parametrize("grid,dim,win,heads", ACCEPTED,
                         ids=[f"d{d}-w{len(w)}-h{h}" for _, d, w, h in ACCEPTED])
def test_window_geometry_accepts_the_table(grid, dim, win, heads):
    gh = heads // len(win)
    hd = G.check_window_geometry("k", grid, grid[0] * grid[1], dim, win, gh, backward=True)
    assert hd == dim // len(win) // gh and hd in G.HEAD_DIMS


@pytest.mark.parametrize("dim,win,gh,limit", [
    (48, (2,), 2, "head dims 8, 16, 32"),          # head dim 24
    (128, (2, 4, 8), 4, "up to 96"),                # D = 128 (--embed_dim 128)
    (96, (2, 4, 16), 2, "windows 2, 4, 8"),         # window 16
    (40, (2, 4), 1, "multiple of 16"),
    (96, (2, 4, 8, 2, 4, 8, 2), 1, "1 to 6 groups"),
], ids=["hd24", "d128", "window16", "d40", "groups7"])
def test_window_geometry_refuses_naming_the_limit(dim, win, gh, limit):
    with pytest.raises(ValueError, match=limit):
        G.check_window_geometry("k", (16, 64), 1024, dim, win, gh)


def test_window_geometry_refuses_what_the_backward_cannot_hold():
    """Forward only, any head count; the training kernels refuse a
    thread-per-row backward block beyond the card's shared memory (12 heads
    of 8 on one group of 8x8 windows: 694 KB)."""
    assert G.check_window_geometry("k", (16, 64), 1024, 96, (8,), 12) == 8
    with pytest.raises(ValueError, match="shared memory"):
        G.check_window_geometry("k", (16, 64), 1024, 96, (8,), 12, backward=True)
    # the flagship at --num_heads 12 (4 heads a group) fits: 231424 bytes
    assert G.row_backward_smem(64, 4, 8) == (256, 231424)
    with pytest.raises(ValueError, match="multiple of 64"):
        G.check_window_geometry("k", (6, 6), 36, 96, (2,), 2)


@pytest.mark.parametrize("hidden", [1, 4, 20, 31, 32, 33, 48, 64, 96, 505, 512])
def test_gru_takes_every_hidden_size(hidden):
    G.check_gru_hidden(hidden)


@pytest.mark.parametrize("hidden", [0, 513])
def test_gru_refuses_naming_the_limit(hidden):
    with pytest.raises(ValueError, match="1 to 512"):
        G.check_gru_hidden(hidden)


def test_tile_and_mask_kernels_take_every_head_dim():
    """K8's tiles are one head of C channels, K9's masks depend on the head
    count alone: both take head dims 8, 16 and 32 at any head count."""
    for c in (8, 16, 32):
        check_tile_geometry(12, 64, c)
    with pytest.raises(ValueError, match="C <= 64"):
        check_tile_geometry(12, 64, 96)
    for heads in (1, 2, 4, 12):
        _launch_geometry(2, 0.9, (2, 4, 8), heads, (16, 64))


def test_config_geometries_are_the_jax_packages():
    mid, toy = mid_args(), toy_args()
    assert (mid.embed_dim, mid.num_heads, mid.window_size, mid.hd_u, mid.srb) == ("48,", "6,", "2,4,8,", 4, 1)
    assert (toy.embed_dim, toy.num_heads, toy.window_size, toy.window_num) == ("16,", "2,", "2,4,", 2)


def test_mid_sr_forward_matches_jax(monkeypatch):
    kw = {k: v for k, v in dataclasses.asdict(mid_args()).items() if k != "device"}
    jsys = JS.DPMNSystem(JTrainCfg(batch_size=1), JArgs(**kw), glyph_mode="atlas")
    shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=1), jax.random.PRNGKey(0))
    state = random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, 0)
    psys = TS.DPMNSystem(TrainCfg(batch_size=1), mid_args(device="cpu"), device="cpu")
    from_jax(state, psys)
    monkeypatch.setattr(JS, "to_mask", lambda img: jax.numpy.clip(img[..., :3], 0.0, 1.0))
    monkeypatch.setattr(TS, "to_mask", lambda img: img[:, :3].clamp(0.0, 1.0))
    lr = np.random.RandomState(4).rand(1, 16, 64, 4).astype(np.float32)
    j_ids, p_ids = [], []
    glyph_fn = jsys._device_glyph

    def recording_glyph(ids, lengths):  # jitted: the recorder reads the ids through a callback
        jax.debug.callback(lambda i: j_ids.append(np.asarray(i)), ids)
        return glyph_fn(ids, lengths)

    monkeypatch.setattr(jsys, "_device_glyph", recording_glyph)
    ref = np.asarray(jax.jit(jsys._sr_forward_impl)(state, jax.numpy.asarray(lr)))
    hook = psys.glyph.register_forward_hook(lambda m, inp, out: p_ids.append(inp[0].numpy().copy()))
    try:
        out = psys.sr_forward(lr).numpy()
    finally:
        hook.remove()
    assert len(j_ids) == len(p_ids) == 1
    for a, b in zip(j_ids, p_ids):
        np.testing.assert_array_equal(a, b)
    assert out.shape == (1, 32, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
