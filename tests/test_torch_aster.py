"""The port's ASTER (dpmn_tpu_torch.models.aster) against dpmn_tpu's on the
same seeded weights: the full-width RecognizerBuilder at B = 2 on 32x128 RGB
(what the judge reads: an SR image, here a bicubic x2 of a random 16x64 LR),
stage by stage on identical inputs (rtol 1e-4 / atol 1e-5), its beam ids at
max_len_labels 100 exactly, and the decoder's three forms; the beam search
also in three regimes at small widths: tie-free weights, duplicated fc rows
(exactly tied logits) and a large EOS bias (more than k EOS events), ids
exactly equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops.resize import resize as jresize
from dpmn_tpu_torch.models import aster as TA
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import aster_variables, nchw, nhwc

JA, JS, JT = (importlib.import_module(f"dpmn_tpu.models.{m}") for m in ("aster", "stn", "tps"))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def aster():
    """The JAX model's variables and stage outputs, and the port model."""
    v = aster_variables(3)
    lr = np.random.RandomState(0).rand(2, 16, 64, 3).astype(np.float32)
    x = np.asarray(jresize(jnp.asarray(lr), (32, 128), mode="bicubic")).clip(0, 1) * 2 - 1
    sub = lambda k: {"params": v["params"][k], "batch_stats": v["batch_stats"][k]}
    stn_in = jresize(jnp.asarray(x), (32, 64), mode="bilinear", align_corners=True)
    _, ctrl = JS.STNHead(num_ctrlpoints=20, activation="none", variant="recognizer").apply(sub("stn_head"), stn_in)
    rect, coord = JT.TPSSpatialTransformer((32, 100), 20, (0.05, 0.05))(jnp.asarray(x), ctrl)
    feats = JA.ResNetAster().apply(sub("encoder"), rect)
    jm = JA.RecognizerBuilder()
    ids = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))["pred_rec"]
    model = TA.RecognizerBuilder()
    module_from_jax(model, v)
    ref = {k: np.array(a) for k, a in dict(ctrl=ctrl, rect=rect, coord=coord, feats=feats, ids=ids).items()}
    return dict(v=v, x=x, ref=ref, model=model.eval())


def test_rectify_matches(aster):
    m, x, ref = aster["model"], aster["x"], aster["ref"]
    with torch.no_grad():
        _, ctrl = m.rectify(nchw(x))
        rect, coord = m.tps(nchw(x), torch.from_numpy(ref["ctrl"]))
    np.testing.assert_allclose(ctrl.numpy(), ref["ctrl"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(coord.numpy(), ref["coord"], rtol=0, atol=ATOL)
    # float32 TPS coordinates carry ~4e-6 of rounding in either package; a
    # sample moves by that times the width in pixels, and bilinear sampling
    # changes by at most the image's largest neighbour step per pixel moved
    # (tests/test_torch_grid_sample.py holds the sampler alone at 1e-5)
    step = max(np.abs(np.diff(x, axis=1)).max(), np.abs(np.diff(x, axis=2)).max())
    moved = np.abs(coord.numpy() - ref["coord"]).max(axis=(0, 1)) @ np.array([128.0, 32.0])
    np.testing.assert_allclose(nhwc(rect), ref["rect"], rtol=0, atol=ATOL + moved * step)


def test_encoder_matches(aster):
    with torch.no_grad():
        feats = aster["model"].encoder(nchw(aster["ref"]["rect"]))
    assert tuple(feats.shape) == (2, 25, 512)
    np.testing.assert_allclose(feats.numpy(), aster["ref"]["feats"], rtol=RTOL, atol=ATOL)


def test_beam_ids_match(aster):
    with torch.no_grad():
        out = aster["model"](nchw(aster["x"]))
    assert out["pred_rec"].shape == (2, 100) and (out["pred_rec_score"] == 1).all()
    np.testing.assert_array_equal(out["pred_rec"], aster["ref"]["ids"])


def test_sample_and_teacher_forced_match(aster):
    head = JA.AttentionRecognitionHead(num_classes=97, in_planes=512, max_len_labels=100)
    p = jax.tree_util.tree_map(jnp.asarray, {"params": aster["v"]["params"]["decoder"]})
    feats = aster["ref"]["feats"]
    targets = np.random.RandomState(1).randint(0, 97, (2, 100)).astype(np.int32)
    ref_logits = np.asarray(head.apply(p, jnp.asarray(feats), jnp.asarray(targets), num_steps=30))
    ref_ids, ref_scores = (np.asarray(a) for a in head.apply(p, jnp.asarray(feats), method=head.sample))
    port = aster["model"].decoder
    with torch.no_grad():
        logits = port(torch.from_numpy(feats), torch.from_numpy(targets), num_steps=30)
        ids, scores = port.sample(torch.from_numpy(feats))
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=RTOL, atol=ATOL)


NC, EOS, DIM, MAX_LEN, BEAM, BATCH = 12, 10, 32, 30, 5, 8


def _head_params(regime, rng):
    u = lambda *shape, s=0.5: ((rng.rand(*shape) * 2 - 1) * s).astype(np.float32)
    p = {"s_embed_kernel": u(DIM, DIM), "s_embed_bias": u(DIM), "x_embed_kernel": u(DIM, DIM),
         "x_embed_bias": u(DIM), "w_embed_kernel": u(DIM, 1, s=1.0), "w_embed_bias": u(1),
         "tgt_embedding": u(NC + 1, DIM, s=1.0), "gru_w_ih": u(2 * DIM, 3 * DIM), "gru_w_hh": u(DIM, 3 * DIM),
         "gru_b_ih": u(3 * DIM), "gru_b_hh": u(3 * DIM), "fc_kernel": u(DIM, NC, s=1.0), "fc_bias": u(NC)}
    pairs = []
    if regime == "tie_prone":
        for a, b in ((0, 3), (1, 7), (4, 5), (2, 11)):  # class b's logit is class a's, exactly
            p["fc_kernel"][:, b] = p["fc_kernel"][:, a]
            p["fc_bias"][b] = p["fc_bias"][a]
            pairs.append((a, b))
    if regime == "many_eos":
        p["fc_bias"][EOS] += 1.5
    return p, pairs


@pytest.mark.parametrize("regime", ["tie_free", "tie_prone", "many_eos"])
def test_beam_search_regimes(regime):
    rng = np.random.RandomState({"tie_free": 10, "tie_prone": 11, "many_eos": 12}[regime])
    params, pairs = _head_params(regime, rng)
    x = rng.rand(BATCH, 9, DIM).astype(np.float32)
    jh = JA.AttentionRecognitionHead(num_classes=NC, in_planes=DIM, s_dim=DIM, att_dim=DIM, max_len_labels=MAX_LEN)
    jp = jax.tree_util.tree_map(jnp.asarray, {"params": params})
    ref = np.asarray(jh.apply(jp, jnp.asarray(x), BEAM, EOS, method=jh.beam_search)[0])
    head = TA.AttentionRecognitionHead(NC, DIM, DIM, DIM, MAX_LEN)
    module_from_jax(head, {"params": params})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ids, _ = head.eval().beam_search(xt, BEAM, EOS)
        symbols = head.beam_search_steps(xt, BEAM, EOS)[0].numpy()
        logits, _ = head.decoder(xt, head.decoder.attention_unit.xEmbed(xt), xt.new_zeros(BATCH, DIM),
                                 torch.full((BATCH,), NC))
    np.testing.assert_array_equal(ids, ref)
    for a, b in pairs:  # the regime does what it claims: exact ties
        assert torch.equal(logits[:, a], logits[:, b])
    eos_events = (symbols == EOS).reshape(MAX_LEN, BATCH, BEAM).sum(axis=(0, 2))
    if regime == "many_eos":
        assert (eos_events > BEAM).any(), eos_events


def _markov_logits():
    """Logits that depend on the previous symbol alone (a Markov chain over
    the classes), so that more than k EOS events come before the best one:
    from BOS the beams take A and B1..B4; B1..B4 end at t = 1 (4 events near
    -3.1) while A goes on to A2, which ends at t = 2 (near -4.9) and goes on
    to A3, whose EOS at t = 3 (near -0.9) is the best-scoring event of all.
    The replacement scheme keeps the k earliest events, so the answer is B1."""
    a, a2, a3, b1, d1, x = 0, 1, 2, 3, 7, 11
    t = np.full((NC + 1, NC), -8.0, np.float32)
    t[NC, [a, b1, b1 + 1, b1 + 2, b1 + 3]] = [0.0, -2.9, -2.95, -3.0, -3.05]  # BOS
    t[a, :] = -6.0
    t[a, a2] = 0.0
    t[b1:b1 + 4, :] = -6.0
    t[b1:b1 + 4, EOS] = 0.0
    t[a2, [a3, d1, d1 + 1, d1 + 2, EOS]] = [0.0, -1.0, -1.1, -1.2, -3.5]
    t[[a3, d1, d1 + 1, d1 + 2, x], :] = -4.0
    t[a3, EOS] = 0.0
    t[[d1, d1 + 1, d1 + 2, x], x] = 0.0
    return t


def test_beam_search_keeps_the_earliest_eos_events(monkeypatch):
    """The EOS replacement scheme against the best-scoring EOS event: the
    decode step of both packages replaced by the same Markov logits."""
    table = _markov_logits()
    params, _ = _head_params("tie_free", np.random.RandomState(13))
    x = np.zeros((2, 3, DIM), np.float32)
    jt = jnp.asarray(table)
    monkeypatch.setattr(JA, "_decoder_step", lambda p, x, x_proj, state, y_prev: (jt[y_prev], state))
    jh = JA.AttentionRecognitionHead(num_classes=NC, in_planes=DIM, s_dim=DIM, att_dim=DIM, max_len_labels=MAX_LEN)
    jp = jax.tree_util.tree_map(jnp.asarray, {"params": params})
    ref = np.asarray(jh.apply(jp, jnp.asarray(x), BEAM, EOS, method=jh.beam_search)[0])
    tt = torch.from_numpy(table)
    monkeypatch.setattr(TA.DecoderUnit, "forward", lambda self, x, x_proj, state, y_prev: (tt[y_prev], state))
    head = TA.AttentionRecognitionHead(NC, DIM, DIM, DIM, MAX_LEN)
    module_from_jax(head, {"params": params})
    with torch.no_grad():
        ids, _ = head.beam_search(torch.from_numpy(x), BEAM, EOS)
        symbols, _, scores = (a.numpy().reshape(MAX_LEN, 2, BEAM) for a in
                              head.beam_search_steps(torch.from_numpy(x), BEAM, EOS))
    np.testing.assert_array_equal(ids, ref)
    # the regime does what it claims: 5 events before the best one, which loses
    events = [(scores[t, 0, j], t) for t in range(MAX_LEN) for j in range(BEAM) if symbols[t, 0, j] == EOS]
    best_t = max(events)[1]
    assert best_t == 3 and sum(t < best_t for _, t in events) > BEAM - 1
    assert list(ids[0, :2]) == [3, EOS]
