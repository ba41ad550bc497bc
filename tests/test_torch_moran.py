"""The port's MORAN (dpmn_tpu_torch.models.moran) against dpmn_tpu's on the
same seeded weights: the full-width model at B = 2 on the MORAN parser's
32x100 grayscale of a 32x128 SR-like image (a bicubic x2 of a random 16x64
LR), MORN's rectified image (atol 1e-5), both directions' logits over 20
steps (rtol 1e-4 / atol 1e-5) and the words; frac_pickup's warp at the
(idx, beta) the JAX rng draws (atol 1e-6)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu.ops.resize import resize as jresize
from dpmn_tpu_torch.models import moran as TM
from dpmn_tpu_torch.utils.labels import AttentionLabelConverter
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc

JM = importlib.import_module("dpmn_tpu.models.moran")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def moran():
    v = init_variables(JM.MORAN(), 8, jnp.zeros((1, 32, 100, 1)), num_steps=2)
    lr = np.random.RandomState(0).rand(2, 16, 64, 3).astype(np.float32)
    img = np.asarray(jresize(jnp.asarray(lr), (32, 128), mode="bicubic")).clip(0, 1)
    x = np.array(JM.parse_moran_input(jnp.asarray(img)))
    sub = {"params": v["params"]["MORN"], "batch_stats": v["batch_stats"]["MORN"]}
    rect = JM.MORN().apply(sub, jnp.asarray(x), test=True)
    l2r, r2l = jax.jit(lambda v, x: JM.MORAN().apply(v, x, num_steps=20))(v, jnp.asarray(x))
    model = TM.MORAN()
    module_from_jax(model, v)
    ref = {k: np.array(a) for k, a in dict(rect=rect, l2r=l2r, r2l=r2l).items()}
    return dict(img=img, x=x, ref=ref, model=model.eval())


def test_parser_and_morn_match(moran):
    x = TM.parse_moran_input(nchw(moran["img"]))
    np.testing.assert_allclose(nhwc(x), moran["x"], rtol=0, atol=ATOL)
    with torch.no_grad():
        rect = moran["model"].MORN(nchw(moran["x"]))
    np.testing.assert_allclose(nhwc(rect), moran["ref"]["rect"], rtol=0, atol=ATOL)


def test_logits_and_words_match(moran):
    with torch.no_grad():
        l2r, r2l = moran["model"](nchw(moran["x"]), num_steps=20)
    assert tuple(l2r.shape) == tuple(r2l.shape) == (2, 20, 37)
    np.testing.assert_allclose(l2r.numpy(), moran["ref"]["l2r"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r2l.numpy(), moran["ref"]["r2l"], rtol=RTOL, atol=ATOL)
    alphabet = AttentionLabelConverter().alphabet
    words = lambda logits: ["".join(alphabet[i] for i in row).split("$")[0] for row in logits.argmax(-1)]
    assert words(l2r.numpy()) == words(moran["ref"]["l2r"])


def test_frac_pickup_matches():
    alpha = np.random.RandomState(3).rand(4, 26).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JM.frac_pickup(jnp.asarray(alpha), key))
    k1, k2 = jax.random.split(key)  # the draws of the JAX function
    idx = int(jax.random.randint(k1, (), 1, 25))
    beta = float(jax.random.uniform(k2, ())) / 4.0
    out = TM.frac_pickup_warp(torch.from_numpy(alpha), idx, beta).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert not np.allclose(out, alpha)  # the pair it swapped moved
    gen = lambda: torch.Generator().manual_seed(4)
    drawn = TM.frac_pickup(torch.from_numpy(alpha), gen())
    assert torch.equal(drawn, TM.frac_pickup(torch.from_numpy(alpha), gen()))
