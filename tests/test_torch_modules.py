"""The port's modules against their dpmn_tpu counterparts on the same inputs
and numpy-seeded weights (carried by dpmn_tpu_torch.weights.module_from_jax).
Small sizes; float32 throughout.  Tolerances: rtol=1e-4, atol=1e-5 where the
two run the same arithmetic in other summation orders (as the JAX package's
own converter tests), tighter where a path is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dpmn_tpu.data.glyph_atlas import make_device_glyph_fn
from dpmn_tpu.models.cmm import CMM as JCMM
from dpmn_tpu.models.crnn import CRNN as JCRNN
from dpmn_tpu.models.crnn import parse_crnn_input as j_parse_crnn
from dpmn_tpu.models.pgrm import PGRM as JPGRM
from dpmn_tpu.models.tatt import TSRN_TL_TRANS as JTATT
from dpmn_tpu.models.visionlan import VisionLAN as JVisionLAN
from dpmn_tpu.models.visionlan import parse_visionlan_input as j_parse_vl
from dpmn_tpu.ops.mask_prior import to_mask as j_to_mask
from dpmn_tpu.ops.pixel_shuffle import pixel_shuffle as j_pixel_shuffle
from dpmn_tpu.utils.labels import DIC_36 as J_DIC_36
from dpmn_tpu_torch.data.glyph_atlas import DeviceGlyph
from dpmn_tpu_torch.models.cmm import CMM
from dpmn_tpu_torch.models.crnn import CRNN, parse_crnn_input
from dpmn_tpu_torch.models.pgrm import PGRM
from dpmn_tpu_torch.models.tatt import TSRN_TL_TRANS
from dpmn_tpu_torch.models.visionlan import VisionLAN, parse_visionlan_input
from dpmn_tpu_torch.ops.mask_prior import to_mask
from dpmn_tpu_torch.utils.labels import DIC_36
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc

RTOL, ATOL = 1e-4, 1e-5


def test_labels_match():
    assert DIC_36 == J_DIC_36


def test_to_mask_exact():
    rng = np.random.RandomState(0)
    img = rng.uniform(-0.2, 1.2, (3, 32, 128, 4)).astype(np.float32)
    img[0] = np.round(img[0] * 255) / 255  # values on the uint8 grid
    ref = np.asarray(j_to_mask(jnp.asarray(img)))
    np.testing.assert_array_equal(nhwc(to_mask(nchw(img))), ref)


def test_pixel_shuffle_is_torch():
    x = np.random.RandomState(1).rand(2, 4, 5, 12).astype(np.float32)
    np.testing.assert_array_equal(nhwc(F.pixel_shuffle(nchw(x), 2)), np.asarray(j_pixel_shuffle(jnp.asarray(x), 2)))


def test_parse_inputs_match():
    rng = np.random.RandomState(2)
    img = rng.uniform(-1.0, 1.0, (2, 16, 64, 3)).astype(np.float32)  # tanh'd PSN outputs go negative
    np.testing.assert_allclose(nhwc(parse_crnn_input(nchw(img))), np.asarray(j_parse_crnn(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-6)
    # uint8 trunc/wrap, bilinear resize, re-round: rounding is exact unless a
    # resized value lands within float error of a .5 boundary
    port = nhwc(parse_visionlan_input(nchw(img)))
    ref = np.asarray(j_parse_vl(jnp.asarray(img)))
    assert np.mean(port == ref) > 0.999
    np.testing.assert_allclose(port, ref, atol=1.0 / 255 + 1e-6)


@pytest.mark.parametrize("graphic", [True, False])
def test_pgrm_matches(graphic):
    rng = np.random.RandomState(3 + graphic)
    c = 2 if graphic else 3
    x_q = (rng.rand(2, 32, 128, c) * (255.0 if graphic else 1.0)).astype(np.float32)
    x_kv = rng.rand(2, 32, 128, 3).astype(np.float32)
    res = [rng.rand(2, 32, 128, 3).astype(np.float32) for _ in range(2)]
    kw = dict(embed_dim=48, num_heads=(6,), window_size=(2, 4, 8), iter=2, graphic_mode=graphic)
    jm = JPGRM(**kw)
    variables = init_variables(jm, 5, jnp.asarray(x_q), jnp.asarray(x_kv), ())
    ref = np.asarray(jm.apply(variables, jnp.asarray(x_q), jnp.asarray(x_kv), [jnp.asarray(r) for r in res]))
    port = PGRM(**kw).eval()  # the eval path (K1); train mode runs K3
    module_from_jax(port, variables)
    with torch.no_grad():
        out = nhwc(port(nchw(x_q), nchw(x_kv), [nchw(r) for r in res]))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_cmm_matches():
    rng = np.random.RandomState(6)
    x1, x2 = (rng.rand(2, 32, 128, 3).astype(np.float32) for _ in range(2))
    jm = JCMM()
    variables = init_variables(jm, 7, jnp.asarray(x1), jnp.asarray(x2))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x1), jnp.asarray(x2)))
    port = CMM().eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out = nhwc(port(nchw(x1), nchw(x2)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_tatt_psn_matches():
    rng = np.random.RandomState(8)
    x = rng.rand(2, 16, 64, 4).astype(np.float32)
    emb = rng.dirichlet(np.ones(37), size=(2, 1, 26)).astype(np.float32)  # (B, 1, 26, 37) softmaxed frames
    jm = JTATT(srb_nums=1, out_text_channels=64)
    variables = init_variables(jm, 9, jnp.asarray(x), jnp.asarray(emb), train=False)
    ref, ref_w = jm.apply(variables, jnp.asarray(x), jnp.asarray(emb), train=False)
    port = TSRN_TL_TRANS(srb_nums=1, out_text_channels=64).eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out, w = port(nchw(x), torch.from_numpy(emb.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=RTOL, atol=ATOL)


def test_crnn_matches():
    x = np.random.RandomState(10).rand(2, 32, 100, 1).astype(np.float32)
    jm = JCRNN()
    variables = init_variables(jm, 11, jnp.asarray(x), train=False)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    port = CRNN().eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out = port(nchw(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_visionlan_eval_matches():
    x = np.random.RandomState(12).rand(2, 64, 256, 3).astype(np.float32)
    jm = JVisionLAN()
    variables = init_variables(jm, 13, jnp.asarray(x), train=False)
    ref_logits, ref_len = jm.apply(variables, jnp.asarray(x), train=False)
    port = VisionLAN().eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        logits, lengths = port(nchw(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=RTOL, atol=ATOL)
    # the ids and the first-EOS lengths are exact
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(ref_logits).argmax(-1))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))


def test_glyph_matches_device_glyph_fn():
    """Same ids through the port's DeviceGlyph and the JAX make_device_glyph_fn
    (atlas from the same font).  Values are at uint8 scale; the two take the
    bicubic row/column products in other orders: atol 1e-3."""

    def ids_of(word):
        out = np.zeros(25, np.int32)
        out[: len(word)] = [J_DIC_36.index(ch) + 1 for ch in word]
        return out

    rng = np.random.RandomState(14)
    words = ["hello", "a", "w1ld", "quickbrownfox0123456789ab"]
    ids = np.stack([ids_of(w) for w in words] + [rng.randint(1, 37, 25).astype(np.int32),
                                                 np.zeros(25, np.int32)])
    lengths = np.array([len(w) for w in words] + [13, 0], np.int32)
    ref = np.asarray(make_device_glyph_fn((32, 128))(jnp.asarray(ids), jnp.asarray(lengths)))
    out = DeviceGlyph((32, 128))(torch.from_numpy(ids), torch.from_numpy(lengths))
    assert out.shape == (6, 2, 32, 128)
    np.testing.assert_allclose(nhwc(out), ref, rtol=0, atol=1e-3)
    assert ref[0].max() > 100 and ref[-1].max() == 0.0
