"""The judges of the SR output against the JAX package: PSNR and SSIM
(dpmn_tpu.utils.metrics, rtol 1e-5: float32 sums in other orders), the label
codecs (exactly), and the CRNN judge's words on carried parameters
(exactly: the greedy CTC decode of the same logits up to float32 rounding)."""

import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu import evaluator as JE
from dpmn_tpu.models.crnn import CRNN as JCRNN
from dpmn_tpu.utils import labels as JL
from dpmn_tpu.utils import metrics as JM
from dpmn_tpu_torch import evaluator as TE
from dpmn_tpu_torch.utils import labels as TL
from dpmn_tpu_torch.utils import metrics as TM
from test_torch_helpers import init_variables


def _images(seed, b=2, h=32, w=128, c=3):
    return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


@pytest.mark.parametrize("channels", [3, 4])
def test_psnr_ssim_match(channels):
    sr, hr = _images(1, c=channels), _images(2, c=channels)
    hr_near = np.clip(sr + 0.05 * np.random.RandomState(3).randn(*sr.shape), 0, 1).astype(np.float32)
    for ref_img in (hr, hr_near):
        np.testing.assert_allclose(TM.psnr(sr, ref_img).item(), float(JM.psnr(jnp.asarray(sr), jnp.asarray(ref_img))),
                                   rtol=1e-5)
        np.testing.assert_allclose(TM.ssim(sr, ref_img).item(), float(JM.ssim(jnp.asarray(sr), jnp.asarray(ref_img))),
                                   rtol=1e-5)
        np.testing.assert_allclose(TM.ssim(torch.from_numpy(sr), torch.from_numpy(ref_img), size_average=False).numpy(),
                                   np.asarray(JM.ssim(jnp.asarray(sr), jnp.asarray(ref_img), size_average=False)),
                                   rtol=1e-5)


def test_label_codecs_match():
    for voc in ("digit", "lower", "upper", "all"):
        assert TL.get_vocabulary(voc) == JL.get_vocabulary(voc)
        assert TL.char2id(TL.get_vocabulary(voc)) == JL.char2id(JL.get_vocabulary(voc))
        assert TL.id2char(TL.get_vocabulary(voc)) == JL.id2char(JL.get_vocabulary(voc))
        for s in ("Hello, World!", "a1B2-c3 #", "", "ÄÖü9z"):
            assert TL.str_filt(s, voc) == JL.str_filt(s, voc)
    with pytest.raises(KeyError):
        TL.get_vocabulary("greek")
    assert TL.DIC_36 == JL.DIC_36
    alphabet = string.digits + string.ascii_lowercase
    t, j = TL.CTCLabelConverter(alphabet), JL.CTCLabelConverter(alphabet)
    words = ["hello", "w0rld", "a", "zz9"]
    for a, b in zip(t.encode(words), j.encode(words)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(0)
    ids, lengths = rng.randint(0, 37, 40), np.array([10, 15, 0, 15])
    for raw in (False, True):
        assert t.decode(ids, lengths, raw=raw) == j.decode(ids, lengths, raw=raw)
    logits = rng.randn(26, 5, 37).astype(np.float32)
    logits[:, :, 0] += 1.0  # blanks between words, as a trained CTC head gives
    assert t.decode_logits(logits) == j.decode_logits(logits)


def test_crnn_judge_matches():
    variables = init_variables(JCRNN(), 4, jnp.zeros((1, 32, 100, 1)))
    images = _images(5, b=6)
    ref = JE.CRNNEvaluator(params=variables).predict(jnp.asarray(images))
    judge = TE.build_evaluator("crnn", device="cpu", variables=variables)
    out = judge.predict(images)
    assert len(out) == 6 and any(out)
    assert out == ref
    assert judge.predict(torch.from_numpy(images)) == ref  # tensors as numpy arrays


def test_judges_not_ported_raise():
    for kind in ("aster", "moran"):
        with pytest.raises(NotImplementedError):
            TE.build_evaluator(kind, device="cpu")
    with pytest.raises(NotImplementedError):
        TE.build_evaluator("crnn", device="cpu", pretrained="crnn.pth")
    with pytest.raises(ValueError):
        TE.build_evaluator("tesseract", device="cpu")
