"""The judges of the SR output against the JAX package: PSNR and SSIM
(dpmn_tpu.utils.metrics, rtol 1e-5: float32 sums in other orders), the label
codecs and text metrics (exactly), the three judges' words on carried
parameters (exactly: the decode of the same logits up to float32 rounding),
and the reference checkpoints of the three judges read by both packages
(the same words; the port's read is strict)."""

import functools
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpmn_tpu import evaluator as JE
from dpmn_tpu.models.crnn import CRNN as JCRNN
from dpmn_tpu.models.moran import MORAN as JMORAN
from dpmn_tpu.ops.resize import resize as jresize
from dpmn_tpu.utils import labels as JL
from dpmn_tpu.utils import metrics as JM
from dpmn_tpu.utils import text_metrics as JX
from dpmn_tpu_torch import evaluator as TE
from dpmn_tpu_torch.models.stn import init_ctrl_points
from dpmn_tpu_torch.models.tps import _tps_constants
from dpmn_tpu_torch.utils import labels as TL
from dpmn_tpu_torch.utils import metrics as TM
from dpmn_tpu_torch.utils import text_metrics as TX
from test_torch_helpers import aster_variables, init_variables


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
    """A judge the reference does not have raises, and so does every judge
    asked for the card where there is none."""
    with pytest.raises(ValueError):
        TE.build_evaluator("tesseract", device="cpu")
    if not torch.cuda.is_available():
        for kind in ("aster", "moran", "crnn"):
            with pytest.raises(RuntimeError, match="CUDA"):
                TE.build_evaluator(kind)


def _sr_like(seed, b=3):
    """32x128 RGB in [0, 1] as an SR output looks: a bicubic x2 of a random
    16x64 LR."""
    lr = np.random.RandomState(seed).rand(b, 16, 64, 3).astype(np.float32)
    return np.asarray(jresize(jnp.asarray(lr), (32, 128), mode="bicubic")).clip(0, 1)


def _jax_judge(kind, variables, pretrained=""):
    cls = {"aster": JE.AsterEvaluator, "moran": JE.MoranEvaluator, "crnn": JE.CRNNEvaluator}[kind]
    return cls(params=variables, pretrained=pretrained)


@functools.lru_cache(maxsize=None)
def _jax_variables(kind, seed):
    if kind == "aster":
        return aster_variables(seed)
    if kind == "moran":
        return init_variables(JMORAN(), seed, jnp.zeros((1, 32, 100, 1)), num_steps=2)
    return init_variables(JCRNN(), seed, jnp.zeros((1, 32, 100, 1)))


@pytest.mark.parametrize("kind", ["aster", "moran"])
def test_attention_judges_match(kind):
    variables = _jax_variables(kind, 9)
    images = _sr_like(10)
    ref = _jax_judge(kind, variables).predict(jnp.asarray(images))
    judge = TE.build_evaluator(kind, device="cpu", variables=variables)
    out = judge.predict(images)
    assert len(out) == 3 and any(out)
    assert out == ref
    assert judge.predict(torch.from_numpy(images)) == ref


def test_attention_codecs_and_text_metrics_match():
    t, j = TL.AttentionLabelConverter(), JL.AttentionLabelConverter()
    assert t.alphabet == j.alphabet and t.dict == j.dict
    for words in (["Hello", "w0rld", "a"], "zz9"):
        for a, b in zip(t.encode(words), j.encode(words)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 37, 30)
    for lengths in ([10, 20, 0], [30], []):
        assert t.decode(ids, lengths) == j.decode(ids, lengths)
    out_ids = rng.randint(0, 97, (6, 12))
    out_ids[1, 3] = 94  # EOS
    out_ids[2, :4] = 96  # UNKNOWN
    tgt_ids = rng.randint(0, 97, (6, 12))
    for voc in ("all", "lower"):
        ids_v = out_ids % len(TL.get_vocabulary(voc))
        assert TL.aster_get_str_list(ids_v, tgt_ids % len(TL.get_vocabulary(voc)), voc) == \
            JL.aster_get_str_list(ids_v, tgt_ids % len(TL.get_vocabulary(voc)), voc)
    for text in ("Hello, World!", "a1B2-c3 #", "", "ÄÖü9z"):
        assert TL.normalize_text(text) == JL.normalize_text(text)
    pairs = [("kitten", "sitting"), ("", "abc"), ("flaw", "lawn"), ([1, 2, 3], [1, 3]), ("same", "same")]
    for a, b in pairs:
        assert TX.edit_distance(a, b) == JX.edit_distance(a, b)
    tc, jc = TX.AttentionARCounter("t"), JX.AttentionARCounter("j")
    preds, labels = ["Hello|world", "abc", "x", ""], ["hello|word", "abd", "x", "y"]
    assert tc.add_iter(preds, labels) == jc.add_iter(preds, labels)
    assert tc.metrics() == jc.metrics()
    tm, jm = TX.AverageMeter(), JX.AverageMeter()
    for val, n in ((1.5, 2), (3.0, 1), (0.25, 4)):
        tm.update(val, n)
        jm.update(val, n)
    assert vars(tm) == vars(jm)


_CRNN_REFERENCE_NAMES = (("convs.", "cnn.conv"), ("bns.", "cnn.batchnorm"), ("rnn1.", "rnn.0."), ("rnn2.", "rnn.1."))


def _reference_checkpoint(kind, path, seed, drop=None, extra=None):
    """A checkpoint under the reference's key names, with seeded numpy
    values, in the layout the reference ships: ASTER {"state_dict": ...}
    with its BNs' num_batches_tracked and its TPS buffers, MORAN with
    DataParallel "module." prefixes, CRNN a plain dict."""
    model = TE.build_evaluator(kind, device="cpu").model
    rng = np.random.RandomState(seed)
    sd = {}
    for k, t in model.state_dict().items():
        shape = tuple(t.shape)
        if k.endswith("num_batches_tracked"):
            if kind == "aster":
                sd[k] = torch.tensor(0)
            continue
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        sd[k] = torch.from_numpy(np.asarray(v, np.float32))
    if kind == "aster":  # the reference's STN start, moved a little (see aster_variables)
        sd["stn_head.stn_fc2.bias"] = torch.from_numpy(init_ctrl_points(20).reshape(-1))
        sd["stn_head.stn_fc2.weight"] *= 0.1
    if kind == "crnn":
        for port, ref in _CRNN_REFERENCE_NAMES:
            sd = {(ref + k[len(port):] if k.startswith(port) else k): v for k, v in sd.items()}
    if drop:
        del sd[drop]
    if extra:
        sd[extra] = torch.zeros(3)
    if kind == "aster":
        inv_k, repr_mat, ctrl = (torch.from_numpy(a) for a in _tps_constants(32, 100, 20, (0.05, 0.05)))
        sd.update({"tps.inverse_kernel": inv_k, "tps.padding_matrix": torch.zeros(3, 2),
                   "tps.target_coordinate_repr": repr_mat, "tps.target_control_points": ctrl})
        sd = {"state_dict": sd}
    elif kind == "moran":
        sd = {"module." + k: v for k, v in sd.items()}
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("kind", ["aster", "moran", "crnn"])
def test_reference_checkpoint_round_trip(kind, tmp_path):
    path = _reference_checkpoint(kind, tmp_path / f"{kind}.pth", 12)
    images = _sr_like(13)
    ref = _jax_judge(kind, _jax_variables(kind, 9), pretrained=str(path)).predict(jnp.asarray(images))
    judge = TE.build_evaluator(kind, device="cpu", pretrained=str(path))
    assert judge.predict(images) == ref
    assert judge.predict(images) != TE.build_evaluator(kind, device="cpu").predict(images)
    first = {"aster": "encoder.layer0.0.weight", "moran": "MORN.cnn.1.weight", "crnn": "cnn.conv0.weight"}[kind]
    for bad in (dict(drop=first), dict(extra="encoder.layer9.weight")):
        bad_path = _reference_checkpoint(kind, tmp_path / "bad.pth", 12, **bad)
        with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
            TE.build_evaluator(kind, device="cpu", pretrained=str(bad_path))
