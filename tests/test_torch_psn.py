"""The port's other PSNs against dpmn_tpu's: TSRN (`tsrn` / `tg`), TSRN_TL
(`tpgsr`) and TBSRN module by module, with mask on and off, on the same
numpy-seeded weights (carried by dpmn_tpu_torch.weights.module_from_jax),
B = 2, float32, rtol=1e-4 and atol=1e-5 (the same arithmetic in other
summation orders); and the PSN each arch makes DPMNSystem build.  The whole
sr_forward of each arch is in test_torch_psn_system.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpmn_tpu_torch.system as TS
from dpmn_tpu.models.tbsrn import TBSRN as JTBSRN
from dpmn_tpu.models.tbsrn import positional_encoding_2d as j_positional_encoding_2d
from dpmn_tpu.models.tsrn import TSRN as JTSRN
from dpmn_tpu.models.tsrn import TSRN_TL as JTSRN_TL
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.models.tatt import TSRN_TL_TRANS
from dpmn_tpu_torch.models.tbsrn import TBSRN, positional_encoding_2d
from dpmn_tpu_torch.models.tsrn import TSRN, TSRN_TL
from dpmn_tpu_torch.weights import module_from_jax
from test_torch_helpers import init_variables, nchw, nhwc
from test_torch_system import SMALL

RTOL, ATOL = 1e-4, 1e-5

# (JAX class, port class, hidden_units): TBSRN's FeatureEnhancer fixes its
# features at 64 channels (hd_u 32); the GRU PSNs run narrow
PSNS = {"tsrn": (JTSRN, TSRN, 4), "tpgsr": (JTSRN_TL, TSRN_TL, 4), "tbsrn": (JTBSRN, TBSRN, 32)}


@pytest.mark.parametrize("mask", [True, False], ids=["mask", "rgb"])
@pytest.mark.parametrize("arch", sorted(PSNS))
def test_psn_module_matches(arch, mask):
    jcls, pcls, hd_u = PSNS[arch]
    rng = np.random.RandomState(20)
    x = rng.rand(2, 16, 64, 4 if mask else 3).astype(np.float32)
    jm = jcls(srb_nums=1, mask=mask, hidden_units=hd_u)
    port = pcls(srb_nums=1, mask=mask, hidden_units=hd_u).eval()
    args = (jnp.asarray(x),)
    if arch == "tpgsr":
        emb = rng.dirichlet(np.ones(37), size=(2, 1, 26)).astype(np.float32)  # (B, 1, 26, 37) softmaxed frames
        args += (jnp.asarray(emb),)
    variables = init_variables(jm, 21, *args, train=False)
    ref = np.asarray(jm.apply(variables, *args, train=False))
    module_from_jax(port, variables)
    with torch.no_grad():
        out = port(nchw(x), *([torch.from_numpy(emb.transpose(0, 3, 1, 2).copy())] if arch == "tpgsr" else []))
    assert out.shape == (2, 4 if mask else 3, 32, 128)
    np.testing.assert_allclose(nhwc(out), ref, rtol=RTOL, atol=ATOL)


def test_tpgsr_without_a_prior_matches():
    """TSRN_TL called without a text prior runs on zeros over 26 frames."""
    x = np.random.RandomState(22).rand(2, 16, 64, 4).astype(np.float32)
    jm = JTSRN_TL(srb_nums=1, hidden_units=4)
    variables = init_variables(jm, 23, jnp.asarray(x), train=False)
    port = TSRN_TL(srb_nums=1, hidden_units=4).eval()
    module_from_jax(port, variables)
    with torch.no_grad():
        out = port(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(jm.apply(variables, jnp.asarray(x), train=False)),
                               rtol=RTOL, atol=ATOL)


def test_tbsrn_positional_code_and_width():
    np.testing.assert_array_equal(positional_encoding_2d(64, 16, 64).transpose(1, 2, 0),
                                  j_positional_encoding_2d(64, 16, 64))
    with pytest.raises(ValueError, match="hidden_units 32"):
        TBSRN(hidden_units=16)


@pytest.mark.parametrize("arch", ["tsrn", "tg", "tpgsr", "tbsrn", "tatt"])
def test_psn_types_and_text_prior(arch):
    system = TS.DPMNSystem(TrainCfg(batch_size=2), Args(**{**SMALL, "arch": arch, "stu_iter_b1": 1,
                                                           "stu_iter_b2": 1}), device="cpu")
    want = {"tsrn": TSRN, "tg": TSRN, "tpgsr": TSRN_TL, "tbsrn": TBSRN, "tatt": TSRN_TL_TRANS}[arch]
    assert type(system.psn) is want
    assert system.needs_text_prior == (arch in ("tpgsr", "tatt"))
    assert (system.crnn_psn is None) == (arch not in ("tpgsr", "tatt"))
