"""The reference's .pth checkpoints in the port's driver, against dpmn_tpu's
load_driver_weights on the same files.

The files are written in the reference's layout from the JAX package's own
test oracles (TorchTSRN, TorchTSRN_TL and TorchCRNN of test_convert.py,
TorchPGRM of test_pgrm_oracle.py, TorchCMM of test_convert_zoo.py, the fake
VisionLAN dict of test_driver_weights.py) and from dicts built here on the
keys convert_tatt and convert_tbsrn read, each with the dead families the
eval tree drops (BatchNorm counts, the STN, TBSRN's head and GRUs, TATT's
decoder self-attention, VisionLAN's MLM branch), every float tensor seeded
random.  One numpy-seeded state goes into a port system through from_jax
twice: one copy takes the JAX package's load of the files (from_jax of its
result), the other the port's own load; every parameter and buffer must be
equal exactly: at test time for every PSN, at train time, through both
.pth file-resume branches, and with the soft skips, whose messages must be
dpmn_tpu's.  The key maps' strictness and the CLI on such files are in
test_torch_reference_checkpoints.py."""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import dpmn_tpu.system as JS
import dpmn_tpu.weights as JW
from dpmn_tpu.config import Args as JArgs
from dpmn_tpu.config import TrainCfg as JTrainCfg
from dpmn_tpu_torch import weights as W
from dpmn_tpu_torch.config import Args, TrainCfg
from dpmn_tpu_torch.system import DPMNSystem
from test_convert import TorchCRNN, TorchTSRN, TorchTSRN_TL
from test_convert_zoo import TorchCMM
from test_driver_weights import _fake_visionlan_sd
from test_pgrm_oracle import TorchPGRM
from test_torch_helpers import random_variables

TINY = dict(mask=True, stu_iter_b1=1, stu_iter_b2=1, patch_size="2,", embed_dim="24,", window_size="2,4,8,",
            depths="1,", num_heads="6,", mlp_ratio="4,", srb=1)
HD_U = {"tsrn": 4, "tpgsr": 4, "tatt": 4, "tbsrn": 32}  # TBSRN's width is fixed at 64 channels
STN_KEYS = ("stn_head.stn_fc2.weight", "tps.inverse_kernel")


# ------------------------------------------------- reference-layout files

def _randomize(sd, seed):
    """Seeded values in every float tensor but PGRM's derived tables;
    BatchNorm variances positive."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point() or "attn_mask_" in k:
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=gen)
        else:
            out[k] = 0.2 * torch.randn(v.shape, generator=gen)
    return out


class _Dict:
    def __init__(self, seed):
        self.sd, self.rng = {}, np.random.RandomState(seed)

    def put(self, name, *shape):
        self.sd[name] = torch.from_numpy(0.2 * self.rng.randn(*shape).astype(np.float32))

    def conv(self, name, i, o, k, bias=True):
        self.put(f"{name}.weight", o, i, k, k)
        if bias:
            self.put(f"{name}.bias", o)

    def lin(self, name, i, o):
        self.put(f"{name}.weight", o, i)
        self.put(f"{name}.bias", o)

    def bn(self, name, c):
        for s in ("weight", "bias", "running_mean"):
            self.put(f"{name}.{s}", c)
        self.sd[f"{name}.running_var"] = torch.from_numpy(self.rng.uniform(0.5, 1.5, c).astype(np.float32))
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(100)

    def ln(self, name, c, a="weight", b="bias"):
        self.put(f"{name}.{a}", c)
        self.put(f"{name}.{b}", c)

    def gru(self, name, i, h):
        for d in ("", "_reverse"):
            self.put(f"{name}.weight_ih_l0{d}", 3 * h, i)
            self.put(f"{name}.weight_hh_l0{d}", 3 * h, h)
            self.put(f"{name}.bias_ih_l0{d}", 3 * h)
            self.put(f"{name}.bias_hh_l0{d}", 3 * h)

    def skeleton_tail(self, srb, ch, in_planes):
        self.conv(f"block{srb + 2}.0", ch, ch, 3)
        self.bn(f"block{srb + 2}.1", ch)
        self.conv(f"block{srb + 3}.0.conv", ch, ch * 4, 3)
        self.conv(f"block{srb + 3}.1", ch, in_planes, 9)


def _tatt_sd(srb, hd_u, seed):
    """The keys convert_tatt reads (convert_psn.py:119-167; the layout of
    test_convert_psn.py's TATT dict) and the dead decoder self-attention."""
    ch = d = 2 * hd_u
    f = _Dict(seed)
    f.conv("block1.0", 4, ch, 9)
    f.put("block1.1.weight", 1)
    for b in range(2, srb + 2):
        f.conv(f"block{b}.conv1", ch, ch, 3)
        f.bn(f"block{b}.bn1", ch)
        f.conv(f"block{b}.conv2", ch, ch, 3)
        f.bn(f"block{b}.bn2", ch)
        f.conv(f"block{b}.gru1.conv1", ch + d, ch, 1)
        f.gru(f"block{b}.gru1.gru", ch, ch // 2)
        f.conv(f"block{b}.gru2.conv1", ch, ch, 1)
        f.gru(f"block{b}.gru2.gru", ch, ch // 2)
    f.lin("infoGen.fc_in", 37, d)
    f.put("infoGen.activation.weight", 1)
    f.put("infoGen.init_factor.weight", 1024, d)
    ut = "infoGen.upsample_transformer"
    f.gru(f"{ut}.gru_encoding", d * 16, d * 8)
    layers = [(f"{ut}.encoder.layers.0", "self_attn", ("norm1", "norm2"))]
    layers += [(f"{ut}.decoder.layers.{i}", "multihead_attn", ("norm2", "norm3")) for i in range(2)]
    for name, attn, norms in layers:
        f.put(f"{name}.{attn}.in_proj_weight", 3 * d, d)
        f.put(f"{name}.{attn}.in_proj_bias", 3 * d)
        f.lin(f"{name}.{attn}.out_proj", d, d)
        f.lin(f"{name}.linear1", d, d)
        f.lin(f"{name}.linear2", d, d)
        for nrm in norms:
            f.ln(f"{name}.{nrm}", d)
    for i in range(2):  # dead: commented out of the decoder layer's forward
        f.put(f"{ut}.decoder.layers.{i}.self_attn.in_proj_weight", 3 * d, d)
        f.ln(f"{ut}.decoder.layers.{i}.norm1", d)
    f.ln(f"{ut}.decoder.norm", d)
    f.skeleton_tail(srb, ch, 4)
    return f.sd


def _tbsrn_sd(srb, seed):
    """The keys convert_tbsrn reads (convert_psn.py:44-76) and its dead ones:
    the unused head conv / bn and every SRB's gru1 / gru2."""
    ch = 64
    f = _Dict(seed)
    f.conv("conv", 3, 3, 3)
    f.bn("bn", 3)
    f.conv("block1.0", 4, ch, 9)
    f.put("block1.1.weight", 1)
    for b in range(2, srb + 2):
        t = f"block{b}"
        f.conv(f"{t}.conv1", ch, ch, 3)
        f.bn(f"{t}.bn1", ch)
        f.conv(f"{t}.conv2", ch, ch, 3)
        f.bn(f"{t}.bn2", ch)
        for g in ("gru1", "gru2"):
            f.conv(f"{t}.{g}.conv1", ch, ch, 1)
            f.gru(f"{t}.{g}.gru", ch, ch // 2)
        fe = f"{t}.feature_enhancer"
        for i in range(4):
            f.lin(f"{fe}.multihead.linears.{i}", 128, 128)
        f.ln(f"{fe}.mul_layernorm1", 128, "a_2", "b_2")
        f.lin(f"{fe}.pff.w_1", 128, 128)
        f.lin(f"{fe}.pff.w_2", 128, 128)
        f.ln(f"{fe}.mul_layernorm3", 128, "a_2", "b_2")
        f.lin(f"{fe}.linear", 128, 64)
    f.skeleton_tail(srb, ch, 4)
    return f.sd


def psn_sd(arch, seed=1):
    srb, hd_u = TINY["srb"], HD_U[arch]
    if arch == "tsrn":
        sd = _randomize(TorchTSRN(srb_nums=srb, hidden_units=hd_u).state_dict(), seed)
    elif arch == "tpgsr":
        sd = _randomize(TorchTSRN_TL(srb_nums=srb, hidden_units=hd_u).state_dict(), seed)
    elif arch == "tatt":
        sd = _tatt_sd(srb, hd_u, seed)
    else:
        sd = _tbsrn_sd(srb, seed)
    sd.update({k: torch.ones(2, 3) for k in STN_KEYS})  # dead: the frozen PSN never runs its STN
    return sd


def student_sd(seed=2):
    sd = {k: torch.from_numpy(v) for k, v in _fake_visionlan_sd(np.random.RandomState(seed)).items()}
    sd.update({"MLM_VRM.MLM.pos_embedding.weight": torch.zeros(26, 512),  # dead: the training branch
               "MLM_VRM.Prediction.pp_share.w0.weight": torch.zeros(256, 26),
               "MLM_VRM.Prediction.w_share.weight": torch.zeros(37, 512),
               "backbone.bn1.num_batches_tracked": torch.tensor(5)})
    return sd


def pgrm_sd(iteration, graphic, seed):
    torch.manual_seed(seed)
    sd = TorchPGRM(graphic=graphic).state_dict()
    for k in range(1, iteration + 1):  # a PGRM of cascade iteration k has k + 1 residual weights
        sd[f"weight_list_{k}"] = torch.ones(1, 3, 32, 128)
    return _randomize(sd, seed)


def write_reference_dir(path: Path, arch: str, refiner: bool = True):
    """The files of a --resume directory for TINY (the student's is
    `students`'); the PGRMs' and CMM's with `refiner`."""
    path.mkdir(parents=True, exist_ok=True)
    bookkeeping = {"info": {"iters": np.int64(1200), "acc": np.float64(0.5)}, "param_num": 123,
                   "best_history_res": {"easy": np.float32(0.25)}, "converge": [{"acc": np.float64(0.5)}]}
    torch.save({"state_dict_G": psn_sd(arch), **bookkeeping}, path / f"model_{arch}.pth")
    torch.save(_randomize(TorchCRNN().state_dict(), 3), path / "recognizer_best_crnn.pth")
    if refiner:
        for i in range(2):
            torch.save({"state_dict_G": pgrm_sd(i, i == 0, 4 + i), **bookkeeping}, path / f"model_best_{i}.pth")
        torch.save(_randomize(TorchCMM(cnum=64).state_dict(), 6), path / "model_best_cmm.pth")
    return path


@pytest.fixture(scope="module")
def students(tmp_path_factory):
    """A --rec_path directory: the one student of TINY."""
    path = tmp_path_factory.mktemp("students")
    torch.save(student_sd(), path / "recognizer_best_0.pth")
    return path


# ------------------------------------------------------------- the pairs

_STATES = {}  # arch → the numpy-seeded JAX state of TINY (its shapes take a trace of init_state)


def _jax(arch, **kw):
    args = JArgs(**{**TINY, "arch": arch, "hd_u": HD_U[arch], **kw})
    jsys = JS.DPMNSystem(JTrainCfg(batch_size=2), args, glyph_mode="zeros")
    if arch not in _STATES:
        shapes = jax.eval_shape(lambda r: jsys.init_state(r, batch_size=2), jax.random.PRNGKey(0))
        _STATES[arch] = random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, 40)
    return jsys, {**_STATES[arch], "opt_state": None, "step": 0}


def _port(arch, state, loaded, **kw):
    """The port's system of TINY on `state`, an untouched copy of it, and a
    copy that takes the JAX package's `loaded` state."""
    system = DPMNSystem(TrainCfg(batch_size=2), Args(**{**TINY, "arch": arch, "hd_u": HD_U[arch], **kw}),
                        device="cpu")
    W.from_jax(state, system)
    want = copy.deepcopy(system)
    W.from_jax(loaded, want)
    return system, copy.deepcopy(system), want


def _assert_same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _differs(a, b, prefix):
    sa, sb = a.state_dict(), b.state_dict()
    return any(not torch.equal(sa[k], sb[k]) for k in sa if k.startswith(prefix))


@pytest.mark.parametrize("arch", ["tsrn", "tpgsr", "tbsrn", "tatt"])
def test_resume_dir_load_matches_jax(arch, students, tmp_path, capsys):
    """--resume DIR: the PSN and crnn_psn (TPGSR, TATT) of every arch at
    train time; for tsrn at test time with --rec_path DIR, also the
    student, both PGRMs and CMM."""
    testing = arch == "tsrn"
    ref = write_reference_dir(tmp_path / "ref", arch, refiner=testing)
    kw = dict(resume=str(ref), rec_path=str(students) if testing else None)
    jsys, state = _jax(arch, **kw)
    loaded = JW.load_driver_weights(jsys, state, JTrainCfg(batch_size=2), jsys.args, testing=testing)
    j_out = capsys.readouterr().out
    port, before, want = _port(arch, state, loaded, **kw)
    W.load_driver_weights(port, TrainCfg(batch_size=2), port.args, testing=testing)
    assert capsys.readouterr().out == j_out
    _assert_same(port, want)
    loaded = ("psn.",) + (("crnn_psn.",) if arch in ("tpgsr", "tatt") else ())
    loaded += ("students.0.", "pgrms.0.", "pgrms.1.", "cmm.") if testing else ()
    for prefix in loaded:
        assert _differs(port, before, prefix), prefix
    for prefix in ("distills.",) + (() if testing else ("students.", "pgrms.", "cmm.")):
        assert not _differs(port, before, prefix), prefix


def test_train_time_loads_match_jax(students, tmp_path, capsys):
    """At train time: the PSN from a .pth file --resume, every student from
    cfg.visionlan_pretrained; and at test time the .pth file --resume, which
    goes into every PGRM (a semantic PGRM passes over the file's
    prior_fusion, and the residual weights it lacks keep their values)."""
    ref = write_reference_dir(tmp_path / "ref", "tsrn")
    for testing, resume in ((False, ref / "model_tsrn.pth"), (True, ref / "model_best_0.pth")):
        kw = dict(resume=str(resume))
        pretrained = "" if testing else str(students / "recognizer_best_0.pth")
        jcfg = JTrainCfg(batch_size=2, visionlan_pretrained=pretrained)
        pcfg = TrainCfg(batch_size=2, visionlan_pretrained=pretrained)
        jsys, state = _jax("tsrn", **kw)
        loaded = JW.load_driver_weights(jsys, state, jcfg, jsys.args, testing=testing)
        j_out = capsys.readouterr().out
        port, before, want = _port("tsrn", state, loaded, **kw)
        W.load_driver_weights(port, pcfg, port.args, testing=testing)
        assert capsys.readouterr().out == j_out
        _assert_same(port, want)
        assert _differs(port, before, "students.0.") != testing
        assert _differs(port, before, "psn.") != testing
        assert _differs(port, before, "pgrms.0.") == _differs(port, before, "pgrms.1.") == testing


def test_soft_skips_match_jax(tmp_path, capsys):
    """A resume directory without crnn_psn, PGRM or CMM files: the same
    messages as dpmn_tpu, nothing loaded."""
    empty = tmp_path / "empty"
    empty.mkdir()
    jsys, state = _jax("tpgsr", resume=str(empty))
    loaded = JW.load_driver_weights(jsys, state, JTrainCfg(batch_size=2), jsys.args, testing=True)
    j_out = capsys.readouterr().out
    port, before, _ = _port("tpgsr", state, loaded, resume=str(empty))
    W.load_driver_weights(port, TrainCfg(batch_size=2), port.args, testing=True)
    assert capsys.readouterr().out == j_out
    assert j_out.count("missing") == 4  # crnn_psn, pgrm_0, pgrm_1, cmm
    _assert_same(port, before)


def test_students_need_visionlan():
    with pytest.raises(ValueError, match="requires visionlan"):
        W.convert_student_state_dict("aster", {}, None)
    with pytest.raises(ValueError, match="no PSN converter"):
        W.convert_psn_state_dict("bicubic", {}, None)
    assert W._student_path("d", 2, "aster") == os.path.join("d", "recognizer_best_2.pth.tar")
