"""The strictness of the port's reference-checkpoint key maps
(dpmn_tpu_torch/convert.py) and the CLI's --test on a reference --resume
directory.  The files are those of test_torch_driver_weights.py, in the
reference's layout with its dead families: each checks out whole, and one
key added, one removed or one of the wrong shape raises and names the key,
with nothing written; an altered derived PGRM table raises; the inverse map
reads back to the module's own tensors; numpy scalars in a checkpoint's
bookkeeping are read and other objects refused; and `python -m
dpmn_tpu_torch.cli --test --resume DIR --rec_path DIR` on the CPU loads
every file and writes its row."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpmn_tpu_torch import convert as C
from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_textzoom_lmdb
from dpmn_tpu_torch.system import init_weights
from test_convert import TorchCRNN
from test_convert_zoo import TorchCMM
from test_torch_driver_weights import pgrm_sd, psn_sd, student_sd, write_reference_dir

ROOT = Path(__file__).resolve().parent.parent


# --------------------------------------------------- the key maps' strictness

def _modules():
    """kind → (a seeded port module, its reference file, one key of it)."""
    from dpmn_tpu_torch.models.cmm import CMM
    from dpmn_tpu_torch.models.crnn import CRNN
    from dpmn_tpu_torch.models.pgrm import PGRM
    from dpmn_tpu_torch.models.tbsrn import TBSRN
    from dpmn_tpu_torch.models.tsrn import TSRN
    from dpmn_tpu_torch.models.visionlan import VisionLAN

    def seeded(make):
        def build():
            m = make()
            init_weights(m, 0)
            return m
        return build

    kinds = {
        "tsrn": (lambda: TSRN(srb_nums=1, hidden_units=4), lambda: psn_sd("tsrn"), "block2.gru1.conv1.weight"),
        "tbsrn": (lambda: TBSRN(srb_nums=1, mask=True), lambda: psn_sd("tbsrn"),
                  "block2.feature_enhancer.multihead.linears.1.weight"),
        "crnn": (CRNN, lambda: TorchCRNN().state_dict(), "rnn.1.embedding.weight"),
        "visionlan": (VisionLAN, student_sd, "MLM_VRM.SequenceModeling.layer_stack.2.pos_ffn.w_1.weight"),
        "pgrm": (lambda: PGRM(embed_dim=24, patch_size=2, window_size=(2, 4, 8), graphic_mode=True),
                 lambda: pgrm_sd(0, True, 7), "layers.0.blocks.1.attn.sknet.fc2.weight"),
        "cmm": (CMM, lambda: TorchCMM(cnum=64).state_dict(), "de_3.decode.4.weight"),
    }
    return {k: (seeded(make), sd, key) for k, (make, sd, key) in kinds.items()}


@pytest.mark.parametrize("fault", ["added", "removed", "shape"])
@pytest.mark.parametrize("kind", ["tsrn", "tbsrn", "crnn", "visionlan", "pgrm", "cmm"])
def test_a_wrong_file_raises_naming_the_key(kind, fault):
    make, sd_of, key = _modules()[kind]
    module, sd = make(), sd_of()
    C.convert_state_dict(module, sd)  # the whole file, its dead keys included, checks out
    if fault == "added":
        key = key.replace("weight", "stray")
        sd[key] = torch.zeros(3)
    elif fault == "removed":
        del sd[key]
    else:
        sd[key] = torch.zeros(*sd[key].shape[:-1], sd[key].shape[-1] + 1)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    with pytest.raises(ValueError if fault == "shape" else KeyError, match=key.replace(".", r"\.")):
        C.load_reference(module, sd, "file")
    assert all(torch.equal(v, before[k]) for k, v in module.state_dict().items())  # nothing written


def test_derived_tables_are_held():
    make, sd_of, _ = _modules()["pgrm"]
    module, sd = make(), sd_of()
    assert {k for k in sd if "attn_mask_" in k or "relative_position_index_" in k} == set(C.key_map(module).derived)
    C.convert_state_dict(module, sd)
    key = "layers.0.blocks.1.attn.attn_mask_2"
    sd[key] = sd[key].clone()
    sd[key][0, 0, 1] += 1.0
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        C.convert_state_dict(module, sd)


def test_round_trip_through_the_reference_layout():
    """`_reference_state_dict` (the inverse map, dead families included)
    reads back to the module's own tensors for every kind of module."""
    for kind, (make, _, _) in _modules().items():
        src, dst = make(), make()
        with torch.no_grad():
            for t in src.state_dict(keep_vars=True).values():
                if t.is_floating_point() and t.dim():
                    t.copy_(torch.randn_like(t))
        C.load_reference(dst, C._reference_state_dict(src), kind)
        for k, v in src.state_dict().items():
            assert k.endswith("num_batches_tracked") or torch.equal(v, dst.state_dict()[k]), (kind, k)


def test_checkpoint_bookkeeping(tmp_path):
    """numpy scalars in `info` and the like are read (weights_only=True
    with those globals allowed); anything else that is no tensor is
    refused, not read by falling back to a full unpickle."""
    sd = {"w": torch.ones(2)}
    torch.save({"state_dict_G": sd, "info": {"acc": np.float64(0.5), "iters": np.int64(3)},
                "best_history_res": {"easy": np.float32(0.1)}}, tmp_path / "ok.pth")
    assert C.load_reference_state_dict(str(tmp_path / "ok.pth")).keys() == {"w"}
    torch.save({"module.w": torch.ones(2)}, tmp_path / "dp.pth")
    assert C.load_reference_state_dict(str(tmp_path / "dp.pth")).keys() == {"w"}
    torch.save({"state_dict_G": sd, "info": {"curve": np.arange(3)}}, tmp_path / "array.pth")
    with pytest.raises(Exception, match="weights_only"):
        C.load_reference_state_dict(str(tmp_path / "array.pth"))


# ----------------------------------------------------------------- the CLI

def test_cli_tests_on_a_reference_resume_dir(tmp_path):
    samples, _ = fixture_samples(str(ROOT / "tests" / "fixtures" / "textzoom_jpeg.npz"))
    write_textzoom_lmdb(str(tmp_path / "easy"), samples[:8])
    ref = write_reference_dir(tmp_path / "ref", "tatt")
    students = tmp_path / "students"
    students.mkdir()
    torch.save(student_sd(), students / "recognizer_best_0.pth")
    config = tmp_path / "tiny.yaml"
    config.write_text(f"TRAIN:\n  batch_size: 4\n  workers: 0\n  ckpt_dir: '{tmp_path / 'ckpt'}'\n"
                      "  VAL:\n    crnn_pretrained: ''\n    visionlan_pretrained: ''\n")
    flags = ["--arch", "tatt", "--mask", "--srb", "1", "--hd_u", "4", "--patch_size", "2,", "--embed_dim", "24,",
             "--window_size", "2,4,8,", "--rec", "crnn", "--config", str(config), "--device", "cpu", "--test",
             "--test_data_dir", str(tmp_path / "easy"), "--resume", str(ref), "--rec_path", str(students)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "dpmn_tpu_torch.cli", *flags], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    for what, where in (("PSN (tatt)", ref), ("crnn_psn", ref), ("student_0 (visionlan)", students),
                        ("pgrm_0", ref), ("pgrm_1", ref), ("cmm", ref)):
        assert f"[weights] {what} loaded from {where}" in r.stdout, what
    rows = (tmp_path / "ckpt" / "test_result.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("crnn,easy,")
