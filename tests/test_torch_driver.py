"""The port's driver against dpmn_tpu's: the CLI's options and defaults, the
YAML reader against yaml.safe_load, the config loader, the checkpoint round
trip, a two-step Trainer.train on the committed JPEG fixture's LMDB at a
tiny geometry (TATT PSN, srb 1, embed 24, one student and one PGRM per
branch, B = 2) with its CSV rows and file names, what the port refuses, and
evaluate() / test() against the JAX Trainer (glyph_mode="atlas") on the same
numpy-seeded state and CRNN judge: words and accuracy equal, PSNR and SSIM
within 1e-5."""

import csv
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dpmn_tpu.config as JCfg
import dpmn_tpu.evaluator as JE
import dpmn_tpu.train as JT
import dpmn_tpu_torch.config as PCfg
from dpmn_tpu.models.crnn import CRNN as JCRNN
from dpmn_tpu_torch.checkpoint import load_checkpoint, resolve_native_checkpoint, save_checkpoint
from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_textzoom_lmdb
from dpmn_tpu_torch.evaluator import build_evaluator
from dpmn_tpu_torch.system import DPMNSystem
from dpmn_tpu_torch.train import Trainer
from dpmn_tpu_torch.weights import from_jax
from test_torch_helpers import init_variables, random_variables

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "textzoom_jpeg.npz"
TINY = dict(arch="tatt", mask=True, stu_iter_b1=1, stu_iter_b2=1, patch_size="2,", embed_dim="24,",
            window_size="2,4,8,", depths="1,", num_heads="6,", mlp_ratio="4,", srb=1)


@pytest.fixture(scope="module")
def lmdbs(tmp_path_factory):
    """The fixture's records as they are, and as a val set whose every label
    is "x" (a judge that always reads "x" scores 1.0 on it)."""
    root = tmp_path_factory.mktemp("lmdbs")
    samples, _ = fixture_samples(str(FIXTURE))
    write_textzoom_lmdb(str(root / "train"), samples[:16])
    write_textzoom_lmdb(str(root / "easy"), [(hr, lr, "x") for hr, lr, _ in samples[16:24]])
    write_textzoom_lmdb(str(root / "medium"), samples[24:32])
    return root


def _cfg(pkg, root, ckpt, **kw):
    return pkg.TrainCfg(**{**dict(batch_size=2, epochs=1, workers=0, ckpt_dir=str(ckpt), valInterval=2,
                                  saveInterval=2, displayInterval=1, train_data_dir=[str(root / "train")],
                                  val_data_dir=[str(root / "easy"), str(root / "medium")]), **kw})


def _args(pkg, **kw):
    return pkg.Args(**{**TINY, "rec": "crnn", **kw})


# ------------------------------------------------------------ config, CLI

def test_parser_options_and_defaults_match_jax():
    j, p = JCfg.build_arg_parser(), PCfg.build_arg_parser()
    jo = {a.dest: a for a in j._actions if a.dest != "help"}
    po = {a.dest: a for a in p._actions if a.dest != "help"}
    assert set(po) == set(jo) | {"device"}
    for dest, a in jo.items():
        b = po[dest]
        assert (b.option_strings, b.type, b.choices, b.nargs, type(b)) == \
            (a.option_strings, a.type, a.choices, a.nargs, type(a)), dest
        if dest != "test_data_dir":  # the JAX default is an absolute path of its own
            assert b.default == a.default, dest
    assert po["device"].default is None
    ns = p.parse_args(["--arch", "tatt", "--mask", "--corrected", "--grad_accum", "4", "--device", "cpu"])
    args = PCfg.args_from_namespace(ns)
    jargs = JCfg.args_from_namespace(j.parse_args(["--arch", "tatt", "--mask", "--corrected", "--grad_accum", "4"]))
    assert args.device == "cpu"
    assert {k: v for k, v in vars(args).items() if k not in ("device", "test_data_dir")} == \
        {k: v for k, v in vars(jargs).items() if k != "test_data_dir"}
    assert {f: getattr(PCfg.TrainCfg(), f) for f in vars(JCfg.TrainCfg())} == vars(JCfg.TrainCfg())


YAML_CASES = [
    "a: 1\nb: -2\nc: 0.5\nd: 1e-3\ne: .5\nf: 1.e+3\ng: yes\nh: ~\ni:\nj: 'x y'\nk: \"q\"\n",
    "l: [1, 'a', 2.0,\n   true]   # a comment\nm: []\nn: a b # c\no: a#b\np:\n  q: 1\n  r:\n    s: [x,]\n",
    "x: 1_000\ny: -0\nz: +3\nw: 3.\nv: It's\nu: 'it''s'\nt: Off\n",
]


@pytest.mark.parametrize("text", [(ROOT / "config" / "super_resolution.yaml").read_text(),
                                  (ROOT / "config" / "smoke.yaml").read_text()] + YAML_CASES)
def test_yaml_reader_against_pyyaml(text):
    assert PCfg.read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: &x 1\n", "a: {b: 1}\n", "a: [[1]]\n", "a: 0x10\n",
                                  "a: 010\n", "a: .inf\n", "a: 2020-01-01\n", "a: |\n  t\n", "---\na: 1\n",
                                  "a: 1\na: 2\n", "a: \"x\\n\"\n", "a: 1:20\n", "a: [1, 2\n", "a: 1\n  b: 2\n"])
def test_yaml_reader_refuses_what_it_does_not_handle(text):
    with pytest.raises(PCfg.YamlSubsetError):
        PCfg.read_yaml(text)


@pytest.mark.parametrize("name", ["super_resolution.yaml", "smoke.yaml"])
def test_load_train_cfg_matches_jax(name):
    path = str(ROOT / "config" / name)
    assert vars(PCfg.load_train_cfg(path)) == vars(JCfg.load_train_cfg(path))


# ------------------------------------------------------------- checkpoint

def _images(seed, b=2):
    rng = np.random.RandomState(seed)
    return rng.rand(b, 32, 128, 4).astype(np.float32), rng.rand(b, 16, 64, 4).astype(np.float32)


def test_checkpoint_round_trip(tmp_path):
    cfg, args = PCfg.TrainCfg(batch_size=2), PCfg.Args(**TINY)
    a = DPMNSystem(cfg, args, device="cpu", seed=1)
    b = DPMNSystem(cfg, args, device="cpu", seed=2)
    hr, lr = _images(0)
    fresh = tmp_path / "fresh.pt"
    save_checkpoint(str(fresh), a, {"iters": 0})  # before the first update: no optimizer state
    a.train_step(hr, lr, 3)
    path = tmp_path / "ckpt" / "checkpoint.pt"
    save_checkpoint(str(path), a, {"epoch": 0, "iters": 1, "converge": [{"acc": 0.5}]})
    assert not list(path.parent.glob("*.tmp"))
    _, info = load_checkpoint(str(path), b)
    assert info == {"epoch": 0, "iters": 1, "converge": [{"acc": 0.5}]} and b.step == a.step == 1
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k in s:
            assert torch.equal(s[k], sb["state"][i][k]), (i, k)
    # the next step from the restored state is the same step
    hr, lr = _images(1)
    ma, mb = a.train_step(hr, lr, 4), b.train_step(hr, lr, 4)
    assert ma["loss"].item() == mb["loss"].item() and ma["grad_norm"].item() == mb["grad_norm"].item()
    for x, y in zip(a.trainable_parameters(), b.trainable_parameters()):
        assert torch.equal(x, y)
    c = DPMNSystem(cfg, args, device="cpu", seed=5)
    load_checkpoint(str(fresh), c)
    assert c.optimizer is None and c.step == 0
    with pytest.raises(RuntimeError):
        load_checkpoint(str(path), DPMNSystem(cfg, PCfg.Args(**dict(TINY, embed_dim="48,")), device="cpu"))


def test_resolve_native_checkpoint(tmp_path):
    assert resolve_native_checkpoint("") == resolve_native_checkpoint(str(tmp_path / "none")) == ""
    assert resolve_native_checkpoint(str(tmp_path)) == ""
    for name in ("checkpoint.pt", "model_best_sum.pt", "model_0.pth", "checkpoint.msgpack"):
        (tmp_path / name).write_bytes(b"")
    assert resolve_native_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint.pt")
    assert resolve_native_checkpoint(str(tmp_path), testing=True) == str(tmp_path / "model_best_sum.pt")
    assert resolve_native_checkpoint(str(tmp_path / "model_best_sum.pt")) == str(tmp_path / "model_best_sum.pt")
    assert resolve_native_checkpoint(str(tmp_path / "model_0.pth")) == ""
    assert resolve_native_checkpoint(str(tmp_path / "checkpoint.msgpack")) == ""
    (tmp_path / "checkpoint.pt").unlink()
    assert resolve_native_checkpoint(str(tmp_path)) == str(tmp_path / "model_best_sum.pt")


# ---------------------------------------------------------------- Trainer

def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_trainer_train_two_steps(lmdbs, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    trainer = Trainer(_cfg(PCfg, lmdbs, ckpt), _args(PCfg), device="cpu")
    trainer.evaluator = types.SimpleNamespace(predict=lambda sr: ["x"] * sr.shape[0])
    system = trainer.train(max_iters=2, max_batches_eval=1)
    assert system is trainer.system and system.step == 2
    out = capsys.readouterr().out
    assert out.count("| Epoch: [0][") == 2 and "[1 / 8] | Loss: " in out and "[2 / 8]" in out
    rows = _rows(ckpt / "log.csv")
    assert rows[0] == ["epoch", "dataset", "accuracy", "psnr_avg", "ssim_avg", "best", "best_sum"]
    assert [r[:3] for r in rows[1:]] == [["0", "easy", "1.0"], ["0", "medium", "0.0"], ["0", "", ""]]
    assert rows[1][5:] == ["best_easy"] and len(rows[2]) == 5 and rows[3] == ["0", "", "", "", "", "", "best_sum"]
    assert all(np.isfinite(float(v)) for r in rows[1:3] for v in r[3:5])
    assert sorted(os.listdir(ckpt)) == ["checkpoint.pt", "log.csv", "model_best_easy.pt", "model_best_sum.pt"]
    _, info = load_checkpoint(str(ckpt / "model_best_easy.pt"))
    assert info["iters"] == 2 and info["accuracy"] == 1.0 and info["images"] == 2
    assert load_checkpoint(str(ckpt / "checkpoint.pt"))[0]["step"] == 2

    # a fresh Trainer resumes from the rolling checkpoint and appends to log.csv
    again = Trainer(_cfg(PCfg, lmdbs, ckpt, resume=str(ckpt)), _args(PCfg), device="cpu")
    again.evaluator = trainer.evaluator
    again.train(max_iters=2, max_batches_eval=1)
    out = capsys.readouterr().out
    assert f"resumed from {ckpt / 'checkpoint.pt'}" in out and "crnn_psn artifact missing" in out
    assert again.system.step == 4 and len(_rows(ckpt / "log.csv")) == 7  # best tracking starts afresh


def test_trainer_grad_accum_and_rotation(lmdbs, tmp_path):
    trainer = Trainer(_cfg(PCfg, lmdbs, tmp_path, batch_size=4), _args(PCfg, grad_accum=2, rotate_train=5.0),
                      device="cpu")
    calls = []
    accum = trainer.system.accum_train_step
    trainer.system.accum_train_step = lambda *a: calls.append(a[2:]) or accum(*a)
    trainer.train(max_iters=1)
    assert len(calls) == 1 and calls[0][1] == 2 and trainer.system.step == 1
    with pytest.raises(ValueError, match="divisible"):
        Trainer(_cfg(PCfg, lmdbs, tmp_path, batch_size=3), _args(PCfg, grad_accum=2), device="cpu")


def test_trainer_refuses_what_is_not_ported(lmdbs, tmp_path, monkeypatch):
    cfg = _cfg(PCfg, lmdbs, tmp_path)
    with pytest.raises(NotImplementedError, match="DDP"):
        Trainer(cfg, _args(PCfg, data_parallel=2), device="cpu")
    monkeypatch.setenv("DPMN_TPU_TRAIN_DTYPE", "bfloat16")  # bf16 AMP: ported, the system takes it
    assert Trainer(cfg, _args(PCfg), device="cpu").system.train_dtype == "bfloat16"
    monkeypatch.setenv("DPMN_TPU_TRAIN_DTYPE", "float16")
    with pytest.raises(ValueError, match="float16"):
        Trainer(cfg, _args(PCfg), device="cpu")
    monkeypatch.delenv("DPMN_TPU_TRAIN_DTYPE")
    with pytest.raises(NotImplementedError, match="item 7b"):
        Trainer(cfg, _args(PCfg, synthetic_data=True), device="cpu").get_train_loader()
    trainer = Trainer(cfg, _args(PCfg), device="cpu")
    with pytest.raises(NotImplementedError, match="visualization"):
        trainer.evaluate(trainer.system, [], vis_index=0)
    with pytest.raises(NotImplementedError, match=r"item 7e"):
        Trainer(_cfg(PCfg, lmdbs, tmp_path, resume=str(tmp_path / "checkpoint.msgpack")), _args(PCfg),
                device="cpu").load_test_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, _args(PCfg))


@pytest.fixture(scope="module")
def pair(lmdbs, tmp_path_factory):
    """A JAX and a port Trainer on one numpy-seeded state and one CRNN judge."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    jtr = JT.Trainer(_cfg(JCfg, lmdbs, ckpt / "jax"), _args(JCfg, test_data_dir=str(lmdbs / "medium")),
                     glyph_mode="atlas")
    shapes = jax.eval_shape(lambda r: jtr.system.init_state(r, batch_size=2), jax.random.PRNGKey(0))
    state = random_variables({k: shapes[k] for k in ("params", "batch_stats", "frozen")}, 3)
    ptr = Trainer(_cfg(PCfg, lmdbs, ckpt / "port"), _args(PCfg, test_data_dir=str(lmdbs / "medium")),
                  device="cpu")
    from_jax(state, ptr.system)
    judge = init_variables(JCRNN(), 4, jnp.zeros((1, 32, 100, 1)))
    words = {"jax": [], "port": []}
    j_eval, p_eval = JE.CRNNEvaluator(params=judge), build_evaluator("crnn", device="cpu", variables=judge)
    jtr.evaluator = types.SimpleNamespace(predict=lambda sr: words["jax"].extend(j_eval.predict(sr)) or words["jax"][-len(sr):])
    ptr.evaluator = types.SimpleNamespace(predict=lambda sr: words["port"].extend(p_eval.predict(sr)) or words["port"][-len(sr):])
    return jtr, state, ptr, words


def _close(md_p, md_j):
    assert md_p["accuracy"] == md_j["accuracy"] and md_p["images"] == md_j["images"]
    np.testing.assert_allclose(md_p["psnr_avg"], md_j["psnr_avg"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(md_p["ssim_avg"], md_j["ssim_avg"], rtol=0, atol=1e-5)


def test_evaluate_against_jax(pair):
    jtr, state, ptr, words = pair
    (jname, jl), (pname, pl) = jtr.get_val_loaders()[1], ptr.get_val_loaders()[1]
    assert jname == pname == "medium"
    md_j = jtr.evaluate(state, jl, max_batches=2)
    md_p = ptr.evaluate(ptr.system, pl, max_batches=2)
    assert words["jax"] == words["port"] and len(words["port"]) == 4
    _close(md_p, md_j)


def test_test_row_against_jax(pair):
    jtr, state, ptr, words = pair
    rj = jtr.test(state, max_batches=2)
    rp = ptr.test(ptr.system, max_batches=2)
    assert words["jax"][-4:] == words["port"][-4:]
    assert rp["accuracy"] == rj["accuracy"] and rp["duration"] > 0
    np.testing.assert_allclose([rp["psnr_avg"], rp["ssim_avg"]], [rj["psnr_avg"], rj["ssim_avg"]], rtol=0, atol=1e-5)
    jrows = _rows(Path(jtr.cfg.ckpt_dir) / "test_result.csv")
    prows = _rows(Path(ptr.cfg.ckpt_dir) / "test_result.csv")
    assert prows[0] == jrows[0] == ["recognizer", "subset", "accuracy", "psnr", "ssim"]
    assert len(prows) == len(jrows) == 2 and prows[1][:3] == jrows[1][:3] == ["crnn", "medium", str(rj["accuracy"]["medium"])]
    np.testing.assert_allclose([float(v) for v in prows[1][3:]], [float(v) for v in jrows[1][3:]], atol=1e-5)


def test_cli_trains_and_tests_on_the_cpu(lmdbs, tmp_path):
    config = tmp_path / "tiny.yaml"
    config.write_text(
        "TRAIN:\n"
        f"  train_data_dir: ['{lmdbs / 'train'}']\n"
        "  batch_size: 4\n  epochs: 1\n  workers: 2\n"
        f"  ckpt_dir: '{tmp_path / 'ckpt'}'\n"
        "  saveInterval: 2\n  displayInterval: 1\n  manualSeed: 2\n"
        "  VAL:\n"
        f"    val_data_dir: ['{lmdbs / 'medium'}']\n"
        "    valInterval: 100\n    rec_pretrained: ''\n    crnn_pretrained: ''\n")
    flags = ["--arch", "tatt", "--mask", "--srb", "1", "--patch_size", "2,", "--embed_dim", "24,",
             "--window_size", "2,4,8,", "--rec", "crnn", "--config", str(config), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    run = lambda extra: subprocess.run([sys.executable, "-m", "dpmn_tpu_torch.cli", *flags, *extra], cwd=tmp_path,
                                       env=env, capture_output=True, text=True, timeout=600)
    r = run([])
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("| Loss: ") == 4  # 16 records, batch 4, one epoch
    r = run(["--test", "--test_data_dir", str(lmdbs / "medium"), "--resume", str(tmp_path / "ckpt")])
    assert r.returncode == 0, r.stderr
    assert "test state restored from" in r.stdout
    rows = _rows(tmp_path / "ckpt" / "test_result.csv")
    assert len(rows) == 2 and rows[1][:2] == ["crnn", "medium"]
    r = subprocess.run([sys.executable, "-m", "dpmn_tpu_torch.cli", *flags[:-2]], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    if not torch.cuda.is_available():
        assert r.returncode != 0 and "CUDA" in r.stderr
