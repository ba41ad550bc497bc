"""Training / evaluation / test driver (the TextSR equivalent).

Counterpart of dpmn_tpu/train.py, with the system as the state: a
`DPMNSystem` holds the weights, the BatchNorm statistics and the optimizer,
and its train steps update it in place.  Parity targets (reference
interfaces/super_resolution.py):
  * train (:25-337): epoch/batch loop, displayInterval wall-clock prints,
    valInterval eval over the val sets with best-accuracy tracking and
    checkpointing, saveInterval checkpoints, log.csv rows
    [epoch, dataset, acc, psnr, ssim, best*] (main.py:27-31)
  * eval (:340-513): PSN → cascade → CMM → α-blend, PSNR/SSIM means over
    batches, recognizer word accuracy vs str_filt(label, 'lower')
  * test (:515-776): same + per-image duration, test_result.csv rows
    [rec, subset, acc, psnr, ssim]; the students read images_lr_psn
    (:648), the system's glyph_from_psn.

Each train step's dropout seed and the rotation angles are drawn from the
generator `set_seed` returns, where the JAX package splits its key.
DPMN_TPU_TRAIN_DTYPE=bfloat16 trains with bf16 mixed precision (float32
masters, Adam state, statistics and losses; DPMNSystem `train_dtype`), as
dpmn_tpu/train.py:52-56 reads it; checkpoints hold the float32 state either
way.  What the port cannot run yet raises NotImplementedError naming its
ROADMAP item (queue 1, items 7b-7h); nothing is quietly ignored.
"""

from __future__ import annotations

import csv
import os
import time
from datetime import datetime

import numpy as np
import torch

from . import resolve_device
from .checkpoint import SUFFIX, evaluator_pretrained_path, load_checkpoint, resolve_native_checkpoint, save_checkpoint
from .config import Args, TrainCfg
from .data.collate import AlignCollate
from .data.datasets import ConcatDataset, DataLoader, TextZoomLMDB
from .data.prefetch import prefetch_to_device
from .evaluator import build_evaluator
from .ops.rotate import random_rotate
from .system import DPMNSystem
from .utils import metrics as M
from .utils.labels import str_filt
from .utils.seed import draw_seed, set_seed
from .weights import load_driver_weights

def _refuse_msgpack(resume: str) -> None:
    if resume and resume.endswith(".msgpack"):
        raise NotImplementedError(f"--resume {resume}: reading dpmn_tpu's .msgpack checkpoints is not ported yet: "
                                  "ROADMAP queue 1, item 7e")


class Trainer:
    def __init__(self, cfg: TrainCfg, args: Args, device=None):
        self.cfg = cfg
        self.args = args
        self.device = resolve_device(device or args.device)
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        # DPMN_TPU_TRAIN_DTYPE=bfloat16: bf16 mixed-precision training.  The
        # JAX driver's slowdown warning for it (dpmn_tpu/train.py:272-303)
        # fires on a TPU alone, for an XLA runtime fault there; it is not
        # ported.
        train_dtype = os.environ.get("DPMN_TPU_TRAIN_DTYPE") or None
        n_dp = args.data_parallel or cfg.ngpu
        if n_dp > 1:
            raise NotImplementedError(f"data parallelism over {n_dp} devices (--data_parallel / ngpu) is not ported "
                                      "yet: ROADMAP queue 1, item 7h (DDP)")
        self.rng = set_seed(cfg.manualSeed)
        self.system = DPMNSystem(cfg, args, device=self.device, seed=cfg.manualSeed, train_dtype=train_dtype)
        self.batch_size = args.batch_size or cfg.batch_size
        self.evaluator = None
        # --grad_accum N: one optimizer step per N sequential microbatches
        # (batch_size is the global batch; DPMNSystem.accum_train_step)
        self.grad_accum = max(int(args.grad_accum or 1), 1)
        if self.batch_size % self.grad_accum:
            raise ValueError(f"batch_size={self.batch_size} is not divisible by grad_accum={self.grad_accum}")

    # ------------------------------------------------------------------ data

    def _dataset(self, root, test: bool):
        if self.args.synthetic_data:
            # dpmn_tpu's SyntheticTextZoom draws TrueType text from a system font
            raise NotImplementedError("--synthetic_data (SyntheticTextZoom) is not ported yet: ROADMAP queue 1, "
                                      "item 7b")
        return TextZoomLMDB(root, voc_type=self.cfg.voc_type, max_len=self.cfg.max_len, test=test)

    def _collate(self, train: bool) -> AlignCollate:
        return AlignCollate(img_h=self.cfg.height, img_w=self.cfg.width,
                            down_sample_scale=self.cfg.down_sample_scale, mask=self.args.mask, train=train,
                            e_substitution=not train)

    def get_train_loader(self):
        roots = self.cfg.train_data_dir or [None]
        ds = ConcatDataset([self._dataset(r, False) for r in roots])
        return DataLoader(ds, self.batch_size, self._collate(True), shuffle=True, drop_last=True,
                          seed=self.cfg.manualSeed, workers=self.cfg.workers)

    def get_val_loaders(self):
        out = []
        for r in self.cfg.val_data_dir or [None]:
            name = (r or "synthetic").rstrip("/").split("/")[-1]
            out.append((name, DataLoader(self._dataset(r, True), self.batch_size, self._collate(False),
                                         shuffle=True, drop_last=False, workers=self.cfg.workers)))
        return out

    def _rotate(self, lr: torch.Tensor, hr: torch.Tensor):
        """NHWC batches through the NCHW rotation, with angles from self.rng."""
        lr, hr = random_rotate(lr.permute(0, 3, 1, 2), hr.permute(0, 3, 1, 2), self.rng, self.args.rotate_train)
        return lr.permute(0, 2, 3, 1).contiguous(), hr.permute(0, 2, 3, 1).contiguous()

    # ------------------------------------------------------------------ eval

    def evaluate(self, system: DPMNSystem, loader, max_batches: int = None, vis_index=None,
                 test_mode: bool = False) -> dict:
        if vis_index is not None:
            raise NotImplementedError("the visualization dumps (vis_index) are not ported yet: ROADMAP queue 1, "
                                      "item 7g")
        if self.evaluator is None:
            # the --rec judge, from the VAL-config checkpoint when one is
            # named (rec/moran/crnn_pretrained — base.py:375-439)
            self.evaluator = build_evaluator(self.args.rec, device=self.device, seed=7, voc_type=self.cfg.voc_type,
                                             pretrained=evaluator_pretrained_path(self.args.rec, self.cfg))
        n_correct, n_images = 0, 0
        psnrs, ssims = [], []
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            hr, lr, _, _, label_strs, _ = batch
            hr = torch.from_numpy(hr).to(self.device)
            lr = torch.from_numpy(lr).to(self.device)
            if self.args.rotate_test:
                # quirk parity: eval rotates by the rotate_TRAIN magnitude
                # (super_resolution.py:360)
                lr, hr = self._rotate(lr, hr)
            sr = system.sr_forward(lr, glyph_from_psn=test_mode)
            psnrs.append(float(M.psnr(sr, hr)))
            ssims.append(float(M.ssim(sr, hr)))
            for pred, target in zip(self.evaluator.predict(sr), label_strs):
                if pred == str_filt(target, "lower"):
                    n_correct += 1
            n_images += lr.shape[0]
        return {
            "accuracy": round(n_correct / max(n_images, 1), 4),
            "psnr_avg": round(float(np.mean(psnrs)), 6),
            "ssim_avg": round(float(np.mean(ssims)), 6),
            "images": n_images,
        }

    # ----------------------------------------------------------------- train

    def _step(self, hr, lr) -> dict:
        seed = draw_seed(self.rng)
        if self.grad_accum == 1:
            return self.system.train_step(hr, lr, seed)
        return self.system.accum_train_step(hr, lr, seed, self.grad_accum)

    def train(self, max_iters: int = None, max_batches_eval: int = None) -> DPMNSystem:
        cfg = self.cfg
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        log_path = os.path.join(cfg.ckpt_dir, "log.csv")
        if not os.path.exists(log_path):
            with open(log_path, "w", newline="") as out:
                csv.writer(out).writerow(["epoch", "dataset", "accuracy", "psnr_avg", "ssim_avg", "best", "best_sum"])

        train_loader = self.get_train_loader()
        val_loaders = self.get_val_loaders()
        _refuse_msgpack(self.args.resume or cfg.resume)
        # pretrained reference artifacts named by the config: the frozen PSN
        # from the resume directory, crnn_psn, the students (base.py:163-197,
        # 452-471; super_resolution.py:93-111)
        load_driver_weights(self.system, cfg, self.args, testing=False)
        # auto-resume from this package's full-state checkpoint (base.py:43)
        resume_path = resolve_native_checkpoint(self.args.resume or cfg.resume, testing=False)
        if resume_path:
            _, info = load_checkpoint(resume_path, self.system)
            print(f"resumed from {resume_path}: {info}")

        best_history_acc = {name: 0.0 for name, _ in val_loaders}
        best_acc = 0.0
        converge_list = []
        iters = 0
        start = time.time()
        for epoch in range(cfg.epochs):
            for j, batch in enumerate(prefetch_to_device(iter(train_loader), size=2, device=self.device)):
                hr, _, lr, _, _, _, _, _, _ = batch
                iters += 1
                if self.args.rotate_train:
                    lr, hr = self._rotate(lr, hr)
                m = self._step(hr, lr)
                self._last_metrics = m  # 0-d device tensors, no sync

                if iters % cfg.displayInterval == 0:
                    loss = float(m["loss"])
                    dur = time.time() - start
                    print(f"[{datetime.now():%Y-%m-%d %H:%M:%S}] | Epoch: [{epoch}][{j + 1} / "
                          f"{len(train_loader)}] | Loss: {loss} | Duration: {dur}s")
                    start = time.time()

                if iters % cfg.valInterval == 0:
                    current = {}
                    for name, loader in val_loaders:
                        md = self.evaluate(self.system, loader, max_batches=max_batches_eval)
                        converge_list.append(
                            {"iterator": iters, "acc": md["accuracy"], "psnr": md["psnr_avg"], "ssim": md["ssim_avg"]})
                        current[name] = md["accuracy"]
                        is_best = md["accuracy"] > best_history_acc[name]
                        if is_best:
                            best_history_acc[name] = md["accuracy"]
                            save_checkpoint(os.path.join(cfg.ckpt_dir, f"model_best_{name}{SUFFIX}"), self.system,
                                            {"epoch": epoch, "iters": iters, **md, "converge": converge_list})
                        with open(log_path, "a", newline="") as out:
                            row = [epoch, name, md["accuracy"], md["psnr_avg"], md["ssim_avg"]]
                            csv.writer(out).writerow(row + ([f"best_{name}"] if is_best else []))
                    if sum(current.values()) > best_acc:
                        best_acc = sum(current.values())
                        save_checkpoint(os.path.join(cfg.ckpt_dir, f"model_best_sum{SUFFIX}"), self.system,
                                        {"epoch": epoch, "iters": iters, "acc": current})
                        with open(log_path, "a", newline="") as out:
                            csv.writer(out).writerow([epoch, "", "", "", "", "", "best_sum"])

                if iters % cfg.saveInterval == 0:
                    save_checkpoint(os.path.join(cfg.ckpt_dir, f"checkpoint{SUFFIX}"), self.system,
                                    {"epoch": epoch, "iters": iters, "converge": converge_list})
                if max_iters is not None and iters >= max_iters:
                    return self.system
        return self.system

    # ------------------------------------------------------------------ test

    def load_test_state(self) -> DPMNSystem:
        """The test-time weights (super_resolution.py:515-586): this
        package's full-state checkpoint named by --resume (the Trainer's own
        best / rolling files, which hold every frozen net) when there is
        one, with the reference's train-time artifacts (the students from
        --rec_path, the PSN) on top of it; else the reference's files
        (model_best_{i}.pth, model_best_cmm.pth, model_{arch}.pth in the
        resume directory, the students from --rec_path) through
        `load_driver_weights`."""
        resume = self.args.resume or self.cfg.resume or ""
        _refuse_msgpack(resume)
        native = resolve_native_checkpoint(resume, testing=True)
        if native:
            _, info = load_checkpoint(native, self.system)
            print(f"[weights] test state restored from {native} (iters={info.get('iters', '?')})", flush=True)
            load_driver_weights(self.system, self.cfg, self.args, testing=False)
        else:
            load_driver_weights(self.system, self.cfg, self.args, testing=True)
        return self.system

    def test(self, system: DPMNSystem = None, max_batches: int = None) -> dict:
        cfg = self.cfg
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        result_path = os.path.join(cfg.ckpt_dir, "test_result.csv")
        if not os.path.exists(result_path):
            with open(result_path, "w", newline="") as out:
                csv.writer(out).writerow(["recognizer", "subset", "accuracy", "psnr", "ssim"])
        if system is None:
            system = self.load_test_state()
        loader = DataLoader(self._dataset(self.args.test_data_dir, True), self.batch_size, self._collate(False),
                            shuffle=True, drop_last=False, workers=cfg.workers)
        data_name = (self.args.test_data_dir or "synthetic").rstrip("/").split("/")[-1]
        t0 = time.time()
        md = self.evaluate(system, loader, max_batches=max_batches, test_mode=True)
        duration = (time.time() - t0) / max(md["images"], 1)
        result = {
            "accuracy": {data_name: md["accuracy"]},
            "psnr_avg": md["psnr_avg"],
            "ssim_avg": md["ssim_avg"],
            "duration": duration,
        }
        print(result)
        with open(result_path, "a", newline="") as out:
            csv.writer(out).writerow([self.args.rec, data_name, md["accuracy"], md["psnr_avg"], md["ssim_avg"]])
        return result
