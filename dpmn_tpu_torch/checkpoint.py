"""Checkpointing: the whole train state in one atomically written file.

Counterpart of dpmn_tpu/checkpoint.py.  The reference writes one .pth per
PGRM plus recognizer files (interfaces/base.py:328-373); the JAX package
writes its whole state pytree as one msgpack.  Here one `torch.save` holds
the whole state of a DPMNSystem: every module's state dict with its
BatchNorm statistics, the optimizer's state (once the first update has made
it), the step and an `info` dict.  It is written to a temporary file and
moved into place with os.replace, so an interrupted save never corrupts the
resume point, and read back with `weights_only=True`.  The file names are
the JAX package's with the suffix `.pt`.
"""

from __future__ import annotations

import os

import torch

SUFFIX = ".pt"


def save_checkpoint(path: str, system, info: dict = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "state": system.state_dict(),
        "optimizer": None if system.optimizer is None else system.optimizer.state_dict(),
        "step": int(system.step),
        "info": info or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, system=None):
    """Read a checkpoint; with `system`, load it in place (strictly: a
    missing or an extra tensor raises), the optimizer made first when the
    file holds its state.  Returns (payload, info)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if system is not None:
        system.load_state_dict(payload["state"], strict=True)
        if payload["optimizer"] is not None:
            system.make_optimizer().load_state_dict(payload["optimizer"])
        system.step = payload["step"]
    return payload, payload.get("info", {})


def resolve_native_checkpoint(resume: str, testing: bool = False) -> str:
    """Map a --resume value to a checkpoint of this package if one exists
    (dpmn_tpu/weights.py:205).  A file path is returned as it is when it
    ends in `.pt`; a directory is searched in preference order — at test
    time the best-tracked state wins (the reference's model_best_* naming,
    base.py:176-181), otherwise the rolling checkpoint (resume-training
    semantics)."""
    if not resume:
        return ""
    if os.path.isfile(resume):
        return resume if resume.endswith(SUFFIX) else ""
    if not os.path.isdir(resume):
        return ""
    names = ["model_best_sum", "checkpoint"] if testing else ["checkpoint", "model_best_sum"]
    for name in names:
        cand = os.path.join(resume, name + SUFFIX)
        if os.path.exists(cand):
            return cand
    return ""


def evaluator_pretrained_path(rec: str, cfg) -> str:
    """The VAL-config checkpoint of the --rec judge (base.py:375-439)."""
    return {"aster": cfg.rec_pretrained, "moran": cfg.moran_pretrained, "crnn": cfg.crnn_pretrained}.get(rec, "") or ""
