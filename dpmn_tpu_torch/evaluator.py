"""Frozen recognizer judges: a recognizer reads SR images and its words are
held against the labels (the --rec accuracy of the reference's eval).

Counterpart of dpmn_tpu/evaluator.py:59-73 and :104-111 (reference
interfaces/super_resolution.py:453-489, interfaces/base.py:419-425).  The
CRNN judge is the port's CRNN (models/crnn.py); its words are the greedy CTC
decode of its logits.  ASTER and MORAN are not ported yet (ROADMAP queue 1);
nor is the loading of the reference's pretrained checkpoints.  A judge's
weights come from a seed, or from the JAX package's variables through
`weights.module_from_jax`.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from . import resolve_device
from .models.crnn import CRNN, parse_crnn_input
from .utils import labels as L


class CRNNEvaluator:
    """The CRNN judge on `device` (the card unless the caller asks for the
    CPU): random weights from `seed`, or the JAX package's CRNN variables
    ({"params", "batch_stats"}, numpy leaves) when `variables` is given."""

    def __init__(self, device=None, seed: int = 0, variables: dict = None, pretrained: str = ""):
        from .system import init_weights
        from .weights import module_from_jax

        if pretrained:
            raise NotImplementedError("pretrained recognizer checkpoints are not read yet (ROADMAP queue 1, item 5)")
        self.device = resolve_device(device)
        self.model = CRNN()
        init_weights(self.model, seed)
        if variables is not None:
            module_from_jax(self.model, variables)
        self.model = self.model.to(self.device).eval()
        self.converter = L.CTCLabelConverter(string.digits + string.ascii_lowercase)

    @torch.no_grad()
    def predict(self, images) -> list:
        """(B, H, W, >=3) NHWC RGB images in [0, 1] (numpy or tensor) → B words."""
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        x = x.to(self.device, torch.float32)[..., :3].permute(0, 3, 1, 2)
        logits = self.model(parse_crnn_input(x))  # (T, B, C)
        return self.converter.decode_logits(logits.float().cpu().numpy())


def build_evaluator(kind: str, device=None, seed: int = 0, variables: dict = None, pretrained: str = ""):
    """The judge `kind` names: "crnn"; "aster" and "moran" raise until they
    are ported."""
    if kind == "crnn":
        return CRNNEvaluator(device, seed, variables, pretrained)
    if kind in ("aster", "moran"):
        raise NotImplementedError(f"the {kind} judge is not ported yet (ROADMAP queue 1, item 3: ASTER + MORAN)")
    raise ValueError(kind)
