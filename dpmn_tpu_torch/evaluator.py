"""Frozen recognizer judges: a recognizer reads SR images and its words are
held against the labels (the --rec accuracy of the reference's eval).

Counterpart of dpmn_tpu/evaluator.py (reference
interfaces/super_resolution.py:453-489, the input parsers of
interfaces/base.py:396-478): ASTER (width-5 beam search, words stopped at
EOS and normalized), MORAN (the left-to-right decoder's 20 steps, cut at
'$') and CRNN (greedy CTC).  A judge's weights come from a seed, from the JAX
package's variables through `weights.module_from_jax`, or from a reference
checkpoint (`pretrained=`), read strictly: a missing or an extra key raises.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from . import resolve_device
from .convert import crnn_port_key, load_reference_state_dict
from .models.aster import RecognizerBuilder, parse_aster_input
from .models.crnn import CRNN, parse_crnn_input
from .models.moran import MORAN, parse_moran_input
from .utils import labels as L

# buffers of the reference's TPSSpatialTransformer that an ASTER checkpoint
# carries; the port derives them from the geometry (in float64, as dpmn_tpu
# does) and reads none of them
_TPS_BUFFERS = ("tps.inverse_kernel", "tps.padding_matrix", "tps.target_coordinate_repr",
                "tps.target_control_points")


def load_pretrained(kind: str, model: torch.nn.Module, path: str) -> None:
    """Read the reference checkpoint at `path` into the judge `model` of
    `kind`, strictly."""
    sd = load_reference_state_dict(path)
    if kind == "aster":
        sd = {k: v for k, v in sd.items() if k not in _TPS_BUFFERS}
    elif kind == "crnn":
        sd = {crnn_port_key(k): v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


def _build(kind, model, device, seed, variables, pretrained):
    from .system import init_weights
    from .weights import module_from_jax

    init_weights(model, seed)
    if variables is not None:
        module_from_jax(model, variables)
    if pretrained:
        load_pretrained(kind, model, pretrained)
    return model.to(device).eval()


def _nchw(images, device) -> torch.Tensor:
    """(B, H, W, >=3) NHWC RGB in [0, 1], numpy or tensor → float32 NCHW RGB."""
    x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
    return x.to(device, torch.float32)[..., :3].permute(0, 3, 1, 2)


class AsterEvaluator:
    """The ASTER judge on `device` (the card unless the caller asks for the
    CPU); ASTER reads the native SR size (32x128), as the reference does."""

    def __init__(self, device=None, seed: int = 0, variables: dict = None, pretrained: str = "",
                 voc_type: str = "all", max_len: int = 100):
        self.device = resolve_device(device)
        self.voc_type = voc_type
        voc = L.get_vocabulary(voc_type)
        model = RecognizerBuilder(rec_num_classes=len(voc), max_len_labels=max_len, eos=L.char2id(voc)["EOS"])
        self.model = _build("aster", model, self.device, seed, variables, pretrained)

    @torch.no_grad()
    def predict_ids(self, images) -> np.ndarray:
        """The beam search's ids, (B, max_len)."""
        return self.model(parse_aster_input(_nchw(images, self.device)))["pred_rec"]

    def predict(self, images) -> list:
        ids = self.predict_ids(images)
        return L.aster_get_str_list(ids, ids, self.voc_type)[0]


class CRNNEvaluator:
    """The CRNN judge on `device`; its words are the greedy CTC decode."""

    def __init__(self, device=None, seed: int = 0, variables: dict = None, pretrained: str = ""):
        self.device = resolve_device(device)
        self.model = _build("crnn", CRNN(), self.device, seed, variables, pretrained)
        self.converter = L.CTCLabelConverter(string.digits + string.ascii_lowercase)

    @torch.no_grad()
    def predict(self, images) -> list:
        logits = self.model(parse_crnn_input(_nchw(images, self.device)))  # (T, B, C)
        return self.converter.decode_logits(logits.float().cpu().numpy())


class MoranEvaluator:
    """The MORAN judge on `device`: the left-to-right decoder's argmax over 20
    steps, cut at the stop character '$'."""

    def __init__(self, device=None, seed: int = 0, variables: dict = None, pretrained: str = ""):
        self.device = resolve_device(device)
        self.model = _build("moran", MORAN(), self.device, seed, variables, pretrained)
        self.converter = L.AttentionLabelConverter()

    @torch.no_grad()
    def predict(self, images) -> list:
        l2r, _ = self.model(parse_moran_input(_nchw(images, self.device)), num_steps=20)
        ids = l2r.argmax(-1).cpu().numpy()  # (B, 20)
        return ["".join(self.converter.alphabet[i] for i in row).split("$")[0] for row in ids]


def build_evaluator(kind: str, device=None, seed: int = 0, variables: dict = None, voc_type: str = "all",
                    pretrained: str = ""):
    """The judge `kind` names: "aster", "moran" or "crnn"."""
    if kind == "aster":
        return AsterEvaluator(device, seed, variables, pretrained, voc_type)
    if kind == "crnn":
        return CRNNEvaluator(device, seed, variables, pretrained)
    if kind == "moran":
        return MoranEvaluator(device, seed, variables, pretrained)
    raise ValueError(kind)
