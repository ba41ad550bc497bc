"""DPMN system, eval: frozen PSN, the dual PGRM cascade, CMM and the α-blend.

Counterpart of dpmn_tpu/system.py::DPMNSystem._sr_forward_impl (:583-594)
with the device glyph atlas (glyph_mode='atlas').  Per batch:
  1. the frozen CRNN reads the LR image; its softmaxed frames are the text
     prior of the frozen TATT PSN (system.py:264-279);
  2. branch 1: before each of the b1 graphic PGRMs a VisionLAN student reads
     the cascade image and the device glyph atlas renders its prior
     (system.py:314-345); residuals are cascade_list[:k];
  3. branch 2: b2 semantic PGRMs conditioned on to_mask of the cascade image,
     residuals cascade_list[:(k - b2)] (system.py:397-405);
  4. CMM fuses the two branch outputs; the result is blended with the PSN
     output by α (system.py:427-434, :593-594).
The losses and the distill cascade of the JAX `_cascade` never reach the
eval output and are not computed.  With `sr_share` both branches run
model_list[0], a reference quirk.

`sr_forward` keeps the JAX package's NHWC contract: (B, h, w, 4) LR in,
(B, 2h, 2w, 3) SR out.  Modules run NCHW on `device`: the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from . import resolve_device
from .config import Args, TrainCfg, parse_pgrm_hparams
from .data.glyph_atlas import DeviceGlyph
from .models.cmm import CMM
from .models.crnn import CRNN, parse_crnn_input
from .models.pgrm import PGRM
from .models.tatt import TSRN_TL_TRANS
from .models.visionlan import VisionLAN, parse_visionlan_input
from .ops.mask_prior import to_mask


class DPMNSystem(nn.Module):
    def __init__(self, cfg: TrainCfg, args: Args, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        a = self.args = args
        self.cfg = cfg
        if a.arch != "tatt":
            raise NotImplementedError(f"arch {a.arch!r}: this port carries the TATT PSN only")
        if not a.mask:
            raise NotImplementedError("the TATT PSN of this port takes 4-channel (masked) LR input")
        if a.font_path is not None:
            raise NotImplementedError("the glyph atlas is committed for the default font only")
        hp = parse_pgrm_hparams(a)
        self.b1, self.b2 = a.stu_iter_b1, a.stu_iter_b2
        self.hr_shape = (cfg.height, cfg.width)

        def make_pgrm(iter_: int, graphic: bool) -> PGRM:
            def pick(lst, idx=iter_):
                return lst[min(idx, len(lst) - 1)]

            i = min(iter_, len(hp.depths) - 1) if len(hp.depths) == 1 else iter_
            return PGRM(
                img_size=self.hr_shape, patch_size=pick(hp.patch_size, i), embed_dim=pick(hp.embed_dim, i),
                num_layers=pick(hp.depths, i), num_heads=tuple(pick(hp.num_heads, i)),
                window_size=tuple(pick(hp.window_size, i)), mlp_ratio=float(pick(hp.mlp_ratio, i)),
                iter=iter_, graphic_mode=graphic, hidden_size=3, faithful=a.faithful,
            )

        if a.sr_share:
            pgrms = [make_pgrm(0, True), make_pgrm(self.b1, False)]
        else:
            pgrms = [make_pgrm(k, True) for k in range(self.b1)]
            pgrms += [make_pgrm(k, False) for k in range(self.b1, self.b1 + self.b2)]
        self.pgrms = nn.ModuleList(pgrms)
        self.cmm = CMM()
        self.psn = TSRN_TL_TRANS(scale_factor=cfg.down_sample_scale, width=cfg.width, height=cfg.height,
                                 srb_nums=a.srb, mask=a.mask, hidden_units=a.hd_u,
                                 out_text_channels=2 * a.hd_u, faithful=a.faithful)
        self.crnn_psn = CRNN()
        self.students = nn.ModuleList([VisionLAN() for _ in range(self.b1)])
        self.glyph = DeviceGlyph(self.hr_shape)
        init_weights(self, seed)
        self.device = device
        self.to(device).eval()

    # ------------------------------------------------------------- internals

    def _psn_forward(self, images_lr):
        """Frozen CRNN text prior → TATT PSN (super_resolution.py:156-169)."""
        logits = self.crnn_psn(parse_crnn_input(images_lr[:, :3]))  # (T, B, 37)
        emb = torch.softmax(logits, dim=-1).permute(1, 2, 0)[:, :, None, :]  # (B, 37, 1, T)
        return self.psn(images_lr, emb)[0]

    def _glyph_prior(self, k: int, cascade):
        """Student k reads the cascade image; the atlas renders its word."""
        logits, lengths = self.students[k](parse_visionlan_input(cascade[:, :3]))
        return self._prior_from_preds(logits.argmax(-1), lengths)

    def _prior_from_preds(self, preds, lengths):
        pos = torch.arange(preds.shape[1], device=preds.device)[None, :]
        ids = torch.where(pos < lengths[:, None], preds, 0)
        # drop EOS / blank ids and compact left (a stable sort of ids == 0)
        order = torch.argsort((ids == 0).to(torch.int8), dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        return self.glyph(ids, (ids > 0).sum(dim=1))

    def _pgrm(self, idx):
        return self.pgrms[0 if self.args.sr_share else idx]

    def _cascade(self, images_lr_psn):
        cascade, b1_list = images_lr_psn, []
        for k in range(self.b1):
            sr = self._pgrm(k)(self._glyph_prior(k, cascade), cascade[:, :3], b1_list[:k])
            b1_list.append(sr)
            cascade = sr
        cascade, b2_list = images_lr_psn, []
        for k in range(self.b1, self.b1 + self.b2):
            sr = self._pgrm(k)(to_mask(cascade), cascade[:, :3], b2_list[: (k - self.b2)])
            b2_list.append(sr)
            cascade = sr
        return self.cmm(b1_list[-1], b2_list[-1])

    # ------------------------------------------------------------ entry point

    @torch.no_grad()
    def sr_forward(self, images_lr) -> torch.Tensor:
        """(B, h, w, 4) NHWC LR images (numpy or tensor) → (B, 2h, 2w, 3) NHWC SR."""
        x = images_lr if torch.is_tensor(images_lr) else torch.from_numpy(np.asarray(images_lr))
        x = x.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()
        images_lr_psn = self._psn_forward(x)
        sr = self._cascade(images_lr_psn)
        alpha = self.args.alpha
        out = alpha * sr + (1 - alpha) * images_lr_psn[:, :3]
        return out.permute(0, 2, 3, 1).contiguous()


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights from a CPU torch.Generator, so the same seed gives
    the same weights on any device: Linear / Conv / ConvTranspose / RNN / MHA
    projection weights and biases uniform in ±1/sqrt(fan_in) (RNNs: hidden
    size); norms at identity; PReLU slopes 0.25; the relative-position tables
    normal(0, 0.02); embeddings and the InfoTransformer's init_factor
    normal(0, 1); the PGRM residual weights at 1.  Raises on a parameter no
    rule covers, so none is left uninitialized."""
    from .models.tatt import InfoTransformer
    from .ops.attention import MultiHeadAttention
    from .ops.gru import BiGRU

    gen = torch.Generator().manual_seed(seed)

    def uniform(p, fan_in):
        bound = 1.0 / max(fan_in, 1) ** 0.5
        return torch.rand(p.shape, generator=gen) * 2 * bound - bound

    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                value = uniform(p, mod.weight[0].numel())
            elif isinstance(mod, nn.ConvTranspose2d):
                value = uniform(p, mod.weight.shape[0] * mod.weight[0, 0].numel())
            elif isinstance(mod, (nn.LSTM, BiGRU)):
                value = uniform(p, mod.weight_hh_l0.shape[1])
            elif isinstance(mod, MultiHeadAttention):
                value = uniform(p, mod.embed_dim) if pname == "in_proj_weight" else torch.zeros(p.shape)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                value = torch.ones(p.shape) if pname == "weight" else torch.zeros(p.shape)
            elif isinstance(mod, nn.PReLU):
                value = torch.full(p.shape, 0.25)
            elif isinstance(mod, nn.Embedding) or (isinstance(mod, InfoTransformer) and pname == "init_factor"):
                value = torch.randn(p.shape, generator=gen)
            elif pname.startswith("relative_position_bias_table"):
                value = torch.randn(p.shape, generator=gen) * 0.02
            elif mname.endswith("weight_list"):
                value = torch.ones(p.shape)
            else:
                raise TypeError(f"init_weights: no rule for {mname}.{pname}")
            with torch.no_grad():
                p.copy_(value)
