"""Device glyph prior: the committed glyph atlas composed on the device.

Counterpart of dpmn_tpu/data/glyph_atlas.py::make_device_glyph_fn (:164-292).
For each recognized word and each case (lower, upper) it predicts the font
size the reference's host renderer would binary-search from em metrics,
reads every char's native-resolution cell and metrics at that size from the
atlas, and stretches the word's ink box edge-to-edge over the canvas with
bicubic (a = -0.75) resample maps built on the device, one per axis — two
batched matmuls.  Table reads are a gather, exact like the JAX package's
one-hot matmul (every table value is an integer below 256).

The atlas tables come from assets/glyph_atlas_32x128.npz (see
data/build_atlas.py), built from the JAX package's default font; no other
font is available without pygame.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

NCELL = 64  # native cell side
MAX_LEN = 25
SIZE_MIN = 2
SIZE_MAX = 36
SIZE_REF = 32  # em-metric reference render size
ATLAS_PATH = Path(__file__).resolve().parent.parent / "assets" / "glyph_atlas_32x128.npz"


def _cubic_weight(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = t.abs()
    w1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    w2 = a * (((at - 5.0) * at + 8.0) * at - 4.0)
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


class DeviceGlyph(nn.Module):
    """(char_ids (B, 25) 1-based, lengths (B,)) → (B, 2, H, W) glyph priors at
    uint8 value scale, channels (lower, upper)."""

    def __init__(self, shape=(32, 128)):
        super().__init__()
        z = np.load(ATLAS_PATH)
        atlas = z["atlas"].astype(np.float32)
        n_sizes, _, n_chars = atlas.shape[:3]
        self.n_sizes, self.n_chars = n_sizes, n_chars
        n_flat = n_sizes * 2 * n_chars
        table = np.concatenate(
            [atlas.reshape(n_flat, NCELL * NCELL)]
            + [z[k].reshape(n_flat, 1).astype(np.float32) for k in ("tops", "bots", "advs", "inkls", "inkrs")],
            axis=1)
        self.register_buffer("table", torch.from_numpy(table), persistent=False)
        # (2, C, 4): ascent, adv, inkl, inkr in em units per (case, char)
        self.register_buffer("sel", torch.from_numpy(np.ascontiguousarray(z["sel"].transpose(1, 2, 0))),
                             persistent=False)
        self.h, self.w = shape
        border = int(min(shape) * 0.1)
        self.target_h, self.target_w = float(self.h - 2 * border), float(self.w - 2 * border)
        s_pix = np.arange(MAX_LEN * NCELL)
        self.register_buffer("cell_of_s", torch.from_numpy(s_pix // NCELL), persistent=False)
        self.register_buffer("off_of_s", torch.from_numpy((s_pix % NCELL).astype(np.float32)), persistent=False)

    def forward(self, char_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        b = char_ids.shape[0]
        dev = char_ids.device
        h, w = self.h, self.w
        lengths_c = lengths.clamp(1, MAX_LEN)
        pos = torch.arange(MAX_LEN, device=dev)[None, :]
        active = pos < lengths_c[:, None]
        ids = torch.where(active, char_ids, 0).clamp(0, self.n_chars - 1).long()
        last = (lengths_c - 1)[:, None].long()
        rows_px = torch.arange(NCELL, device=dev, dtype=torch.float32)
        zero = torch.zeros((), device=dev)
        outs = []
        for case in (0, 1):
            # host font-size prediction from em metrics (the largest size the
            # host's binary search would accept)
            sel = self.sel[case][ids]  # (B, 25, 4)
            asc_w = torch.where(active, sel[..., 0], zero).amax(dim=1)
            a_em = torch.where(active, sel[..., 1], zero)
            cum_em = torch.cumsum(a_em, dim=1) - a_em
            span_em = (torch.gather(cum_em, 1, last)[:, 0] + torch.gather(sel[..., 3], 1, last)[:, 0]
                       - sel[:, 0, 2])
            f = torch.minimum(self.target_h / asc_w.clamp_min(1e-3), self.target_w / span_em.clamp_min(1e-3))
            sbi = (torch.floor(f + 1e-4).long() - SIZE_MIN).clamp(0, self.n_sizes - 1)
            flat = (sbi[:, None] * 2 + case) * self.n_chars + ids  # (B, 25)
            g = self.table[flat]  # (B, 25, NCELL^2 + 5)
            cells = g[..., : NCELL * NCELL].reshape(b, MAX_LEN, NCELL, NCELL)
            strip = cells.permute(0, 2, 1, 3).reshape(b, NCELL, MAX_LEN * NCELL)
            top_pc, bot_pc, adv_pc, inkl_pc, inkr_pc = g[..., NCELL * NCELL:].unbind(-1)

            # rows: the word's ink band [min top, max bot) onto the canvas height
            top = torch.where(active, top_pc, float(NCELL)).amin(dim=1)
            bot = torch.where(active, bot_pc, zero).amax(dim=1)
            valid = bot > top
            bandh = (bot - top).clamp_min(1.0)
            src_r = top[:, None] + (torch.arange(h, device=dev, dtype=torch.float32)[None, :] + 0.5) * bandh[:, None] / h - 0.5
            mr = _cubic_weight(rows_px[None, None, :] - src_r[:, :, None])  # (B, H, NCELL)
            mr = mr / mr.sum(dim=2, keepdim=True).clamp_min(1e-6)

            # columns: the proportional advance layout; strip px past a char's
            # advance are padding and masked out
            a = torch.where(active, adv_pc, zero)
            cum = torch.cumsum(a, dim=1) - a
            minx = inkl_pc[:, 0]
            maxx = torch.gather(cum, 1, last)[:, 0] + torch.gather(inkr_pc, 1, last)[:, 0]
            span = (maxx - minx).clamp_min(1.0)
            src = minx[:, None] + (torch.arange(w, device=dev, dtype=torch.float32)[None, :] + 0.5) * span[:, None] / w - 0.5
            u = cum[:, self.cell_of_s] + self.off_of_s[None, :] + 0.5  # (B, 25*NCELL)
            in_adv = (self.off_of_s[None, :] < a[:, self.cell_of_s]) & active[:, self.cell_of_s]
            mc = _cubic_weight(u[:, :, None] - 0.5 - src[:, None, :]) * in_adv[:, :, None]
            mc = mc / mc.sum(dim=1, keepdim=True).clamp_min(1e-6)

            canvas = (mr @ strip) @ mc  # (B, H, W)
            canvas = torch.where((valid & (lengths > 0))[:, None, None], canvas, zero)
            outs.append(canvas)
        return torch.stack(outs, dim=1)
