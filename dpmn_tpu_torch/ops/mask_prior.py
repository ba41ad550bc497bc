"""Semantic (mask) prior — counterpart of dpmn_tpu/ops/mask_prior.py.

The reference's per-sample PIL pipeline (utils/util.py:27-35: ToPILImage →
convert('L') → mean threshold → {0, 255} → ToTensor → 3 channels) as tensor
ops: uint8 truncation, the ITU-R 601-2 integer luma of PIL's convert('L'),
a per-image mean threshold and a {0, 1} mask repeated over 3 channels.

The threshold is exact: luma is an integer at most 255, so its float32 sum
over a 32x128 image stays below 2**24 in any summation order.
"""

from __future__ import annotations

import torch


def to_mask(images: torch.Tensor) -> torch.Tensor:
    """(B, >=3, H, W) float in [0, 1] → (B, 3, H, W) binary mask prior."""
    rgb = images[:, :3].clamp(0.0, 1.0)
    u8 = torch.floor(rgb * 255.0).to(torch.int32)  # ToPILImage truncation
    luma = (19595 * u8[:, 0] + 38470 * u8[:, 1] + 7471 * u8[:, 2] + 32768) >> 16
    luma = luma.to(torch.float32)
    thres = luma.mean(dim=(1, 2), keepdim=True)
    mask = torch.where(luma > thres, 0.0, 1.0)
    return mask[:, None].expand(-1, 3, -1, -1).contiguous()
