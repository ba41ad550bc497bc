"""RGB → YUV of the data plane, bit-exact with OpenCV without OpenCV.

The JAX data plane converts each decoded image with
`cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV)` (dpmn_tpu/data/collate.py:142-147)
for the HRy / LRy copies of the batch.  This is OpenCV's 8-bit path
(RGB2YCrCb_i with the YUV coefficients, imgproc/src/color_yuv): 14-bit fixed
point, each term rounded by adding half before the shift, saturated to
uint8; output channels Y, U (from B - Y), V (from R - Y).  JPEG decoding and
bicubic resizing stay with PIL, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

_SHIFT = 14
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868  # round(0.299 / 0.587 / 0.114 * 2^14)
_B2U, _R2V = 8061, 14369  # 0.492 * 2^14, 0.877 * 2^14
_DELTA = 128 << _SHIFT


def _descale(x: np.ndarray) -> np.ndarray:
    return (x + (1 << (_SHIFT - 1))) >> _SHIFT


def rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB → (..., 3) uint8 YUV, as cv2.COLOR_RGB2YUV."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb_to_yuv takes uint8 (..., 3) RGB, got {rgb.dtype} {rgb.shape}")
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    u = _descale((b - y) * _B2U + _DELTA)
    v = _descale((r - y) * _R2V + _DELTA)
    return np.clip(np.stack([y, u, v], axis=-1), 0, 255).astype(np.uint8)
