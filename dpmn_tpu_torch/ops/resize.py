"""Separable image resize as two matmuls, with torch's F.interpolate weights.

Counterpart of dpmn_tpu/ops/resize.py.  The (out, in) interpolation matrices
are built on the host the same way (Keys bicubic a = -0.75 with edge taps
clamped, half-pixel or align-corners mapping), so the port resamples with
exactly the JAX package's weights instead of trusting F.interpolate's border
handling to agree.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weight(t: np.ndarray, a: float) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1.0,
        (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
        np.where(at < 2.0, a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int, mode: str = "bicubic", align_corners: bool = False,
                  a: float = -0.75) -> np.ndarray:
    """(n_out, n_in) float32 interpolation matrix matching torch semantics."""
    m = np.zeros((n_out, n_in), np.float64)
    if n_out == n_in and not align_corners:
        np.fill_diagonal(m, 1.0)
        return np.asarray(m, np.float32)
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = (i + 0.5) * (n_in / n_out) - 0.5
        base = int(np.floor(src))
        if mode == "bicubic":
            for tap in range(base - 1, base + 3):
                m[i, int(np.clip(tap, 0, n_in - 1))] += float(_cubic_weight(np.asarray(src - tap), a))
        elif mode == "bilinear":
            frac = src - base
            for tap, w in ((base, 1.0 - frac), (base + 1, frac)):
                if w != 0.0:
                    m[i, int(np.clip(tap, 0, n_in - 1))] += float(w)
        else:
            raise ValueError(mode)
    return np.asarray(m, np.float32)


@functools.lru_cache(maxsize=64)
def _matrix_on(n_in, n_out, mode, align_corners, device) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(n_in, n_out, mode, align_corners)).to(device)


def resize(x: torch.Tensor, size, mode: str = "bicubic", align_corners: bool = False) -> torch.Tensor:
    """Resize NCHW images to `size` = (H_out, W_out) with torch semantics."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    my = _matrix_on(h_in, h_out, mode, align_corners, x.device).to(x.dtype)
    mx = _matrix_on(w_in, w_out, mode, align_corners, x.device).to(x.dtype)
    x = torch.einsum("oh,bchw->bcow", my, x)
    return torch.einsum("pw,bchw->bchp", mx, x)
