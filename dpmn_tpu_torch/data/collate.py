"""Host-side preprocessing / batching (numpy, NHWC).

Counterpart of dpmn_tpu/data/collate.py, copied: PIL decodes and resizes as
there; the YUV copies come from data/image_codec.py (OpenCV's fixed point,
without OpenCV).

Parity: reference dataset/dataset.py —
  * resizeNormalize (:1266-1319): PIL bicubic resize, ToTensor, optional
    4th channel = PIL-'L' mean-threshold binary mask
  * alignCollate_realWTLAMask (:1966-2076, train): returns HR (B,32,128,C),
    pseudoLR=None, LR (B,16,64,C), HRy/LRy (YUV copies), label_strs,
    one-hot (B,1,26,37) with '-' padding interspersed between characters,
    flat weighted-mask label ids, weighted tics
  * alignCollate_realWTL (:1901-1963, val): same shapes, and the val-only
    quirk that words longer than 4 get their third character replaced by
    'e' in the one-hot (NOT in label_strs) — reproduced behind
    `e_substitution=True`.

Note the blur/imgaug branches of the reference are dead code on the live
path (resizeNormalize.blur body is `pass`; the aug transform is only used by
the commented-out pseudoLR) — no augmentation is applied here either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
from PIL import Image

from .image_codec import rgb_to_yuv

ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"
D2A = "-" + ALPHABET
A2D = {ch: i for i, ch in enumerate(D2A)}
ALSIZE = len(D2A)  # 37


def to_pil(img) -> Image.Image:
    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img))


def resize_normalize(img, size_wh, mask: bool = False) -> np.ndarray:
    """PIL bicubic resize to (W, H) → float32 (H, W, C[+1 mask]) in [0,1]."""
    img = to_pil(img).resize(size_wh, Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if mask:
        # reference semantics: gray.point(lambda x: 0 if x > thres else 255)
        # then /255 — vectorized as a numpy compare on the same uint8 values
        # (bit-identical; PIL's per-call python LUT build was 46% of the
        # whole collate on the 1-core serving host)
        g = np.asarray(img.convert("L"))
        thres = g.mean()
        m = (g <= thres).astype(np.float32)
        arr = np.concatenate([arr, m[..., None]], axis=-1)
    return arr


def resize_quantized(img, size_wh, mask: bool = False) -> np.ndarray:
    """uint8 transport variant of resize_normalize: PIL bicubic resize to
    (W, H) → uint8 (H, W, C[+1 mask]) with the mask channel stored as
    {0, 255}.  `u8.astype(float32) / 255.0` reproduces resize_normalize
    BIT-IDENTICALLY (the float path divides the same uint8 values by the
    same exact constant; the mask becomes exactly 0.0/1.0), so the divide
    can move to the device — 4x fewer host→device bytes and no host-side
    float conversion on the serving stream."""
    img = to_pil(img).resize(size_wh, Image.BICUBIC)
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if mask:
        g = np.asarray(img.convert("L"))
        thres = g.mean()
        m = np.where(g <= thres, np.uint8(255), np.uint8(0))
        arr = np.concatenate([arr, m[..., None]], axis=-1)
    return arr


@dataclass
class ServingCollate:
    """Serving-stream collate: ONLY the LR tensor, as uint8 (see
    resize_quantized).  A serving pipeline never needs the HR/Y-channel
    tensors the eval collate prepares (those exist for PSNR/SSIM and the
    TP-generator losses, dataset.py:1901-1963) — preparing them on the
    1-core serving host just starves the device feed."""

    img_h: int = 32
    img_w: int = 128
    down_sample_scale: int = 2
    mask: bool = False

    def __call__(self, batch):
        _, images_lr, _, _, _ = zip(*batch)
        lr_size = (self.img_w // self.down_sample_scale, self.img_h // self.down_sample_scale)
        return (np.stack([resize_quantized(im, lr_size, self.mask) for im in images_lr]),)


def interspace_pad(word: str, max_len: int = 26) -> str:
    """'-'-pad between chars up to 26 (dataset.py:1935-1942 / 2013-2022)."""
    word = word.lower()
    if len(word) <= 1:
        return word
    if len(word) >= max_len:
        return word[:max_len]
    padding = int((max_len - len(word)) / (len(word) - 1))
    new_word = word[0]
    for i in range(len(word) - 1):
        new_word += "-" * padding + word[i + 1]
    return new_word


def label_one_hot(label_strs: Sequence[str], e_substitution: bool, max_len: int = 26):
    """(B, 1, 26, 37) NHWC one-hots + flat ids + tics (see module docstring)."""
    batches: List[np.ndarray] = []
    weighted_masks: List[int] = []
    weighted_tics: List[int] = []
    for word in label_strs:
        word = word.lower()
        if e_substitution and len(word) > 4:
            word = word[:2] + "e" + word[3:]  # val-only quirk (dataset.py:1928-1931)
        word = interspace_pad(word, max_len)
        ids = [A2D[ch] for ch in word if ch in A2D]
        if len(ids) <= 0:
            weighted_masks.append(0)
        else:
            weighted_masks.extend(ids)
        if len(ids) > 0:
            vec = np.zeros((len(ids), ALSIZE), np.float32)
            vec[np.arange(len(ids)), ids] = 1.0
            weighted_tics.append(1)
        else:
            vec = np.zeros((1, ALSIZE), np.float32)
            vec[0, 0] = 1.0
            weighted_tics.append(0)
        batches.append(vec)
    out = np.zeros((len(label_strs), max_len, ALSIZE), np.float32)
    for i, vec in enumerate(batches):
        out[i, : vec.shape[0]] = vec[:max_len]
    # reference layout (B, 37, 1, 26) NCHW → ours (B, 1, 26, 37) NHWC
    return out[:, None, :, :], np.asarray(weighted_masks, np.int64), np.asarray(weighted_tics, np.int64)


def _yuv(img) -> Image.Image:
    return Image.fromarray(rgb_to_yuv(np.asarray(to_pil(img), np.uint8)))


@dataclass
class AlignCollate:
    """Train (e_substitution=False) / val (True) collate."""

    img_h: int = 32
    img_w: int = 128
    down_sample_scale: int = 2
    mask: bool = False
    e_substitution: bool = False
    train: bool = True

    def __call__(self, batch):
        images_hr, images_lr, images_hry, images_lry, label_strs = zip(*batch)
        hr_size = (self.img_w, self.img_h)
        lr_size = (self.img_w // self.down_sample_scale, self.img_h // self.down_sample_scale)
        hr = np.stack([resize_normalize(im, hr_size, self.mask) for im in images_hr])
        lr = np.stack([resize_normalize(im, lr_size, self.mask) for im in images_lr])
        hry = np.stack([resize_normalize(im, hr_size, self.mask) for im in images_hry])
        lry = np.stack([resize_normalize(im, lr_size, self.mask) for im in images_lry])
        one_hot, wm, wt = label_one_hot(label_strs, self.e_substitution)
        if self.train:
            # (HR, pseudoLR=None, LR, HRy, LRy, labels, one-hots, masks, tics)
            return hr, None, lr, hry, lry, list(label_strs), one_hot, wm, wt
        return hr, lr, hry, lry, list(label_strs), one_hot
