"""Make the committed JPEG fixture of the port's data-plane tests:
tests/fixtures/textzoom_jpeg.npz.

128 (HR, LR, label) records of numpy-made word-like crops of varied sizes
(HR near 128x32, LR near 64x16), encoded as the JAX package's LMDB writer
encodes them (cv2, JPEG quality 95, 4:2:0; dpmn_tpu/data/lmdb_writer.py
create_textzoom_lmdb), a few as one-component (grey) JPEGs.  Beside each
record it stores the SHA-256 of PIL's decode (`Image.open(...).convert("RGB")`
as uint8 HWC bytes), so a host can check its decoder against this one.

    python tests/make_textzoom_fixture.py [--out tests/fixtures/textzoom_jpeg.npz]
"""

import argparse
import hashlib
import io

import cv2
import numpy as np
from PIL import Image

CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-'.&!"


def _crop(rng, w, h):
    """A smooth background with dark or light bars standing for glyphs."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)
    slope = rng.uniform(-0.6, 0.6, (2, 3))
    img = base + x[..., None] * slope[0] + y[..., None] * slope[1]
    ink = rng.uniform(0, 255, 3)
    n = rng.randint(1, 9)
    x0 = rng.randint(0, max(w // 8, 1))
    for _ in range(n):
        bw = rng.randint(2, max(w // 10, 3))
        top, bot = rng.randint(0, h // 3), h - rng.randint(0, h // 3)
        img[top:bot, x0:x0 + bw] = ink
        x0 += bw + rng.randint(1, max(w // 12, 2))
        if x0 >= w:
            break
    img += rng.randn(h, w, 3) * rng.uniform(0, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(rgb, grey):
    arr = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if grey else rgb[..., ::-1]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(arr), [int(cv2.IMWRITE_JPEG_QUALITY), 95])
    assert ok
    return buf.tobytes()


def _digest(jpeg: bytes) -> str:
    return hashlib.sha256(np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), np.uint8).tobytes()).hexdigest()


def make(n=128, seed=0):
    rng = np.random.RandomState(seed)
    jpegs, labels = [], []
    for i in range(n):
        hw, hh = rng.randint(96, 161), rng.randint(24, 41)
        lw, lh = rng.randint(44, 81), rng.randint(12, 21)
        hr = _crop(rng, hw, hh)
        lr = cv2.resize(hr, (lw, lh), interpolation=cv2.INTER_AREA)
        lr = np.clip(lr + rng.randn(lh, lw, 3) * 2, 0, 255).astype(np.uint8)
        grey = i % 16 == 5
        jpegs += [_encode(hr, grey), _encode(lr, grey)]
        labels.append("".join(rng.choice(list(CHARS), rng.randint(1, 13))))
    offsets = np.cumsum([0] + [len(j) for j in jpegs]).astype(np.int64)
    return dict(jpegs=np.frombuffer(b"".join(jpegs), np.uint8), offsets=offsets, labels=np.array(labels),
                digests=np.array([_digest(j) for j in jpegs]))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="tests/fixtures/textzoom_jpeg.npz")
    a = p.parse_args()
    data = make()
    np.savez_compressed(a.out, **data)
    print(a.out, len(data["labels"]), "records,", data["jpegs"].size, "JPEG bytes")
