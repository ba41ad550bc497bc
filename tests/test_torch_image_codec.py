"""The port's image conversions against the libraries the JAX data plane
calls: RGB → YUV against cv2.cvtColor(COLOR_RGB2YUV) over all 2^24 colours,
and the committed JPEG fixture's decode digests against PIL (the port
decodes with PIL, as the JAX package does; the digests let a host without
this check's libraries hold its decode to this one)."""

import hashlib
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from dpmn_tpu_torch.data.datasets import TextZoomLMDB
from dpmn_tpu_torch.data.image_codec import rgb_to_yuv
from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_textzoom_lmdb

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "textzoom_jpeg.npz"


def _sha(img) -> str:
    return hashlib.sha256(np.asarray(img, np.uint8).tobytes()).hexdigest()


@pytest.mark.parametrize("red_half", [0, 1])
def test_yuv_every_colour_against_cv2(red_half):
    c = np.arange(1 << 23, dtype=np.uint32) + (red_half << 23)
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(2048, 4096, 3)
    np.testing.assert_array_equal(rgb_to_yuv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV))


def test_yuv_shapes_and_refusals():
    rgb = np.random.RandomState(0).randint(0, 256, (3, 5, 7, 3)).astype(np.uint8)
    out = rgb_to_yuv(rgb)
    assert out.shape == rgb.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[1], cv2.cvtColor(rgb[1], cv2.COLOR_RGB2YUV))
    with pytest.raises(ValueError):
        rgb_to_yuv(rgb.astype(np.float32))
    with pytest.raises(ValueError):
        rgb_to_yuv(rgb[..., :2])


def test_fixture_records_and_digests(tmp_path):
    samples, digests = fixture_samples(str(FIXTURE))
    assert len(samples) == 128 and FIXTURE.stat().st_size < 1 << 20
    components = set()
    for (hr, lr, _), pair in zip(samples, digests):
        for jpeg, digest in zip((hr, lr), pair):
            img = Image.open(io.BytesIO(jpeg))
            assert img.format == "JPEG" and not img.info.get("progressive")
            components.add(img.mode)
            assert _sha(img.convert("RGB")) == digest
    assert components == {"RGB", "L"}
    hr_sizes = np.array([Image.open(io.BytesIO(s[0])).size for s in samples])
    lr_sizes = np.array([Image.open(io.BytesIO(s[1])).size for s in samples])
    assert np.all(np.abs(hr_sizes - (128, 32)).max(0) <= (32, 9))
    assert np.all(np.abs(lr_sizes - (64, 16)).max(0) <= (20, 5))
    path = str(tmp_path / "db")
    write_textzoom_lmdb(path, samples)
    ds = TextZoomLMDB(path)
    for i in range(len(ds)):
        hr, lr, hry, lry, _ = ds[i]
        assert (_sha(hr), _sha(lr)) == digests[i]
        np.testing.assert_array_equal(np.asarray(hry), cv2.cvtColor(np.asarray(hr), cv2.COLOR_RGB2YUV))
        np.testing.assert_array_equal(np.asarray(lry), cv2.cvtColor(np.asarray(lr), cv2.COLOR_RGB2YUV))
