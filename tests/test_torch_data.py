"""The port's data plane against dpmn_tpu's: LMDB files written and read
across the two packages, the native reader against the pure-Python one, the
corrupt-record skip, the collates bit for bit on the committed JPEG
fixture's records, the label codecs, the loader's batch order and the
device prefetch (on the CPU).

The JAX package's TextZoomLMDB builds its native reader into native/ on
first use (a git-ignored library); the port builds its own into
dpmn_tpu_torch/_build/."""

from pathlib import Path

import numpy as np
import pytest
import torch

import dpmn_tpu.data.collate as JC
import dpmn_tpu.data.datasets as JD
from dpmn_tpu.data.lmdb_reader import LMDBReader as JLMDBReader
from dpmn_tpu.data.lmdb_writer import write_lmdb as jax_write_lmdb
from dpmn_tpu.data.prefetch import normalize_uint8 as jax_normalize_uint8
from dpmn_tpu_torch.data import collate as PC
from dpmn_tpu_torch.data import datasets as PD
from dpmn_tpu_torch.data.lmdb_reader import LMDBReader
from dpmn_tpu_torch.data.lmdb_writer import fixture_samples, write_lmdb, write_textzoom_lmdb
from dpmn_tpu_torch.data.native_lmdb import NativeLMDBReader
from dpmn_tpu_torch.data.prefetch import normalize_uint8, prefetch_to_device

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "textzoom_jpeg.npz"


@pytest.fixture(scope="module")
def lmdb_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixture_lmdb")
    write_textzoom_lmdb(str(out), fixture_samples(str(FIXTURE))[0])
    return str(out)


def _records(n, seed=0):
    """Keys of the TextZoom layout with values from a few bytes to several
    pages (overflow pages), enough keys for a branch level."""
    rng = np.random.RandomState(seed)
    recs = {b"num-samples": str(n).encode()}
    for i in range(1, n + 1):
        recs[b"image_hr-%09d" % i] = rng.bytes(int(rng.choice([3, 700, 5000, 13000])))
        recs[b"label-%09d" % i] = b"w%d" % i
    return recs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lmdb_written_by_one_package_reads_in_the_other(tmp_path, writer):
    recs = _records(300)
    path = (jax_write_lmdb if writer == "jax" else write_lmdb)(str(tmp_path / "db"), recs)
    readers = [JLMDBReader(path), LMDBReader(path), NativeLMDBReader(path)]
    for key, value in recs.items():
        for r in readers:
            assert r.get(key) == value
    for r in readers:
        assert r.get(b"image_hr-999999999") is None
        assert r.get(b"") is None
        r.close()
    other = (write_lmdb if writer == "jax" else jax_write_lmdb)(str(tmp_path / "db2"), recs)
    assert Path(path).read_bytes() == Path(other).read_bytes()


def test_native_reader_against_python_reader(lmdb_dir):
    py, nat = LMDBReader(lmdb_dir), NativeLMDBReader(lmdb_dir)
    n = int(py.get(b"num-samples"))
    keys = [b"num-samples"] + [b"%s-%09d" % (t, i) for i in range(1, n + 1)
                               for t in (b"image_hr", b"image_lr", b"label")]
    for k in keys:
        assert nat.get(k) == py.get(k) is not None
    assert nat.get(b"missing") is None
    assert PD.TextZoomLMDB(lmdb_dir).reader_kind == "native"
    assert PD.TextZoomLMDB(lmdb_dir, use_native=False).reader_kind == "python"


def test_corrupt_record_skip(tmp_path):
    samples = fixture_samples(str(FIXTURE))[0][:6]
    samples[1] = (b"not a jpeg", samples[1][1], samples[1][2])
    samples[2] = (samples[2][0], samples[2][1][:40], samples[2][2])  # truncated
    path = str(tmp_path / "db")
    write_textzoom_lmdb(path, samples)
    j, p = JD.TextZoomLMDB(path), PD.TextZoomLMDB(path)
    for i in range(6):
        a, b = j[i], p[i]
        assert a[4] == b[4]
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert p[1][4] == p[3][4]  # records 2 and 3 (1-based) are skipped to 4


@pytest.mark.parametrize("train", [True, False])
def test_align_collate_bit_for_bit(lmdb_dir, train):
    j, p = JD.TextZoomLMDB(lmdb_dir), PD.TextZoomLMDB(lmdb_dir)
    jcol = JC.AlignCollate(mask=True, train=train, e_substitution=not train)
    pcol = PC.AlignCollate(mask=True, train=train, e_substitution=not train)
    for start in range(0, len(p), 32):
        idx = range(start, start + 32)
        a = jcol([j[i] for i in idx])
        b = pcol([p[i] for i in idx])
        assert len(a) == len(b) == (9 if train else 6)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


def test_label_codecs_and_serving_collate(lmdb_dir):
    words = ["", "a", "ab", "Hello", "streets", "x" * 30, "A-b'c", "12345678901234567890123456"]
    for w in words:
        assert PC.interspace_pad(w) == JC.interspace_pad(w)
    for e in (False, True):
        for x, y in zip(PC.label_one_hot(words, e), JC.label_one_hot(words, e)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ds = PD.TextZoomLMDB(lmdb_dir)
    items = [ds[i] for i in range(8)]
    for mask in (False, True):
        (a,), (b,) = PC.ServingCollate(mask=mask)(items), JC.ServingCollate(mask=mask)(items)
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        ref = np.stack([JC.resize_normalize(it[1], (64, 16), mask) for it in items])
        out = normalize_uint8(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, np.asarray(jax_normalize_uint8(b)))


def _batches(loader):
    return [(b[5], b[0], b[2]) for b in loader]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_order_against_jax(lmdb_dir, workers):
    jds, pds = JD.TextZoomLMDB(lmdb_dir), PD.TextZoomLMDB(lmdb_dir)
    kw = dict(shuffle=True, drop_last=True, seed=2, workers=workers)
    jl = JD.DataLoader(jds, 24, JC.AlignCollate(mask=True), **kw)
    pl = PD.DataLoader(pds, 24, PC.AlignCollate(mask=True), **kw)
    assert len(jl) == len(pl) == 5
    for epoch in range(2):  # the shuffle state carries over between epochs
        a, b = _batches(jl), _batches(pl)
        assert len(a) == len(b) == 5
        for (la, ha, ra), (lb, hb, rb) in zip(a, b):
            assert la == lb
            np.testing.assert_array_equal(ha, hb)
            np.testing.assert_array_equal(ra, rb)
    serial = PD.DataLoader(pds, 24, PC.AlignCollate(mask=True), **dict(kw, workers=0))
    assert [b[5] for b in serial] == [b[5] for b in PD.DataLoader(pds, 24, PC.AlignCollate(mask=True), **kw)]


def test_loader_early_break_and_partial_batch(lmdb_dir):
    pds = PD.TextZoomLMDB(lmdb_dir)
    loader = PD.DataLoader(pds, 10, PC.AlignCollate(mask=True, train=False, e_substitution=True), shuffle=False,
                           drop_last=False, workers=2)
    for bi, _ in enumerate(loader):
        if bi == 1:
            break
    batches = list(loader)
    assert len(batches) == len(loader) == 13 and batches[-1][0].shape[0] == 8
    assert batches[0][4] == [pds[i][4] for i in range(10)]


def test_prefetch_passes_batches_and_reraises():
    batches = [(np.full((2, 3), i, np.float32), None, ["w", "x"], np.arange(i + 1)) for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for (a, none, words, ids), src in zip(out, batches):
        assert torch.is_tensor(a) and torch.equal(a, torch.from_numpy(src[0]))
        assert none is None and words == ["w", "x"] and torch.equal(ids, torch.from_numpy(src[3]))

    def failing():
        yield batches[0]
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in prefetch_to_device(failing(), size=2, device="cpu"):
            got.append(b)
    assert len(got) == 1

    def endless():
        i = 0
        while True:
            yield (np.zeros(1) + i,)
            i += 1

    for i, (x,) in enumerate(prefetch_to_device(endless(), size=2, device="cpu")):
        if i == 3:
            break  # the producer stops and the source is closed
    assert float(x) == 3.0
