"""TextZoom datasets and a simple batching loader.

Counterpart of dpmn_tpu/data/datasets.py.  Parity: reference
dataset/dataset.py:565-686 (lmdbDataset_real): 1-based keys, RGB decode
with PIL, YUV copies, str_filt on the label, corrupt-record skip to
index+1.

`TextZoomLMDB` reads through the native C++ reader (data/native_lmdb.py)
and falls back to the pure-Python one when it cannot be built, as the JAX
package does; `reader_kind` says which one opened the file.
"""

from __future__ import annotations

import io
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from ..utils.labels import str_filt
from .collate import AlignCollate, _yuv
from .lmdb_reader import LMDBReader


class TextZoomLMDB:
    def __init__(self, root: str, voc_type: str = "all", max_len: int = 100, test: bool = False,
                 use_native: bool = True):
        self.reader, self.reader_kind = None, None
        if use_native:
            try:  # C++ mmap reader (csrc/lmdb_reader.cpp); ~10x faster gets
                from .native_lmdb import NativeLMDBReader

                self.reader, self.reader_kind = NativeLMDBReader(root), "native"
            except Exception:
                self.reader = None
        if self.reader is None:
            self.reader, self.reader_kind = LMDBReader(root), "python"
        self.n_samples = int(self.reader.get(b"num-samples"))
        self.voc_type = voc_type
        self.max_len = max_len
        self.test = test

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index):
        index += 1  # 1-based keys (dataset.py:641)
        for _ in range(32):  # corrupt-record skip (dataset.py:683-684)
            try:
                hr_buf = self.reader.get(b"image_hr-%09d" % index)
                lr_buf = self.reader.get(b"image_lr-%09d" % index)
                word = self.reader.get(b"label-%09d" % index)
                img_hr = Image.open(io.BytesIO(hr_buf)).convert("RGB")
                img_lr = Image.open(io.BytesIO(lr_buf)).convert("RGB")
                word = " " if word is None else word.decode()
                break
            except Exception:
                index = index % self.n_samples + 1
        else:
            raise IOError("too many corrupt records")
        label_str = str_filt(word, self.voc_type)
        return img_hr, img_lr, _yuv(img_hr), _yuv(img_lr), label_str


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        di = int(np.searchsorted(self.offsets, index, side="right")) - 1
        return self.datasets[di][index - int(self.offsets[di])]


class DataLoader:
    """Shuffling batcher with a collate fn; NHWC numpy outputs.

    workers > 0 parallelizes batch preparation the way the reference's 16
    DataLoader workers do (interfaces/base.py:95-100, yaml:15): each worker
    thread fetches + collates a whole batch, with at most workers+1 batches
    in flight ahead of the consumer.  PIL decode / resize and numpy collate
    release the GIL, so threads overlap on multi-core hosts without the
    fork/pickle cost of process workers (the LMDB mmap readers are shared
    read-only).  Batch ORDER is identical to workers=0 — futures are yielded
    in submission order — so the epoch stream is deterministic for any
    worker count, and equal to the JAX package's for the same seed.
    """

    def __init__(self, dataset, batch_size: int, collate_fn: AlignCollate, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = workers
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _make_batch(self, chunk):
        return self.collate_fn([self.dataset[int(i)] for i in chunk])

    def _chunks(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        end = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            yield idx[s: s + self.batch_size]

    def __iter__(self):
        # more threads than cores only thrash the GIL
        workers = min(self.workers, os.cpu_count() or 1)
        if workers <= 0:
            for chunk in self._chunks():
                yield self._make_batch(chunk)
            return
        with ThreadPoolExecutor(max_workers=workers) as pool:
            inflight: deque = deque()
            try:
                for chunk in self._chunks():
                    inflight.append(pool.submit(self._make_batch, chunk))
                    # cap in-flight batches at workers+1 as documented above
                    if len(inflight) > workers:
                        yield inflight.popleft().result()
                while inflight:
                    yield inflight.popleft().result()
            finally:
                for f in inflight:
                    f.cancel()
