"""Minimal LMDB writer (bulk build).

A copy of `write_lmdb` of dpmn_tpu/data/lmdb_writer.py: it packs records
with the TextZoom keys b'num-samples', b'image_hr-%09d', b'image_lr-%09d',
b'label-%09d' (reference dataset/create_lmdb.py; dataset.py:565-686 reads
them back).  The JAX package's `create_textzoom_lmdb` encodes JPEGs with
cv2 and is not ported (ROADMAP queue 1): records come already encoded.

The writer emits the standard LMDB on-disk format (same structures the
pure-Python reader in lmdb_reader.py parses): sorted keys bulk-packed into
leaf pages, a branch level built on top when needed, big values on
contiguous overflow pages, two meta pages.
"""

from __future__ import annotations

import struct
from typing import Dict

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
PSIZE = 4096
HDR = 16


class _PageBuilder:
    def __init__(self):
        self.pages = [None, None]  # meta slots

    def alloc(self, n=1):
        pgno = len(self.pages)
        self.pages.extend([bytearray(PSIZE) for _ in range(n)])
        return pgno

    def page(self, pgno):
        return self.pages[pgno]


def _pack_page(pb: _PageBuilder, pgno: int, flags: int, nodes):
    """nodes: list of bytes; packs into the page, returns False if overflow."""
    page = pb.page(pgno)
    offsets = []
    cursor = PSIZE
    for node in nodes:
        pad = (len(node) + 1) // 2 * 2
        cursor -= pad
        offsets.append(cursor)
    lower = HDR + 2 * len(nodes)
    if lower > min(offsets, default=PSIZE):
        raise ValueError("page overflow")
    struct.pack_into("<QHHHH", page, 0, pgno, 0, flags, lower, min(offsets, default=PSIZE))
    struct.pack_into(f"<{len(nodes)}H", page, HDR, *offsets)
    for off, node in zip(offsets, nodes):
        page[off : off + len(node)] = node


def _leaf_node(key: bytes, value: bytes, pb: _PageBuilder):
    max_inline = (PSIZE - HDR) // 2 - 16
    if 8 + len(key) + len(value) > max_inline:
        npages = -(-(len(value) + HDR) // PSIZE)
        ov_pgno = pb.alloc(npages)
        struct.pack_into("<QIHH", pb.page(ov_pgno), 0, ov_pgno, npages, P_OVERFLOW, 0)
        blob = memoryview(b"".join(bytes(pb.page(ov_pgno + i)) for i in range(npages)))
        # write value contiguously starting right after the first header
        flat = bytearray(blob)
        flat[HDR : HDR + len(value)] = value
        for i in range(npages):
            pb.pages[ov_pgno + i] = bytearray(flat[i * PSIZE : (i + 1) * PSIZE])
        node = struct.pack(
            "<HHHH", len(value) & 0xFFFF, (len(value) >> 16) & 0xFFFF, F_BIGDATA, len(key)
        ) + key + struct.pack("<Q", ov_pgno)
        return node
    return struct.pack("<HHHH", len(value) & 0xFFFF, (len(value) >> 16) & 0xFFFF, 0, len(key)) + key + value


def _branch_node(key: bytes, child_pgno: int):
    return struct.pack(
        "<HHHH", child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF, (child_pgno >> 32) & 0xFFFF, len(key)
    ) + key


def write_lmdb(path: str, records: Dict[bytes, bytes]):
    """Bulk-build an LMDB file at `path` (a data.mdb file path or dir)."""
    import os

    if os.path.isdir(path) or path.endswith(os.sep) or "." not in os.path.basename(path):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")

    pb = _PageBuilder()
    items = sorted(records.items())

    # pack leaves greedily
    leaves = []  # (first_key, pgno, nodes)
    cur_nodes, cur_first, cur_size = [], None, 0
    staged = []
    for k, v in items:
        node = _leaf_node(k, v, pb)
        pad = (len(node) + 1) // 2 * 2 + 2
        if cur_nodes and HDR + cur_size + pad > PSIZE:
            staged.append((cur_first, list(cur_nodes)))
            cur_nodes, cur_first, cur_size = [], None, 0
        if cur_first is None:
            cur_first = k
        cur_nodes.append(node)
        cur_size += pad
    if cur_nodes:
        staged.append((cur_first, cur_nodes))

    for first, nodes in staged:
        pgno = pb.alloc()
        _pack_page(pb, pgno, P_LEAF, nodes)
        leaves.append((first, pgno))

    depth = 1
    if len(leaves) == 0:
        root = -1
    elif len(leaves) == 1:
        root = leaves[0][1]
    else:
        # one branch level is enough for our tooling scale; recurse if needed
        level = leaves
        while len(level) > 1:
            depth += 1
            next_level = []
            group, gfirst, gsize = [], None, 0
            staged_groups = []
            for i, (first, pgno) in enumerate(level):
                key = b"" if not group and gfirst is None else first
                node = _branch_node(b"" if not group else first, pgno)
                pad = (len(node) + 1) // 2 * 2 + 2
                if group and HDR + gsize + pad > PSIZE:
                    staged_groups.append((gfirst, group))
                    group, gfirst, gsize = [], None, 0
                    node = _branch_node(b"", pgno)
                    pad = (len(node) + 1) // 2 * 2 + 2
                if gfirst is None:
                    gfirst = first
                group.append(node)
                gsize += pad
            if group:
                staged_groups.append((gfirst, group))
            for gfirst, nodes in staged_groups:
                pgno = pb.alloc()
                _pack_page(pb, pgno, P_BRANCH, nodes)
                next_level.append((gfirst, pgno))
            level = next_level
        root = level[0][1]

    # meta pages
    n_pages = len(pb.pages)
    for idx, txnid in ((0, 1), (1, 0)):
        page = bytearray(PSIZE)
        struct.pack_into("<QHHHH", page, 0, idx, 0, P_META, 0, 0)
        meta = struct.pack("<II", MDB_MAGIC, 999)
        meta += struct.pack("<QQ", 0, max(n_pages * PSIZE, 1 << 20))
        free_db = struct.pack("<IHHQQQQq", PSIZE, 0, 0, 0, 0, 0, 0, -1)
        main_db = struct.pack("<IHHQQQQq", 0, 0, depth, 0, len(leaves), 0, len(items), root)
        meta += free_db + main_db + struct.pack("<QQ", n_pages - 1, txnid)
        page[HDR : HDR + len(meta)] = meta
        pb.pages[idx] = page

    with open(path, "wb") as f:
        for page in pb.pages:
            f.write(page)
    return path


def write_textzoom_lmdb(path: str, samples):
    """Pack (HR JPEG bytes, LR JPEG bytes, label str) triplets with the
    TextZoom keys, 1-based: the half of the JAX package's
    create_textzoom_lmdb after its encoder."""
    records = {b"num-samples": str(len(samples)).encode()}
    for i, (hr, lr, label) in enumerate(samples, start=1):
        records[b"image_hr-%09d" % i] = bytes(hr)
        records[b"image_lr-%09d" % i] = bytes(lr)
        records[b"label-%09d" % i] = label.encode()
    return write_lmdb(path, records)


def fixture_samples(path: str, copies: int = 1):
    """The (HR JPEG, LR JPEG, label) records of a JPEG fixture npz (jpegs,
    offsets, labels, digests; tests/make_textzoom_fixture.py), repeated
    `copies` times, and the SHA-256 of each record's decode as (HR, LR)
    pairs."""
    import numpy as np

    with np.load(path) as f:
        buf, offsets, labels, digests = f["jpegs"].tobytes(), f["offsets"], f["labels"], f["digests"]
    jpegs = [buf[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)]
    samples = [(jpegs[2 * i], jpegs[2 * i + 1], str(label)) for i, label in enumerate(labels)]
    pairs = [(str(digests[2 * i]), str(digests[2 * i + 1])) for i in range(len(labels))]
    return samples * copies, pairs * copies


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="write a TextZoom LMDB from a JPEG fixture npz")
    p.add_argument("fixture")
    p.add_argument("out", help="the LMDB directory to write")
    p.add_argument("--copies", type=int, default=1, help="repeat the fixture's records this many times")
    a = p.parse_args(argv)
    samples, _ = fixture_samples(a.fixture, a.copies)
    print(write_textzoom_lmdb(a.out, samples), len(samples), "records")


if __name__ == "__main__":
    main()
