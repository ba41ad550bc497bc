"""Minimal read-only LMDB reader (pure Python, mmap-based).

A copy of dpmn_tpu/data/lmdb_reader.py (the port imports nothing of that
package).  Neither host has the `lmdb` package; TextZoom ships as LMDB files with
keys b'num-samples', b'image_hr-%09d', b'image_lr-%09d', b'label-%09d'
(reference dataset/dataset.py:565-686).  This reader implements just enough
of the LMDB on-disk format (http://www.lmdb.tech/doc) for sequential and
random GETs on a single unnamed database: parse the newest meta page,
descend branch pages, and scan leaf nodes.  Values larger than one page
(image JPEGs) live on overflow pages.

Format notes (little-endian, page size from the meta page):
  page header: pgno u64, pad u16, flags u16, lower u16, upper u16
  flags: BRANCH=0x01, LEAF=0x02, OVERFLOW=0x04, META=0x08
  node (at in-page offset from the ptr array starting at byte 16):
    lo u16, hi u16, flags u16, ksize u16, data... ; vsize = lo | hi<<16
    node flags: BIGDATA=0x01 → data holds key then u64 overflow pgno
  meta page: header then MDB_meta { magic u32=0xBEEFC0DE, version u32,
    fixkey ptr, mapsize, two MDB_db structs (free, main), last_pg, txnid }
"""

from __future__ import annotations

import mmap
import os
import struct

MDB_MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01


class LMDBReader:
    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.psize, self.root = self._read_meta()

    def _read_meta(self):
        # the two meta pages sit at offsets 0 and psize; psize is recorded in
        # meta.mm_dbs[FREE].md_pad... simpler: probe standard page sizes.
        best = None
        for psize in (4096, 8192, 16384, 32768, 1024, 2048):
            for idx in (0, 1):
                off = idx * psize
                if off + 16 + 4 > len(self._mm):
                    continue
                magic, version = struct.unpack_from("<II", self._mm, off + 16)
                if magic != MDB_MAGIC:
                    continue
                # MDB_meta layout after magic+version: address(8), mapsize(8),
                # MDB_db free(48), MDB_db main(48), last_pg(8), txnid(8)
                meta_off = off + 16
                main_db_off = meta_off + 8 + 8 + 8 + 48
                # MDB_db: pad u32, flags u16, depth u16, branch_pages u64,
                # leaf_pages u64, overflow_pages u64, entries u64, root u64
                root = struct.unpack_from("<q", self._mm, main_db_off + 40)[0]
                txnid = struct.unpack_from("<Q", self._mm, meta_off + 8 + 8 + 8 + 48 + 48 + 8)[0]
                if best is None or txnid > best[0]:
                    best = (txnid, psize, root)
            if best is not None:
                return best[1], best[2]
        raise ValueError("not an LMDB file (magic not found)")

    def _page(self, pgno: int):
        off = pgno * self.psize
        return off

    def _nodes(self, off: int):
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        nkeys = (lower - 16) // 2
        ptrs = struct.unpack_from(f"<{nkeys}H", self._mm, off + 16)
        return ptrs

    def _node_key(self, page_off: int, ptr: int):
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, page_off + ptr)
        key_off = page_off + ptr + 8
        return self._mm[key_off : key_off + ksize], lo | (hi << 16), flags, ksize, key_off

    def get(self, key: bytes):
        pgno = self.root
        if pgno < 0:
            return None
        while True:
            off = self._page(pgno)
            flags = struct.unpack_from("<H", self._mm, off + 10)[0]
            ptrs = self._nodes(off)
            if flags & P_BRANCH:
                # binary search: find rightmost child whose key <= target
                lo_i, hi_i = 1, len(ptrs) - 1
                child_idx = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k, _, _, _, _ = self._node_key(off, ptrs[mid])
                    if k <= key:
                        child_idx = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                # branch node data = u48/u64 pgno packed in lo/hi
                lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._mm, off + ptrs[child_idx])
                pgno = lo | (hi << 16) | (nflags << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, len(ptrs) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k, vsize, nflags, ksize, key_off = self._node_key(off, ptrs[mid])
                    if k == key:
                        if nflags & F_BIGDATA:
                            ov_pgno = struct.unpack_from("<Q", self._mm, key_off + ksize)[0]
                            data_off = self._page(ov_pgno) + 16
                            return bytes(self._mm[data_off : data_off + vsize])
                        data_off = key_off + ksize
                        return bytes(self._mm[data_off : data_off + vsize])
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def close(self):
        self._mm.close()
        self._f.close()
