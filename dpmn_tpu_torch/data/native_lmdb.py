"""ctypes binding for the native C++ LMDB reader (csrc/lmdb_reader.cpp).

Counterpart of dpmn_tpu/data/native_lmdb.py.  The port builds its own copy
of the reader with g++ at first use into the git-ignored `_build/`, keyed by
the hash of the source, and never into the JAX package's `native/`.
`NativeLMDBReader` is API-compatible with lmdb_reader.LMDBReader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "lmdb_reader.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    sha = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD / f"lmdb_reader-{sha}.so"


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.lmdb_open.restype = ctypes.c_void_p
        lib.lmdb_open.argtypes = [ctypes.c_char_p]
        lib.lmdb_close.argtypes = [ctypes.c_void_p]
        lib.lmdb_get.restype = ctypes.c_long
        lib.lmdb_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        _LIB = lib
        return lib


class NativeLMDBReader:
    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._lib = _load_lib()
        self._h = self._lib.lmdb_open(path.encode())
        if not self._h:
            raise IOError(f"not an LMDB file: {path}")

    def get(self, key: bytes):
        n = self._lib.lmdb_get(self._h, key, len(key), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n)
        self._lib.lmdb_get(self._h, key, len(key), buf, n)
        return buf.raw

    def close(self):
        if self._h:
            self._lib.lmdb_close(self._h)
            self._h = None
