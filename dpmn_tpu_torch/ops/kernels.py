"""Build and bind the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exports a plain C function and is compiled by nvcc for
sm_90a into its own shared library `_build/<name>-<hash>.so` (the hash covers
the source and every `csrc/*.cuh` header, so an edited source or header is
rebuilt), then loaded with ctypes.  All
sources are compiled in parallel, one nvcc process each.  Nothing here runs
when a module is imported: the build happens at the first launch, or when
`build_all()` is called.  A wrapper reaches a C entry point through `bind`,
which sets its argument and result types once, when it is first asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("window_attention", "gru_scan", "window_attention_train", "window_attention_core",
           "window_attention_full", "window_tile_attention", "grouped_window_attention", "mlp_convs",
           "dropout_mask")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_entries: dict = {}
ptxas_report: dict = {}  # kernel source -> nvcc's -Xptxas -v output of its last build


class LaunchCounter:
    """Launches of one kernel: a wrapper adds one where it launches its
    kernel, and nowhere else."""

    def __init__(self):
        self.launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")
    return path


def _target(name: str) -> Path:
    """The library path of `csrc/<name>.cu`, keyed by the hash of the source
    and of every header in `csrc/` (any of which it may include)."""
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode())
        sha.update(header.read_bytes())
    return BUILD / f"{name}-{sha.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, all at once.
    Returns the wall seconds the build took; raises with nvcc's output on a
    failed build."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _libs:
        if not _target(name).exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]


def bind(name: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C entry point `fn` of `csrc/<name>.cu` with its argtypes and
    restype set, once: the first call loads the library (building it if
    needed) and binds the function, later calls return it from a cache."""
    key = (name, fn)
    if key not in _entries:
        f = getattr(library(name), fn)
        f.argtypes, f.restype = list(argtypes), restype
        _entries[key] = f
    return _entries[key]


def refuse_autograd(what: str, tensors) -> None:
    """Raise when autograd would need a gradient through a kernel that has no
    backward: grad mode is on and one of `tensors` requires grad.  Without
    this, the weights behind such a kernel would silently get no gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call it under torch.no_grad() "
                           "or with tensors that do not require grad")


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned (cudaGetLastError
    after its launches): a refused launch never runs and a later synchronise
    would not report it."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of `device` (the call
    torch's own compiler stack uses; torch.cuda.current_stream builds a
    Stream object a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check_cuda_tensor(name: str, t: torch.Tensor, shape=None, device=None, dtype=torch.float32,
                      contiguous: bool = True) -> None:
    """Raise unless `t` is a CUDA tensor of `dtype` (float32 by default) and
    `shape`, contiguous unless `contiguous` is False (the conditions tested
    once on the way through, each again with its message on failure)."""
    if (t.is_cuda and t.dtype == dtype and (shape is None or t.shape == shape)
            and (not contiguous or t.is_contiguous()) and (device is None or t.device == device)):
        return
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
