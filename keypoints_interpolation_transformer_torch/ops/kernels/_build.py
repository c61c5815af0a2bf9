"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, at first use, into ``_build/`` beside ``csrc/``
(listed in ``.gitignore``).  All stale sources compile in parallel, one
``nvcc`` each.  A library's file name carries a hash of its sources and
flags, so an edited source rebuilds and an unchanged one loads as it is.

Every C entry returns ``cudaGetLastError()`` after its launches; ``call``
raises when that is not 0.  Nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pointwise", "attn_sublayer", "ffn", "layer_fused", "layer_modes",
           "attn_sublayer_modes", "attention", "attention_modes",
           "pointwise_modes", "mode_linear", "masked_loss", "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, str] = {}  # "library.function": the signature set


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} at first use, which needs the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale library among ``names``, all at once; returns
    each source's seconds from the start of the build to the end of its
    ``nvcc`` (0.0 when cached).  The compiler's resource report goes to
    ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = {n: library_path(n) for n in names
             if not library_path(n).is_file()}
    secs = {n: 0.0 for n in names}
    if not stale:
        return secs
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n, out in stale.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(BUILD_DIR / f"{n}.log", "w") as log:
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT))
    pending = set(procs)
    while pending:
        for n in [n for n in pending if procs[n][1].poll() is not None]:
            secs[n] = time.perf_counter() - t0
            pending.discard(n)
        if pending:
            time.sleep(0.2)
    failed = []
    for n, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            log = (BUILD_DIR / f"{n}.log").read_text()
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log[-4000:]}")
        else:
            os.replace(tmp, stale[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def bind(name: str, signatures: Dict[str, str]) -> ctypes.CDLL:
    """The loaded library ``name`` with ``argtypes`` set from
    ``signatures`` (one letter per argument: p pointer or stream, i int);
    builds every stale source first.  A wrapper binds on every call: a
    library already loaded with those signatures returns at once."""
    lib = _libs.get(name)
    if lib is not None and all(_bound.get(f"{name}.{fn}") == sig
                               for fn, sig in signatures.items()):
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(SOURCES)
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kit_error_string.argtypes = [ctypes.c_int]
            lib.kit_error_string.restype = ctypes.c_char_p
            lib.kit_set_device.argtypes = [ctypes.c_int]
            lib.kit_set_device.restype = ctypes.c_int
            _libs[name] = lib
        for fn, sig in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = [_CTYPES[c] for c in sig]
            f.restype = ctypes.c_int
            _bound[f"{name}.{fn}"] = sig
        return lib


def call(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Launch ``fn`` on ``device``'s current stream; raises on a CUDA
    error.  Tensor arguments are passed as pointers, None as null."""
    index = device.index or 0
    rc = lib.kit_set_device(index)
    if rc == 0:
        # the handle itself (torch.cuda.current_stream makes a Stream object
        # per call, some 5 us of host time)
        stream = torch._C._cuda_getCurrentRawStream(index)
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        rc = getattr(lib, fn)(*conv, stream)
    if rc != 0:
        msg = lib.kit_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def check_tensors(where: str, device: torch.device, **tensors) -> None:
    """Every given tensor (None is skipped) is float32, contiguous and on
    ``device``."""
    for k, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{where}: {k} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{where}: {k} has dtype {t.dtype}, expected "
                            "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {k} is not contiguous")


def check_aligned(where: str, **weights) -> None:
    """The kernels stream weight tiles with 16-byte loads: every given
    weight starts on a 16-byte boundary (a view with an offset may not)."""
    for k, t in weights.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {k} does not start on a 16-byte "
                             "boundary; pass a .clone() of it")


def check_shape(where: str, name: str, t, shape) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
