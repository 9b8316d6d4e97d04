"""Build and load the port's CUDA kernels: ``nvcc`` into C-ABI shared
libraries, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, with one ``nvcc`` call of its own, into
``_build/<hash>/lib<name>.so``, where ``<hash>`` covers the sources and the
flags, so an edited source builds anew and an unchanged one is reused.  The
sources include no PyTorch header: a build takes seconds, not the minutes
that ``torch.utils.cpp_extension`` takes.  All missing libraries build
concurrently at first use.  A missing ``nvcc`` or a failed build raises:
there is no fallback to the plain versions for a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("weighted_sum", "conv3x3", "attention", "attention_bwd",
           "qmatmul", "group_norm", "fused_act", "conv3x3_int8")
# -split-compile=0 runs each nvcc's optimisation passes on as many threads
# as the host has cores: on the H100's 8-core host the longest sources
# (conv3x3.cu, group_norm.cu) build in ~21 s instead of ~35 s, every
# kernel with the same registers and no spill
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` not built yet, all at once.

    Returns the seconds each compile took (0.0 for one already built).  The
    compiler's output, ``ptxas`` register and shared-memory lines included,
    lands in ``_build/<hash>/<name>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        log = open(out / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{n} (exit {rc}):\n{(out / f'{n}.log').read_text()}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if not library_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def entry(name: str, fn_name: str, argtypes,
          restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``fn_name`` of ``lib<name>.so`` (by default returning
    a ``cudaError_t`` as int) with its types bound.  It is loaded and bound
    at the first call only: a launch then costs one dict lookup here, not
    the library lock and ctypes set-up."""
    fn = _bound.get((name, fn_name))
    if fn is None:
        fn = getattr(load(name), fn_name)
        fn.argtypes, fn.restype = argtypes, restype
        _bound[(name, fn_name)] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``: a launch the
    card refuses never runs, and a later synchronize does not report it."""
    if err:
        fn = entry(name, "natdiff_error_string", [ctypes.c_int],
                   ctypes.c_char_p)
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({fn(err).decode()})")


def on_device(t):
    """Make ``t``'s card current for a launch; a no-op when it already is,
    as it always is with one card."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
