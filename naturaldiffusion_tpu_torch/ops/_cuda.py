"""Load the port's CUDA kernels: C-ABI shared libraries built by ``nvcc``
(``ops/_nvcc.py``), bound with ``ctypes``.

The sources include no PyTorch header: a build takes seconds, not the
minutes that ``torch.utils.cpp_extension`` takes.  All missing libraries
build concurrently at first use.  A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain versions for a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ._nvcc import (BUILD_ROOT, CSRC, NVCC_FLAGS, SOURCES,  # noqa: F401
                    build, build_dir, library_path, nvcc_path)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}


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
