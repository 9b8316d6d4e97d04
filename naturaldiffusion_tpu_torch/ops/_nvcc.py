"""Build the port's CUDA kernels with ``nvcc``.  It imports no torch, so a
caller can start the build before it imports torch.

Each ``csrc/<name>.cu`` compiles, with one ``nvcc`` call of its own, into
``_build/<hash>/lib<name>.so``, where ``<hash>`` covers the sources and the
flags, so an edited source builds anew and an unchanged one is reused.  All
compiles start at once; a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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


def build(names=SOURCES, cpu_seconds=None) -> dict[str, float]:
    """Compile every library of ``names`` not built yet, all at once.

    Returns the wall seconds from the start of the build to the end of each
    compile (0.0 for one already built), read by polling every process, so
    each source's own time shows, not the time it waited behind another.
    ``cpu_seconds``, a dict, receives each compile's user + system CPU
    seconds (nvcc and the compilers it ran).  The compiler's output,
    ``ptxas`` register and shared-memory lines included, lands in
    ``_build/<hash>/<name>.log``."""
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
    while procs:
        for n, (proc, tmp, log) in list(procs.items()):
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid == 0:
                continue
            proc.returncode = rc = os.waitstatus_to_exitcode(status)
            secs[n] = time.perf_counter() - t0
            if cpu_seconds is not None:
                cpu_seconds[n] = usage.ru_utime + usage.ru_stime
            log.close()
            del procs[n]
            if rc != 0:
                failed.append(
                    f"{n} (exit {rc}):\n{(out / f'{n}.log').read_text()}")
            else:
                os.replace(tmp, library_path(n))
        if procs:
            time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs
