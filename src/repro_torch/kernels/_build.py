"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
CUDA use by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the
repository root (git-ignored), as ``lib<name>-<hash>.so``.  The hash covers
the source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header is never served by a stale library; the compiler's
output (ptxas registers and spills) is kept beside it as ``.log``.  Nothing
is compiled when this module is imported: the CPU tests import every module.
Processes that start together (the ranks of one card) build once: the
first takes a file lock in ``build/kernels/`` and compiles, the others wait
for it and load what it built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc``
    per source, all started together, under the build directory's file
    lock.  Returns each compiled source's compiler output (ptxas registers
    and spills); raises with it on any failure."""
    names = list(names)
    if all(_lib_path(n).exists() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _compile([n for n in names if not _lib_path(n).exists()])
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(todo) -> Dict[str, str]:
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        final = _lib_path(name)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed, reports = [], {}
    for name, (final, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            final.with_suffix(".log").write_text(out)
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def report(name: str) -> str:
    """The compiler's output for the current library of ``csrc/<name>.cu``
    (built first if need be)."""
    build([name])
    return _lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
