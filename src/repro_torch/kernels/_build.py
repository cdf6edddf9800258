"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  ``build`` compiles
it with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root of
the checkout, one ``nvcc`` process per source, all started together; the
library's file name carries a hash of its source, so an edited source is
rebuilt and an unchanged one is reused.  ``load`` builds on first use and
opens the library with ctypes.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build", "library_path", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named source whose library is missing; returns the
    compiler's output for each one built (the ``-Xptxas -v`` report).
    Raises, after every ``nvcc`` started has ended, if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"[{n}]\n{logs[n]}" for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
