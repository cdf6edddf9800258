"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  ``build`` compiles
it with ``nvcc`` for ``sm_90a`` (``NVCC_FLAGS``, and a library's own
``EXTRA_FLAGS``) into ``build/repro_torch/`` at the root of
the checkout, one ``nvcc`` process per source, all started together; the
library's file name carries a hash of its source and of every ``csrc/*.cuh``
header it includes, so an edited source or header is rebuilt and an
unchanged one is reused.  The compiler's output (with ``ptxas -v``'s report)
is kept beside the library as ``<library>.log``.  ``load`` builds on first
use and opens the library with ctypes.  Nothing here runs at import.

The Hopper kernels encode TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``; ``csrc/hopper.cuh`` reaches it through the
runtime's ``cudaGetDriverEntryPoint``, so nothing links against ``libcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build", "library_path", "load", "work_queue"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)
# flags of one library on top of NVCC_FLAGS (part of its file name's hash)
EXTRA_FLAGS = {
    "vtime_scan": ("--fmad=false",),  # VT adds and compares only: no contraction anywhere
}

_LOADED: dict[str, ctypes.CDLL] = {}
_QUEUES: dict[tuple[int, int], object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(CSRC / m.decode() for m in _INCLUDE.findall(path.read_bytes()))
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(EXTRA_FLAGS.get(name, ())).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named source whose library (or its log) is missing;
    returns the compiler's output for every name, read back from the log of
    a library built before (the ``-Xptxas -v`` report).  Each ``nvcc``
    started adds one to the recorder's ``kernels.nvcc``.  Raises, after
    every ``nvcc`` started has ended, if any failed."""
    from ..fabric.telemetry import get_telemetry  # at the call: the fabric package imports the kernels

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tel = get_telemetry()
    jobs, logs = {}, {}
    for name in names:
        out = library_path(name)
        log = out.with_name(f"{out.name}.log")
        if out.exists() and log.exists():
            logs[name] = log.read_text()
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        tel.count("kernels.nvcc")
        jobs[name] = (proc, tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            tmp_log = tmp.with_name(f"{tmp.name}.log")
            tmp_log.write_text(logs[name])
            os.replace(tmp_log, log)
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


def work_queue(device, stream: int):
    """Two zeroed int32 on ``device`` for the persistent Hopper kernels'
    work queue (``hopper::next_unit`` in ``csrc/hopper.cuh``), one pair per
    (device, stream): a launch leaves them zero again, so they are
    allocated once and launches on one stream reuse them in turn."""
    import torch

    key = (device.index, stream)
    q = _QUEUES.get(key)
    if q is None:
        q = _QUEUES[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return q
