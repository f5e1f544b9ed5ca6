"""Build the CUDA C++ kernels at first use.

Each source ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, which
``ctypes`` loads (no PyTorch headers, so a build takes seconds, not
minutes).  Libraries land in ``repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the headers it may include
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_tc", "ssd_scan",
           "ssd_scan_tc")
# --split-compile=0 optimizes each source's kernels in parallel on every
# core (flash_attention.cu alone holds 16 template instances);
# tools/build_times.py times the build with and without it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit, on PATH "
                           "or under /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Launch nvcc for `name` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(log_path(name), "w")
    try:
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                           f"{log_path(name).read_text()}")
    os.replace(tmp, out)        # atomic: a reader never sees a partial .so


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every named kernel in parallel; return each one's nvcc log
    (ptxas register / shared-memory report)."""
    names = list(names)
    procs = {n: _start(n) for n in names}
    for proc in procs.values():
        if proc is not None:
            proc.wait()         # every nvcc ends before a failure is raised
    for n in names:
        _finish(n, procs[n])
    return {n: log_path(n).read_text() if log_path(n).exists() else ""
            for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
