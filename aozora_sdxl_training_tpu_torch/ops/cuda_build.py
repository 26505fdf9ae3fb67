"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` becomes ``csrc/build/<name>.so`` through one
``nvcc`` call for Hopper (``sm_90a``) and exposes a plain C interface that
the ops modules bind with ``ctypes``. A library is rebuilt when its source,
or any header under ``csrc/`` (which a source may include), is newer.
Nothing here runs at import time; the first launch builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
HEADER_SUFFIXES = (".cuh", ".h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def build_command(name: str) -> list[str]:
    out = library_path(name)
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v",
            "-o", str(out.with_name(out.name + ".tmp")), str(CSRC / f"{name}.cu")]


def inputs(name: str) -> list[Path]:
    """The files the library of ``name`` is built from: its source and every
    header under ``csrc/``."""
    headers = sorted(p for p in CSRC.rglob("*") if p.suffix in HEADER_SUFFIXES)
    return [CSRC / f"{name}.cu", *headers]


def needs_build(name: str) -> bool:
    lib = library_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs(name)))


def start_build(name: str, force: bool = False) -> subprocess.Popen | None:
    """Starts nvcc for one source (None when the library is current and
    ``force`` is false)."""
    if not force and not needs_build(name):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(build_command(name), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_build(name: str, proc: subprocess.Popen | None) -> str:
    """Waits for ``start_build``'s process; returns nvcc's output ("" where
    nothing was built)."""
    if proc is None:
        return ""
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
    out = library_path(name)
    out.with_name(out.name + ".tmp").replace(out)
    return output


def build_all(names, force: bool = False) -> dict[str, tuple[float, str]]:
    """Builds several sources at once, one nvcc each (only the stale ones
    unless ``force``); {name: (s, nvcc's output or "")}."""
    t0 = time.perf_counter()
    procs = {n: start_build(n, force) for n in names}
    results = {}
    for n, p in procs.items():
        output = finish_build(n, p)
        results[n] = (time.perf_counter() - t0, output)
    return results


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        finish_build(name, start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
