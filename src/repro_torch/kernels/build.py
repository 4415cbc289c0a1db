"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``.cu`` source with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root (no PyTorch headers, no
``ninja``: a build takes seconds).  A library is named after its source's
content hash, so an edited source rebuilds and an unchanged one is reused.
``build()`` starts one ``nvcc`` per missing library, all together, and
waits for them.  Nothing is built when a module is imported: the first
launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parents[2]
BUILD_DIR = REPO / "build" / "kernels"

# kernel name -> source, relative to this package
SOURCES: Dict[str, str] = {
    "ring_chunk_attention": "flash_attention/csrc/ring_chunk_attention.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def source_path(name: str) -> Path:
    return PACKAGE / SOURCES[name]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing — one ``nvcc``
    process per source, started together — and return name -> library.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``.log``.  Raises on any
    failed compile, with its output."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)    # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing."""
    return ctypes.CDLL(str(build([name])[name]))
