"""Build and load the hand-written CUDA kernels in ``csrc/`` (and the host
library ``csrc/pointops.cpp``, with g++: ``load_host``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of its source,
the shared headers ``csrc/*.cuh`` and the flags, then loaded with
``ctypes``. A source with a plain C interface builds
in seconds (no PyTorch headers). Pointers travel as ``ctypes.c_void_p``, the
stream is ``torch.cuda.current_stream().cuda_stream``, and every entry point
returns ``cudaGetLastError()`` so a refused launch is reported at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)
# Flags one source adds to NVCC_FLAGS. project_sh's radii and bin_slots'
# tiles decide the binning, adam's update is the plain update's bit for bit,
# and surfel_terms follows the plain regularizers to a few ulps: each must
# round as the plain PyTorch arithmetic rounds every product and every sum,
# so no multiply-add contraction there.
SOURCE_FLAGS = {"project_sh": ("-fmad=false",), "bin_slots": ("-fmad=false",),
                "adam": ("-fmad=false",), "surfel_terms": ("-fmad=false",)}

HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# Host C++ for the machine's baseline ISA: a library built here may be loaded
# on another host of the same architecture.
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str):
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built. The
    name hashes the source, every shared header ``csrc/*.cuh`` and the
    flags, so editing a header rebuilds each kernel that may include it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the kernels that are not built yet, one ``nvcc`` per source,
    all started together. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output from building ``csrc/<name>.cu`` ('' if the
    library was built by an earlier process and its log is gone)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, built first with
    ``g++`` into ``build/host/`` (named by a hash of the source and the
    flags) if needed. Raises when the compiler is missing or fails."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    path = HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if not path.exists():
        gxx = shutil.which(os.environ.get("CXX", "g++"))
        if gxx is None:
            raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp (exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _loaded[key] = lib
    return lib
