"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  All
sources are compiled together, one ``nvcc`` process each, the first
time any kernel is asked for.  Libraries land in ``build/repro_torch/``
at the root of the checkout, named by a hash of their source, the
headers it includes and the flags, so an unchanged source is never
rebuilt.

C entry points take device pointers and sizes, launch on the stream
they are given and return ``cudaGetLastError()``; ``check`` turns a
non-zero result into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# what the last build did: seconds, whether every library was cached,
# and the compiler's register/shared-memory report per source
BUILD_INFO: Dict[str, object] = {}


def build_dir() -> pathlib.Path:
    return CSRC.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _sources(src: pathlib.Path) -> list:
    """``src`` and every header it includes with quotes, recursively, in
    the order they are first met."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop(0)
        if f not in seen:
            seen.append(f)
            todo += [f.parent / n.decode()
                     for n in _INCLUDE.findall(f.read_bytes())]
    return seen


def _target(src: pathlib.Path) -> pathlib.Path:
    """The library's path, named by a hash of the source, the headers it
    includes and the flags: a changed header rebuilds every source that
    includes it."""
    h = hashlib.sha256()
    for f in _sources(src):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source stem: library path}; raises with nvcc's stderr if a
    build fails."""
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not targets[s.stem].exists()]
    report = {}
    if todo:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(s)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
            procs.append((s, tmp, p))
        failed = []
        for s, tmp, p in procs:
            stdout, stderr = p.communicate()
            report[s.stem] = stdout + stderr
            if p.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed on {s.name} "
                              f"(exit {p.returncode}):\n{stderr}")
            else:
                os.replace(tmp, targets[s.stem])  # atomic: no torn library
        if failed:
            raise RuntimeError("\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=not todo,
                      built=[s.stem for s in todo], ptxas=report)
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        targets = build_all()
        if name not in targets:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        for stem, path in targets.items():
            _LIBS.setdefault(stem, ctypes.CDLL(str(path)))
        lib = _LIBS[name]
    return lib


def check(err: int, what: str, error_string) -> None:
    """Raise if a C entry point reported a CUDA error.  ``error_string``
    is the library's ``cudaGetErrorString`` export."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                           f"{error_string(err).decode()}")
