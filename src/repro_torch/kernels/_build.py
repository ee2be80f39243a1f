"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source becomes its own shared library with a plain C interface
(``build/repro_torch/<name>-<hash>.so`` under the repository root), keyed
on a hash of the source, the ``csrc/*.cuh`` headers it includes and the
flags, so an edit rebuilds and an unchanged source loads at once.  The sources include no PyTorch header,
so a build takes seconds.  Builds run at first use; ``build_all`` starts
one nvcc per missing source, all in parallel.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "ssd_decode",
           "vecadd", "matmul", "stencil", "floyd_warshall", "grouped_gemm",
           "region_map_reduce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _headers(src: bytes) -> List[str]:
    """The ``csrc/`` headers a source includes (``#include "x.cuh"``)."""
    return sorted(set(re.findall(rb'^\s*#\s*include\s+"([^"]+)"', src,
                                 re.MULTILINE)))


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed on its source, the headers
    it includes and the flags, so a header edit rebuilds every source that
    includes it."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    for inc in _headers(src):
        h.update(inc + b"\0" + (CSRC / inc.decode()).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every missing library in parallel.  Returns, per source,
    ``{"seconds": wall time or 0.0 if already built, "log": nvcc stderr}``
    (the log holds ptxas' register and shared-memory report)."""
    names = list(SOURCES if names is None else names)
    paths = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    if not todo:
        return report
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0,
                        "log": (stdout + stderr).strip()}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
