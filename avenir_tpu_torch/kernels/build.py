"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries go to
``build/avenir_tpu_torch/`` at the root of the checkout, named by a hash of
the source and flags, so an unchanged source is built once.  Builds run at
first use (:func:`load`) or all together (:func:`build_all`, one ``nvcc``
process per source, started at once).  A failed build raises with the
compiler's output; nothing falls back to a plain version.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math`` — the
vote's veto divides and the KNN distance divides and takes square roots,
each of which must round as IEEE float32 does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "avenir_tpu_torch"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {"vote": "vote.cu", "histogram": "histogram.cu",
                           "bin_counts": "bin_counts.cu", "topk": "topk.cu",
                           "threefry": "threefry.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# name -> (seconds, compiler output) of the builds this process ran
build_log: Dict[str, tuple] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on PATH; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> build seconds (0.0 for
    a library that was already built)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    secs = {n: 0.0 for n in names}
    for name in names:
        final = library_path(name)
        if final.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = final.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, final, time.perf_counter())
    failed = []
    for name, (proc, tmp, final, t0) in running.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = (secs[name], out)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, final)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib
