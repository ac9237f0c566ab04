"""Build and load the port's hand-written CUDA kernels.

Each ``shifu_tpu_torch/csrc/<name>.cu`` exposes a plain C entry point (it
may include the shared ``csrc/*.cuh`` headers) and is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/shifu_tpu_torch/`` beside the package (override with
``SHIFU_TORCH_BUILD_DIR``), then loaded with :mod:`ctypes`.  Nothing is
built at import time: a kernel's wrapper calls :func:`load` on its first
CUDA launch, so the package imports on a machine without ``nvcc``.  The
library name carries a digest of the source, the headers and the flags, so
an edited source rebuilds and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
# -Xptxas=-v: registers / shared memory / spills per kernel land in the
# build log that build() returns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    env = os.environ.get("SHIFU_TORCH_BUILD_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(repo, "build", "shifu_tpu_torch")


def nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found — the port's CUDA kernels are built "
                       "on first use and need the CUDA toolkit")


def _target(name: str) -> Tuple[str, str]:
    """The source of kernel ``name`` and its library path; the digest
    covers the source, every shared header it may include and the
    flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(build_dir(),
                             f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, Tuple[str, str]]:
    """Compile every named kernel that is not built yet — one ``nvcc`` per
    source, all started together — and return ``{name: (library path,
    compiler output)}``.  Raises with the compiler's output on failure."""
    os.makedirs(build_dir(), exist_ok=True)
    done: Dict[str, Tuple[str, str]] = {}
    running: List[Tuple[str, str, str, subprocess.Popen]] = []
    for name in names:
        src, lib = _target(name)
        if os.path.isfile(lib):
            done[name] = (lib, "")
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (lib, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
