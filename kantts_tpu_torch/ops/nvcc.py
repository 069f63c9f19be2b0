"""The build of the port's CUDA kernels: ``nvcc`` at first use, one shared
library with a plain C interface per source, under ``build/kantts_tpu_torch/``
and keyed by the source's hash, loaded with ``ctypes``. Nothing is built at
import, so the modules that use it import on a machine without CUDA."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kantts_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built from csrc/ with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library(source: str, stem: str) -> Tuple[ctypes.CDLL, str, float]:
    """Compile ``source`` into ``BUILD_DIR/{stem}_{hash}.so`` unless that
    file exists, and load it -> (library, the compiler's output, seconds).
    A failed compile raises with the compiler's output."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    lib_path = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), log, time.perf_counter() - t0
