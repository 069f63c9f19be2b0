"""ctypes bindings for the native pitch trackers of ``pitch.cpp`` (a byte
copy of ``kantts_tpu/native/pitch.cpp``).

The shared library is built at first use with ``g++ -O3 -shared -fPIC``
(the JAX package's flags) into ``build/kantts_tpu_torch/``, keyed by the
source's hash; nothing is written into the source tree. A failed build
raises ``RuntimeError`` with the compiler's output: there is no numpy
stand-in, whose f0 values would differ. ctypes releases the GIL for the
duration of each call, so a thread pool runs the trackers in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "pitch.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kantts_tpu_torch")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]


class PitchLibrary:
    """The built library, loaded once per process."""

    def __init__(self, source: str = SOURCE, build_dir: str = BUILD_DIR) -> None:
        self.source = source
        self.build_dir = build_dir
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            with open(self.source, "rb") as f:
                digest = hashlib.sha1(f.read()).hexdigest()[:12]
            lib_path = os.path.join(self.build_dir, f"libkantts_pitch_{digest}.so")
            if not os.path.exists(lib_path):
                os.makedirs(self.build_dir, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                try:
                    proc = subprocess.run(["g++", *GXX_FLAGS, self.source, "-o", tmp],
                                          capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"cannot run g++ to build {self.source}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {self.source}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(lib_path)
            for fn in (lib.rapt_pitch, lib.yin_pitch):
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ]
            self._lib = lib
            return lib

    def track(self, fn_name: str, x: np.ndarray, sr: int, hop: int,
              min_f0: float, max_f0: float) -> np.ndarray:
        fn = getattr(self.load(), fn_name)
        x = np.ascontiguousarray(x, dtype=np.float32)
        max_frames = len(x) // hop + 1
        out = np.zeros(max_frames, dtype=np.float32)
        n = fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr, hop,
               min_f0, max_f0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               max_frames)
        return out[:n]


library = PitchLibrary()


def rapt(x: np.ndarray, fs: int, hopsize: int, min: float = 40.0,
         max: float = 800.0) -> np.ndarray:
    """RAPT-style NCCF + Viterbi tracker (pysptk.sptk.rapt call contract):
    frame-rate f0 in Hz, 0 where unvoiced."""
    return library.track("rapt_pitch", x, fs, hopsize, min, max)


def yin(x: np.ndarray, fs: int, hopsize: int, min: float = 40.0,
        max: float = 800.0) -> np.ndarray:
    """YIN estimator, the ensemble's second, independent method."""
    return library.track("yin_pitch", x, fs, hopsize, min, max)
