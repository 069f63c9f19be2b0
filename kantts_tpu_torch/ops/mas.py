"""K1, the MAS Viterbi as a hand-written CUDA kernel (``csrc/mas.cu``).

The source is compiled at first use with ``nvcc`` into a shared library with
a plain C interface under ``build/kantts_tpu_torch/`` (keyed by the source's
hash; ``ops/nvcc.py``), and bound with ``ctypes``. Nothing is built or
loaded at import, so the module imports on a machine without CUDA.

``b_mas_cuda`` takes CUDA tensors only; ``models/sambert/alignment.py``
holds the plain PyTorch version and the dispatcher. The kernel writes the
whole output, so the wrapper allocates it with ``torch.empty``; the
backpointer bits stay in shared memory, and only a map too long for that
(4800x800, say) gets a global scratch of one or two bits per cell.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from kantts_tpu_torch.ops.nvcc import PKG_DIR, build_library

SOURCE = os.path.join(PKG_DIR, "csrc", "mas.cu")


class MasKernel:
    """Callable wrapper around the built library; ``launches`` counts each
    kernel launch and nothing else."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            lib, self.build_log, self.build_seconds = build_library(
                SOURCE, "libkantts_mas")
            lib.kantts_mas_width1.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.kantts_mas_width1.restype = ctypes.c_int
            lib.kantts_mas_max_text_len.argtypes = []
            lib.kantts_mas_max_text_len.restype = ctypes.c_int
            lib.kantts_mas_variant.argtypes = [ctypes.c_int] * 3
            lib.kantts_mas_variant.restype = ctypes.c_int
            lib.kantts_mas_scratch_words.argtypes = [ctypes.c_int] * 4
            lib.kantts_mas_scratch_words.restype = ctypes.c_longlong
            self._lib = lib
            return lib

    def variant(self, T_mel: int, T_text: int, variant: int = 0) -> str:
        """The name of the variant a launch at this shape takes: "warp"
        (T_text <= 1024, unless ``variant`` forces one) or "block"."""
        return {1: "warp", 2: "block"}[self.build().kantts_mas_variant(
            T_mel, T_text, variant)]

    def __call__(self, attn: torch.Tensor, in_lens: torch.Tensor,
                 out_lens: torch.Tensor, variant: int = 0) -> torch.Tensor:
        """attn (B, 1, T_mel, T_text) f32 contiguous CUDA; in_lens/out_lens
        (B,) int32 on the same device -> hard 0/1 alignment, same shape.
        ``variant`` 0 lets the library choose by T_text; 1 (warp) and 2
        (block) force one, for measuring the crossover."""
        if attn.device.type != "cuda":
            raise ValueError(f"K1 takes CUDA tensors, got {attn.device}")
        if attn.dtype != torch.float32 or attn.dim() != 4 or attn.shape[1] != 1:
            raise ValueError("K1 takes attn of shape (B, 1, T_mel, T_text) in "
                             f"float32, got {tuple(attn.shape)} {attn.dtype}")
        if not attn.is_contiguous():
            raise ValueError("K1 takes a contiguous attn")
        B, _, T_mel, T_text = attn.shape
        for name, t in (("in_lens", in_lens), ("out_lens", out_lens)):
            if (t.device != attn.device or t.dtype != torch.int32
                    or t.shape != (B,) or not t.is_contiguous()):
                raise ValueError(f"K1 takes {name} as contiguous int32 ({B},) "
                                 f"on {attn.device}, got {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
        lib = self.build()
        if T_text > lib.kantts_mas_max_text_len():
            raise ValueError(f"K1 takes T_text <= {lib.kantts_mas_max_text_len()}"
                             f", got {T_text}")
        if variant == 1 and T_text > 1024:
            raise ValueError(f"K1's warp variant takes T_text <= 1024, got {T_text}")
        out = torch.empty_like(attn)
        if out.numel() == 0:
            return out
        words = lib.kantts_mas_scratch_words(B, T_mel, T_text, variant)
        scratch = (torch.empty(words, dtype=torch.int32, device=attn.device)
                   if words else None)
        with torch.cuda.device(attn.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.kantts_mas_width1(
                attn.data_ptr(), in_lens.data_ptr(), out_lens.data_ptr(),
                out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                B, T_mel, T_text, variant, stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")
        self.launches += 1
        return out


b_mas_cuda = MasKernel()
