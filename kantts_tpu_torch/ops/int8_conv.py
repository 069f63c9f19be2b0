"""K2, the int8 W8A8 conv of the vocoder, as a hand-written CUDA kernel
(``csrc/int8_conv.cu``), and its plain PyTorch version.

The JAX package quantizes the interior convs of the HiFi-GAN generator to
int8 (``kantts_tpu/models/hifigan/layers.py:46-86,154-171,231-245``) and
lets XLA compute them. PyTorch has no int8 ``conv1d`` on CUDA, so the port's
is K2; it replaces no Pallas kernel.

``int8_conv1d`` is the operator the layers call, registered as
``kantts::int8_conv1d`` so that ``torch.export`` captures it as one node:

- x (B, C_in, T) float32 is quantized with a per-example scale
  ``act_scale(x)`` = max(amax |x|, 1e-12) / 127 over (C_in, T), or with a
  static calibrated scale max(s_static, 1e-12);
- w_q int8 is (C_out, C_in, k) for a conv, (C_in, C_out, k) for a
  transposed conv, quantized once per output channel (``quantize_weight``);
- the sum is int32; the output is float(acc) * (s_x[b] * s_w[o]) + bias[o]
  in float32, (B, C_out, T').

A conv pads ``pad_left`` / ``pad_right`` zero frames (after quantizing: zero
is zero in int8) and convolves with ``stride`` and ``dilation``. A
transposed conv (stride s, kernel k) keeps the first T * s outputs when
``causal``, else trims ``pad_left`` from both ends of its (T - 1) * s + k.

A CUDA tensor goes to K2, a CPU tensor to ``int8_conv_torch``, which
computes the same int32 sums exactly (float64 convolutions of the int8
values) and the same float32 epilogue. K2 is compiled at first use with
``nvcc`` (``ops/nvcc.py``) and bound with ``ctypes``; nothing is built at
import.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from kantts_tpu_torch.ops.nvcc import PKG_DIR, build_library

SOURCE = os.path.join(PKG_DIR, "csrc", "int8_conv.cu")


# ------------------------------------------------------------- plain version

def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, rounded as a division. (PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently; JAX and
    K2 divide.)"""
    return t / torch.full_like(t, 127.0)


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, T) -> (B,): max(amax |x| over (C, T), 1e-12) / 127."""
    return div127(torch.clamp_min(x.abs().amax(dim=(1, 2)), 1e-12))


def quantize_sym(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8; round is half to even."""
    return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)


def quantize_weight(w: torch.Tensor, transposed: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 conv weight -> (w_q int8, s_w (C_out,)): per output channel,
    s_w = max(amax |w| over (C_in, k), 1e-12) / 127. The output channel is
    dim 0 of a conv's (C_out, C_in, k), dim 1 of a transposed conv's
    (C_in, C_out, k)."""
    dims = (0, 2) if transposed else (1, 2)
    s_w = div127(torch.clamp_min(w.abs().amax(dim=dims), 1e-12))
    shape = (1, -1, 1) if transposed else (-1, 1, 1)
    return quantize_sym(w, s_w.reshape(shape)), s_w


def scales(x: torch.Tensor, s_static: Optional[torch.Tensor]) -> torch.Tensor:
    """The activation scale of each example: dynamic, or the static one."""
    if s_static is None:
        return act_scale(x)
    return torch.clamp_min(s_static, 1e-12).reshape(1).expand(x.shape[0])


def out_len(T: int, k: int, stride: int, dilation: int, pad_left: int,
            pad_right: int, transposed: bool, causal: bool) -> int:
    if transposed:
        return T * stride if causal else (T - 1) * stride + k - 2 * pad_left
    return (T + pad_left + pad_right - dilation * (k - 1) - 1) // stride + 1


def int8_sums_torch(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                    dilation: int, pad_left: int, pad_right: int,
                    transposed: bool, causal: bool) -> torch.Tensor:
    """The int32 sums of the int8 conv, exact: products and sums of int8
    values are integers below 2^53, so float64 holds every partial sum."""
    xd = x_q.to(torch.float64)
    if transposed:
        y = F.conv_transpose1d(xd, w_q.to(torch.float64), stride=stride)
        y = (y[..., :x_q.shape[-1] * stride] if causal
             else y[..., pad_left:y.shape[-1] - pad_left])
    else:
        y = F.conv1d(F.pad(xd, (pad_left, pad_right)), w_q.to(torch.float64),
                     stride=stride, dilation=dilation)
    return y.round().to(torch.int32)


def epilogue(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """float(acc) * (s_x[b] * s_w[o]), then + bias[o]: the JAX order."""
    y = acc.to(torch.float32) * (s_x[:, None, None] * s_w[None, :, None])
    return y if bias is None else y + bias[None, :, None]


def int8_conv_torch(x, w_q, s_w, bias, s_static, stride: int, dilation: int,
                    pad_left: int, pad_right: int, transposed: bool,
                    causal: bool) -> torch.Tensor:
    """The plain version of ``int8_conv1d``, on any device."""
    s_x = scales(x, s_static)
    acc = int8_sums_torch(quantize_sym(x, s_x[:, None, None]), w_q, stride,
                          dilation, pad_left, pad_right, transposed, causal)
    return epilogue(acc, s_x, s_w, bias)


# --------------------------------------------------------------------- K2

class Int8ConvKernel:
    """The built library; ``launches`` counts conv launches and nothing else
    (each conv launch is preceded by its quantize launch, and by an amax
    launch with a dynamic scale)."""

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
                SOURCE, "libkantts_int8_conv")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.kantts_i8_quantize_act.argtypes = [p] * 5 + [i] * 6 + [p]
            lib.kantts_i8_quantize_act.restype = i
            lib.kantts_i8_conv.argtypes = [p] * 6 + [i] * 12 + [p]
            lib.kantts_i8_conv.restype = i
            lib.kantts_i8_partials.argtypes = [ctypes.c_longlong]
            lib.kantts_i8_partials.restype = i
            lib.kantts_i8_conv_smem.argtypes = [i] * 4
            lib.kantts_i8_conv_smem.restype = ctypes.c_longlong
            self._lib = lib
            return lib

    @staticmethod
    def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"K2 takes {name} as contiguous {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")

    def quantize(self, x: torch.Tensor, s_static: Optional[torch.Tensor],
                 pad_left: int = 0, pad_right: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, T) float32 CUDA -> (q (B, T + pads, Cp) int8 channels-last
        with zero padding, Cp = C rounded up to 4; s_x (B,))."""
        if x.device.type != "cuda":
            raise ValueError(f"K2 takes CUDA tensors, got {x.device}")
        if x.dim() != 3 or x.shape[2] < 1:
            raise ValueError(f"K2 takes x of shape (B, C, T >= 1), got {tuple(x.shape)}")
        self._check("x", x, torch.float32, x.device)
        if s_static is not None:
            if s_static.numel() != 1:
                raise ValueError("K2 takes a static scale of one element")
            self._check("s_static", s_static, torch.float32, x.device)
        lib = self.build()
        B, C, T = x.shape
        Cp = -(-C // 4) * 4
        q = torch.empty((B, T + pad_left + pad_right, Cp), dtype=torch.int8,
                        device=x.device)
        s_x = torch.empty(B, dtype=torch.float32, device=x.device)
        partial = (torch.empty(B * lib.kantts_i8_partials(C * T), dtype=torch.float32,
                               device=x.device) if s_static is None else None)
        with torch.cuda.device(x.device):
            err = lib.kantts_i8_quantize_act(
                x.data_ptr(), None if partial is None else partial.data_ptr(),
                None if s_static is None else s_static.data_ptr(), s_x.data_ptr(),
                q.data_ptr(), B, C, T, Cp, pad_left, pad_right,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 quantize launch failed: cudaError {err}")
        return q, s_x

    def conv(self, q: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
             s_w: torch.Tensor, bias: Optional[torch.Tensor], C_in: int,
             T_out: int, stride: int, dilation: int, transposed: bool, trim: int,
             sums: bool = False) -> torch.Tensor:
        """The conv launch on ``quantize``'s output -> (B, C_out, T_out)
        float32, or its int32 sums with ``sums``."""
        dev = q.device
        self._check("q", q, torch.int8, dev)
        self._check("s_x", s_x, torch.float32, dev)
        self._check("w_q", w_q, torch.int8, dev)
        self._check("s_w", s_w, torch.float32, dev)
        if bias is not None:
            self._check("bias", bias, torch.float32, dev)
        if w_q.dim() != 3 or w_q.shape[1 if not transposed else 0] != C_in:
            raise ValueError(f"K2: weight {tuple(w_q.shape)} does not take "
                             f"{C_in} input channels")
        C_out = w_q.shape[1] if transposed else w_q.shape[0]
        k = w_q.shape[2]
        if s_w.shape != (C_out,) or (bias is not None and bias.shape != (C_out,)):
            raise ValueError(f"K2 takes s_w and bias of shape ({C_out},)")
        B, Tp, Cp = q.shape
        if T_out < 1:
            raise ValueError(f"K2: the conv has no output ({T_out} frames)")
        lib = self.build()
        if lib.kantts_i8_conv_smem(k, stride, dilation, int(transposed)) > 232448:
            raise ValueError(f"K2: kernel {k} at dilation {dilation} needs more "
                             "shared memory than a block has")
        out = torch.empty((B, C_out, T_out),
                          dtype=torch.int32 if sums else torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.kantts_i8_conv(
                q.data_ptr(), w_q.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
                None if bias is None or sums else bias.data_ptr(),
                out.data_ptr(), int(sums), B, C_in, Cp, Tp, C_out, k, T_out, stride,
                dilation, int(transposed), trim,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 conv launch failed: cudaError {err}")
        self.launches += 1
        return out

    def __call__(self, x, w_q, s_w, bias, s_static, stride: int, dilation: int,
                 pad_left: int, pad_right: int, transposed: bool, causal: bool,
                 sums: bool = False) -> torch.Tensor:
        C_in, T = x.shape[1], x.shape[2]
        k = w_q.shape[2]
        if transposed:
            q, s_x = self.quantize(x, s_static)
            trim = 0 if causal else pad_left
        else:
            q, s_x = self.quantize(x, s_static, pad_left, pad_right)
            trim = 0
        T_out = out_len(T, k, stride, dilation, pad_left, pad_right, transposed, causal)
        return self.conv(q, s_x, w_q, s_w, bias, C_in, T_out, stride, dilation,
                         transposed, trim, sums)


int8_conv_cuda = Int8ConvKernel()


@torch.library.custom_op("kantts::int8_conv1d", mutates_args=())
def int8_conv1d(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor], s_static: Optional[torch.Tensor],
                stride: int, dilation: int, pad_left: int, pad_right: int,
                transposed: bool, causal: bool) -> torch.Tensor:
    """The int8 W8A8 conv (module docstring): K2 for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cuda":
        return int8_conv_cuda(x, w_q, s_w, bias, s_static, stride, dilation,
                              pad_left, pad_right, transposed, causal)
    if x.device.type == "cpu":
        return int8_conv_torch(x, w_q, s_w, bias, s_static, stride, dilation,
                               pad_left, pad_right, transposed, causal)
    raise ValueError(f"int8_conv1d runs on cuda or cpu, got {x.device}")


@int8_conv1d.register_fake
def _int8_conv1d_fake(x, w_q, s_w, bias, s_static, stride, dilation, pad_left,
                      pad_right, transposed, causal):
    C_out = w_q.shape[1] if transposed else w_q.shape[0]
    T = out_len(x.shape[2], w_q.shape[2], stride, dilation, pad_left, pad_right,
                transposed, causal)
    return x.new_empty((x.shape[0], C_out, T))
