"""K2, the int8 W8A8 conv of the vocoder, as a hand-written CUDA kernel
(``csrc/int8_conv.cu``), and its plain PyTorch version.

The JAX package quantizes the interior convs of the HiFi-GAN generator to
int8 (``kantts_tpu/models/hifigan/layers.py:46-86,154-171,231-245``) and
lets XLA compute them. PyTorch has no int8 ``conv1d`` on CUDA, so the port's
is K2; it replaces no Pallas kernel.

``int8_conv1d`` is what the layers call; it is the operator
``kantts::int8_conv1d``, which ``torch.export`` captures as one node:

- x (B, C_in, T) float32 is quantized with a per-example scale
  ``act_scale(x)`` = max(amax |x|, 1e-12) / 127 over (C_in, T), or with a
  static calibrated scale max(s_static, 1e-12);
- the weight is ``w_p``, the int8 weight w_q of ``quantize_weight`` packed
  once by ``pack_weight`` in the order K2's MMA reads it (w_q is (C_out,
  C_in, k) for a conv, (C_in, C_out, k) for a transposed conv, quantized
  per output channel with scales s_w);
- the sum is int32; the output is float(acc) * (s_x[b] * s_w[o]) + bias[o]
  in float32, (B, C_out, T').

A conv pads ``pad_left`` / ``pad_right`` zero frames (after quantizing: zero
is zero in int8) and convolves with ``stride`` and ``dilation``. A
transposed conv (stride s, kernel k) keeps the first T * s outputs when
``causal``, else trims ``pad_left`` from both ends of its (T - 1) * s + k.

A CUDA tensor goes to K2 (one launch a conv), a CPU tensor to
``int8_conv_packed_torch``: ``int8_conv_torch``, the plain version, on the
unpacked weight, which computes the same int32 sums exactly (float64
convolutions of the int8 values) and the same float32 epilogue. K2 is
compiled at first use with ``nvcc`` (``ops/nvcc.py``) and bound with
``ctypes``; nothing is built at import.
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
    """The plain version of ``int8_conv1d``, on any device, from w_q."""
    s_x = scales(x, s_static)
    acc = int8_sums_torch(quantize_sym(x, s_x[:, None, None]), w_q, stride,
                          dilation, pad_left, pad_right, transposed, causal)
    return epilogue(acc, s_x, s_w, bias)


# ----------------------------------------------------------- packed weights

def _phase_taps(k: int, stride: int) -> torch.Tensor:
    """(stride, ceil(k / stride)): the tap j of a transposed conv that
    packed tap (phase ph, jl) holds, j = ph + (M - 1 - jl) * stride (M taps a
    phase, reversed so that phase ph is a plain conv of M taps over the
    input rows q - M + 1 .. q); j >= k is a zero tap."""
    M = -(-k // stride)
    return (torch.arange(stride)[:, None]
            + (M - 1 - torch.arange(M))[None, :] * stride)


def pack_weight(w_q: torch.Tensor, transposed: bool, stride: int = 1) -> torch.Tensor:
    """w_q int8 -> the layout K2's MMA reads: (ceil(C_out / 16), taps,
    ceil(C_in / 32), 512) int8, zero-padded, one m16n8k32 A fragment
    (16 output channels x 32 input channels of one tap) per 512 bytes, in
    lane order: lane 4g + t holds rows g and g + 8 at channels 4t..4t+3
    and 16 + 4t..16 + 4t + 3. A conv has its k taps; a transposed conv of
    stride s has s phases x ceil(k / s) taps (``_phase_taps``)."""
    if transposed:
        C_in, C_out, k = w_q.shape
        j = _phase_taps(k, stride).reshape(-1).to(w_q.device)
        w = w_q.permute(1, 2, 0)[:, j.clamp(max=k - 1)]
        w = w * (j < k).to(w.dtype)[None, :, None]
    else:
        C_out, C_in, k = w_q.shape
        w = w_q.permute(0, 2, 1)
    KT = w.shape[1]
    Mp, Cp = -(-C_out // 16) * 16, -(-C_in // 32) * 32
    full = w.new_zeros((Mp, KT, Cp))
    full[:C_out, :, :C_in] = w
    # (mi, h, g, tap, c, q, t, e) -> (mi, tap, c, g, t, q, h, e)
    frag = full.reshape(Mp // 16, 2, 8, KT, Cp // 32, 2, 4, 4).permute(
        0, 3, 4, 2, 6, 5, 1, 7)
    return frag.reshape(Mp // 16, KT, Cp // 32, 512).contiguous()


def unpack_weight(w_p: torch.Tensor, C_in: int, C_out: int, k: int,
                  transposed: bool, stride: int = 1) -> torch.Tensor:
    """The inverse of ``pack_weight``: -> w_q."""
    n16, KT, nC, _ = w_p.shape
    full = w_p.reshape(n16, KT, nC, 8, 4, 2, 2, 4).permute(
        0, 6, 3, 1, 2, 5, 4, 7).reshape(n16 * 16, KT, nC * 32)
    w = full[:C_out, :, :C_in]
    if not transposed:
        return w.permute(0, 2, 1).contiguous()
    # tap j = ph + m * s sits at packed tap ph * M + (M - 1 - m)
    M = -(-k // stride)
    j = torch.arange(k)
    idx = (j % stride) * M + (M - 1 - j // stride)
    return w[:, idx.to(w.device)].permute(2, 0, 1).contiguous()


def int8_conv_packed_torch(x, w_p, s_w, bias, s_static, kernel_size: int,
                           stride: int, dilation: int, pad_left: int,
                           pad_right: int, transposed: bool,
                           causal: bool) -> torch.Tensor:
    """The plain version from the packed weight: ``int8_conv_torch`` on
    ``unpack_weight(w_p)``. The CPU's route of ``int8_conv1d``."""
    w_q = unpack_weight(w_p, x.shape[1], s_w.shape[0], kernel_size, transposed,
                        stride)
    return int8_conv_torch(x, w_q, s_w, bias, s_static, stride, dilation,
                           pad_left, pad_right, transposed, causal)


# --------------------------------------------------------------------- K2

class Int8ConvKernel:
    """The built library. ``launches`` counts conv launches, which are the
    device launches: one a conv.

    A layer's geometry is planned once a device (``_plan``: tile sizes,
    shared memory, the cooperative grid), and the dynamic scale's scratch
    (per-example partial maxima) is kept per device and stream and reused;
    a call allocates only its output."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None
        self._lock = threading.Lock()
        self._plans = {}
        self._scratch = {}

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            lib, self.build_log, self.build_seconds = build_library(
                SOURCE, "libkantts_int8_conv")
            p, i = ctypes.c_void_p, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.kantts_i8_plan.argtypes = [i] * 8 + [ip, ip]
            lib.kantts_i8_plan.restype = p
            lib.kantts_i8_conv.argtypes = [p] * 9 + [i] * 4 + [p]
            lib.kantts_i8_conv.restype = i
            self._lib = lib
            return lib

    def _plan(self, key: tuple) -> tuple:
        """-> (handle, blocks of the cooperative grid) of a geometry on a
        device, made once and kept."""
        dev, C_in, C_out, k, stride, dilation, pad_left, transposed, causal = key
        lib = self.build()
        if transposed:  # s phases of ceil(k / s) taps over the input rows
            taps = -(-k // stride)
            geo = (taps, 1, 1, taps - 1, stride, 0 if causal else pad_left)
        else:
            geo = (k, dilation, stride, pad_left, 1, 0)
        grid, err = ctypes.c_int(0), ctypes.c_int(0)
        with self._lock, torch.cuda.device(dev):
            if key in self._plans:
                return self._plans[key]
            handle = lib.kantts_i8_plan(C_in, C_out, *geo, ctypes.byref(grid),
                                        ctypes.byref(err))
            if not handle:
                raise ValueError(f"K2 cannot plan the conv {key}: cudaError "
                                 f"{err.value} (1: its window needs more shared "
                                 "memory than a block has)")
            plan = (handle, grid.value)
            self._plans[key] = plan
        return plan

    def _partials(self, dev: torch.device, stream: int, n: int) -> torch.Tensor:
        """The scratch of (device, stream), grown to n floats. Work on one
        stream is ordered, so one buffer serves every launch on it."""
        buf = self._scratch.get((dev, stream))
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 4096), dtype=torch.float32, device=dev)
            self._scratch[(dev, stream)] = buf
        return buf

    def __call__(self, x, w_p, s_w, bias, s_static, kernel_size: int, stride: int,
                 dilation: int, pad_left: int, pad_right: int, transposed: bool,
                 causal: bool, sums: bool = False,
                 s_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One conv -> (B, C_out, T') float32, or its int32 sums with
        ``sums``; ``s_out`` (B,) float32, if given, gets the scales used."""
        dev = x.device
        if not (dev.type == "cuda" and x.dtype == torch.float32 and x.dim() == 3
                and x.is_contiguous() and x.shape[2] >= 1
                and w_p.device == dev and w_p.dtype == torch.int8
                and w_p.is_contiguous() and w_p.dim() == 4
                and s_w.device == dev and s_w.dtype == torch.float32
                and s_w.dim() == 1
                and (bias is None or (bias.device == dev and bias.dtype == torch.float32
                                      and bias.shape == s_w.shape))
                and (s_static is None or (s_static.device == dev and s_static.numel() == 1
                                          and s_static.dtype == torch.float32))
                and (s_out is None or (s_out.device == dev and s_out.dtype == torch.float32
                                       and s_out.shape == (x.shape[0],)))):
            raise ValueError(
                "K2 takes x (B, C_in, T) contiguous float32, a packed int8 w_p, float32 "
                "s_w, bias and s_static (one element) on one CUDA device; got "
                f"x {x.dtype} {tuple(x.shape)} on {dev}, w_p {w_p.dtype} on {w_p.device}")
        B, C_in, T = x.shape
        C_out = s_w.shape[0]
        taps = -(-kernel_size // stride) * stride if transposed else kernel_size
        if w_p.shape != (-(-C_out // 16), taps, -(-C_in // 32), 512):
            raise ValueError(f"K2: packed weight {tuple(w_p.shape)} is not "
                             f"pack_weight's of a {C_in} -> {C_out}, k={kernel_size} "
                             f"{'transposed ' if transposed else ''}conv")
        T_out = out_len(T, kernel_size, stride, dilation, pad_left, pad_right,
                        transposed, causal)
        if T_out < 1:
            raise ValueError(f"K2: the conv has no output ({T_out} frames)")
        key = (dev, C_in, C_out, kernel_size, stride, dilation, pad_left, transposed,
               causal)
        handle, grid = self._plans.get(key) or self._plan(key)
        out = torch.empty((B, C_out, T_out),
                          dtype=torch.int32 if sums else torch.float32, device=dev)
        # the raw handle: building a torch.cuda.Stream costs ~6 us a call
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        partial = (None if s_static is not None
                   else self._partials(dev, stream, B * grid).data_ptr())
        args = (handle, x.data_ptr(), w_p.data_ptr(), s_w.data_ptr(),
                None if bias is None or sums else bias.data_ptr(),
                None if s_static is None else s_static.data_ptr(), partial,
                None if s_out is None else s_out.data_ptr(), out.data_ptr(), int(sums),
                B, T, T_out, stream)
        if dev.index == torch.cuda.current_device():
            err = self._lib.kantts_i8_conv(*args)
        else:
            with torch.cuda.device(dev):
                err = self._lib.kantts_i8_conv(*args)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: cudaError {err}")
        self.launches += 1
        return out


int8_conv_cuda = Int8ConvKernel()


# ------------------------------------------------- the kantts::int8_conv1d op

_LIB = torch.library.Library("kantts", "DEF")
_LIB.define("int8_conv1d(Tensor x, Tensor w_p, Tensor s_w, Tensor? bias, "
            "Tensor? s_static, int kernel_size, int stride, int dilation, "
            "int pad_left, int pad_right, bool transposed, bool causal) -> Tensor")
_LIB.impl("int8_conv1d", lambda *args: int8_conv_cuda(*args), "CUDA")
_LIB.impl("int8_conv1d", int8_conv_packed_torch, "CPU")


@torch.library.register_fake("kantts::int8_conv1d", lib=_LIB)
def _int8_conv1d_fake(x, w_p, s_w, bias, s_static, kernel_size, stride, dilation,
                      pad_left, pad_right, transposed, causal):
    T = out_len(x.shape[2], kernel_size, stride, dilation, pad_left, pad_right,
                transposed, causal)
    return x.new_empty((x.shape[0], s_w.shape[0], T))


def int8_conv1d(x: torch.Tensor, w_p: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor], s_static: Optional[torch.Tensor],
                kernel_size: int, stride: int, dilation: int, pad_left: int,
                pad_right: int, transposed: bool, causal: bool) -> torch.Tensor:
    """The int8 W8A8 conv (module docstring): K2 for a CUDA tensor, the
    plain version for a CPU one. An eager call goes straight to them; a
    traced one (``torch.export``, whose tensors are fake) is the operator
    ``kantts::int8_conv1d``, one node, which dispatches the same way."""
    args = (x, w_p, s_w, bias, s_static, kernel_size, stride, dilation, pad_left,
            pad_right, transposed, causal)
    if type(x) is not torch.Tensor:
        return torch.ops.kantts.int8_conv1d.default(*args)
    if x.device.type == "cuda":
        return int8_conv_cuda(*args)
    if x.device.type == "cpu":
        return int8_conv_packed_torch(*args)
    raise ValueError(f"int8_conv1d runs on cuda or cpu, got {x.device}")
