"""K2's time by phase on the card, for diagnosis.

    python3 tools/k2_profile.py

(1) A copy of ``kantts_tpu_torch/csrc/int8_conv.cu`` with clock64 counters at
the phase boundaries of each tile (and a barrier after the MMAs and after the
epilogue, so that a phase is the block's), built beside the library into
``build/kantts_tpu_torch/`` and swapped into the wrapper, runs at seven
shapes of a seeded hifigan_v1_16k at B=1 and B=8 with a dynamic and a static
scale. A line a case: us a call (CUDA events), SM cycles a block of the
prologue (with a dynamic scale: phase 1 and the grid's sync), and SM cycles a
tile of the wait for the window, the quantize, the load issue, the MMAs and
the epilogue. (2) The host's cost of one call of the real K2, piece by piece
(us, ``timeit``). The port never builds the copy.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time
import timeit

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from kantts_tpu_torch.bin.infer_hifigan import load_vocoder  # noqa: E402
from kantts_tpu_torch.configs import get_config  # noqa: E402
from kantts_tpu_torch.models.builder import model_builder, save_checkpoint  # noqa: E402
from kantts_tpu_torch.ops import int8_conv as K  # noqa: E402
from kantts_tpu_torch.ops.nvcc import BUILD_DIR, NVCC_FLAGS, find_nvcc  # noqa: E402

PHASES = ["prologue", "wait", "quantize", "issue", "mma", "epilogue", "tiles", "total"]
SHAPES = [(16, 3, 1), (16, 11, 7), (32, 7, 1), (64, 7, 3), (128, 11, 7), (256, 7, 1),
          (128, 10, 1)]  # (C_in, k, dilation) of the convs profiled


def counted_source() -> str:
    """The kernel's source with the counters; raises if an anchor moved."""
    src = open(K.SOURCE).read()
    edits = [
        ("namespace {\n", "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
        ("  const int g = lane / 4, t4 = lane % 4;\n  const int tiles",
         "  const int g = lane / 4, t4 = lane % 4;\n"
         "  long long T0 = clock64(), at[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tt = 0;\n"
         "  const int tiles"),
        ("  const int wm = warp % p.WM, wn = warp / p.WM;",
         "  __syncthreads();\n  at[0] = clock64() - T0;\n"
         "  const int wm = warp % p.WM, wn = warp / p.WM;"),
        ("    if (p.nbuf == 2)  // this tile", "    tt = clock64();\n    if (p.nbuf == 2)  // this tile"),
        ("    __syncthreads();  // the window has landed; the last tile's MMAs are done\n",
         "    __syncthreads();  // the window has landed; the last tile's MMAs are done\n"
         "    at[1] += clock64() - tt;\n    tt = clock64();\n"),
        ("    __syncthreads();  // xs is ready and fbuf free: a later window flies\n",
         "    __syncthreads();  // xs is ready and fbuf free: a later window flies\n"
         "    at[2] += clock64() - tt;\n    tt = clock64();\n"),
        ("    cp_async_commit();\n\n    const int q0",
         "    cp_async_commit();\n    at[3] += clock64() - tt;\n    tt = clock64();\n\n"
         "    const int q0"),
        ("    // epilogue: c0, c1",
         "    __syncthreads();\n    at[4] += clock64() - tt;\n    tt = clock64();\n"
         "    // epilogue: c0, c1"),
        ("  }\n  cp_async_wait_all();\n}",
         "    __syncthreads();\n    at[5] += clock64() - tt;\n    at[6] += 1;\n  }\n"
         "  cp_async_wait_all();\n  at[7] = clock64() - T0;\n  if (threadIdx.x == 0)\n"
         "    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)at[i]);\n}"),
        ('extern "C" {\n',
         'extern "C" {\nint kantts_i8_prof(unsigned long long* out) {\n'
         '  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n'
         '  unsigned long long z[8] = {0};\n'
         '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n'
         '  return (int)e;\n}\n'),
    ]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel source changed; anchor not found: {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


def counted_library() -> ctypes.CDLL:
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "int8_conv_counted.cu")
    with open(path, "w") as f:
        f.write(counted_source())
    lib_path = os.path.join(BUILD_DIR, "libkantts_int8_conv_counted.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib_path, path], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kantts_i8_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 2
    lib.kantts_i8_plan.restype = p
    lib.kantts_i8_conv.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.kantts_i8_conv.restype = i
    lib.kantts_i8_prof.argtypes = [p]
    lib.kantts_i8_prof.restype = i
    return lib


def host_costs(entry) -> None:
    """us a call of the pieces of K2's host path, on one conv of ``entry``."""
    dev = torch.device("cuda")
    g, mod = entry["g"], entry["mod"]
    x = torch.randn(1, g["C_in"], g["T"], device=dev)
    bias = mod.params.bias.detach()
    args = cs.k2_call_args(g)
    pieces = {
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.empty (the output)": lambda: torch.empty((1, g["C_out"], g["T"]), device=dev),
        "K2 wrapper": lambda: K.int8_conv_cuda(x, mod.w_p, mod.s_w, bias, None, *args),
        "int8_conv1d (eager)": lambda: K.int8_conv1d(x, mod.w_p, mod.s_w, bias, None, *args),
        "the operator": lambda: torch.ops.kantts.int8_conv1d(x, mod.w_p, mod.s_w, bias, None,
                                                            *args),
        "the layer": lambda: mod(x),
    }
    with torch.inference_mode():
        for name, fn in pieces.items():
            fn()
            torch.cuda.synchronize()
            us = timeit.timeit(fn, number=200) / 200 * 1e6
            torch.cuda.synchronize()
            print(f"host {name}: {us:.2f} us", flush=True)


def main() -> int:
    print(cs.phase_device(), flush=True)
    with tempfile.TemporaryDirectory(prefix="k2_profile_") as tmp:
        cfg = get_config("hifigan_v1_16k")
        path = os.path.join(tmp, "voc.pt")
        save_checkpoint(path, model_builder(cfg, seed=2), cfg)
        gen8, _ = load_vocoder(path, torch.device("cuda"), quant=True)
    _, distinct = cs.k2_distinct(gen8)
    host_costs([e for e in distinct if e["g"]["C_in"] == 16][0])
    K.int8_conv_cuda.build()
    lib = counted_library()
    K.int8_conv_cuda._lib, K.int8_conv_cuda._plans = lib, {}
    counts = (ctypes.c_ulonglong * 8)()
    for entry in distinct:
        g, mod = entry["g"], entry["mod"]
        if (g["C_in"], g["k"], g["dilation"]) not in SHAPES:
            continue
        for B in (1, 8):
            x = torch.randn(B, g["C_in"], g["T"], device="cuda")
            for s_static in (None, torch.tensor(0.01, device="cuda")):
                def call():
                    return K.int8_conv_cuda(x, mod.w_p, mod.s_w, mod.params.bias.detach(),
                                            s_static, *cs.k2_call_args(g))
                call()
                torch.cuda.synchronize()
                lib.kantts_i8_prof(counts)
                us = cs.cuda_ms(call, 10) * 1e3  # 11 calls
                lib.kantts_i8_prof(counts)
                blocks = [v for k, v in K.int8_conv_cuda._plans.items()
                          if k[1:4] == (g["C_in"], g["C_out"], g["k"])
                          and k[5] == g["dilation"]][0][1]
                if s_static is not None:  # a static scale launches no block beyond the tiles
                    blocks = min(blocks, counts[6] // 11)
                tiles = max(1, counts[6])
                per_tile = {PHASES[j]: round(counts[j] / tiles) for j in range(1, 6)}
                print(f"{'convT' if g['transposed'] else 'conv'} {g['C_in']}->{g['C_out']} "
                      f"k{g['k']} d{g['dilation']} T{g['T']} B={B} "
                      f"{'static' if s_static is not None else 'dynamic'}: {us:.1f} us "
                      f"blocks={blocks} tiles={counts[6] // 11} "
                      f"prologue_cycles={counts[0] / 11 / blocks:.0f} "
                      f"cycles_a_tile={per_tile}", flush=True)
    print(time.strftime("%Y-%m-%d %H:%M:%S"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
