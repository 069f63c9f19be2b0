// K2: the int8 W8A8 1-D convolution of the HiFi-GAN vocoder, for Hopper
// (sm_90a), with a plain C interface bound by ctypes (ops/int8_conv.py).
//
// Replaces no TPU kernel: the JAX package computes the int8 conv with XLA
// (lax.conv_general_dilated / conv_transpose with preferred_element_type
// int32, kantts_tpu/models/hifigan/layers.py:161-171, 236-245). PyTorch has
// no int8 conv1d on CUDA, so the port's is this kernel.
//
// Three launches per conv:
//   1. i8_amax_kernel:     per-example partial maxima of |x| (dynamic scales)
//   2. i8_quantize_kernel: s_x[b] = max(amax, 1e-12) / 127 (or the static
//      scale), q = clip(rint(x / s_x), -127, 127) as int8, written
//      channels-last (B, Tp, Cp) with the conv's zero padding in int8 (zero
//      quantizes to zero, so the amax never sees padding)
//   3. i8_conv_kernel:     an implicit GEMM over (B*T') x C_out x (C_in*k)
//      on __dp4a (4 int8 products a lane a cycle), summed in int32; the
//      epilogue is float(acc) * (s_x[b] * s_w[o]) + bias[o], each op
//      rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), the
//      JAX package's order of operations.
//
// Exactness: rintf rounds half to even, as jnp.round does; the division by
// s is __fdiv_rn, as JAX divides (not a multiply by 1/s); int32 sums are
// order-exact, so the result does not depend on the tiling.
//
// Bound on this card: at the shapes of hifigan_v1_16k (K = C_in * k up to
// 1792) the work is operations, not bytes; __dp4a runs on the CUDA cores,
// far below the tensor cores' int8 rate (1,979 TOP/s). A wgmma kernel with
// the quantize fused into its loads is the later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 64;         // output times a block
constexpr int OT = 32;         // output channels a block
constexpr int CIW = 8;         // channel words (4 int8 each) per chunk: 32 channels
constexpr int THREADS = 256;   // 16 x 16: 4 times x 2 channels a thread
constexpr int AMAX_THREADS = 256;
constexpr int MAX_PARTIALS = 128;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void i8_amax_kernel(const float* __restrict__ x, float* __restrict__ partial,
                               long long n, int P) {
  // grid (P, B): block p of example b reduces a contiguous slice
  const int b = blockIdx.y, p = blockIdx.x;
  const float* xb = x + (long long)b * n;
  long long per = (n + P - 1) / P;
  long long lo = per * p, hi = min(n, lo + per);
  float m = 0.0f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) m = fmaxf(m, fabsf(xb[i]));
  __shared__ float red[AMAX_THREADS];
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[b * P + p] = red[0];
}

// grid (ceil(Tp/32), ceil(Cp/32), B), block (32, 8). x (B, C, T) f32;
// q (B, Tp, Cp) int8 with Tp = T + pad_left + pad_right.
__global__ void i8_quantize_kernel(const float* __restrict__ x, const float* __restrict__ partial,
                                   int P, const float* __restrict__ s_static,
                                   float* __restrict__ s_out, int8_t* __restrict__ q,
                                   int C, int T, int Cp, int Tp, int pad_left) {
  const int b = blockIdx.z;
  __shared__ float s_sh;
  __shared__ int8_t tile[32][33];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (tid < 32) {
    float m;
    if (s_static != nullptr) {
      m = fmaxf(s_static[0], 1e-12f);
    } else {
      m = 0.0f;
      for (int i = tid; i < P; i += 32) m = fmaxf(m, partial[b * P + i]);
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      m = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    }
    if (tid == 0) {
      s_sh = m;
      if (blockIdx.x == 0 && blockIdx.y == 0) s_out[b] = m;
    }
  }
  __syncthreads();
  const float s = s_sh;
  const int tp0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  // read: channel rows, coalesced along time
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, tp = tp0 + threadIdx.x, t = tp - pad_left;
    int8_t v = 0;
    if (c < C && t >= 0 && t < T) {
      float r = rintf(__fdiv_rn(x[((long long)b * C + c) * T + t], s));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      v = (int8_t)(int)r;
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  // write: 32 time rows of 8 words (32 channels), coalesced along channels
  const int row = tid / 8, w = tid % 8;
  const int tp = tp0 + row, cw = c0 / 4 + w;
  if (tp < Tp && cw * 4 < Cp) {
    uint32_t word = (uint32_t)(uint8_t)tile[4 * w][row]
                    | ((uint32_t)(uint8_t)tile[4 * w + 1][row] << 8)
                    | ((uint32_t)(uint8_t)tile[4 * w + 2][row] << 16)
                    | ((uint32_t)(uint8_t)tile[4 * w + 3][row] << 24);
    reinterpret_cast<uint32_t*>(q)[((long long)b * Tp + tp) * (Cp / 4) + cw] = word;
  }
}

// grid (ceil(T_out/TT), ceil(C_out/OT), B), THREADS threads, dynamic shared
// memory: R rows x (CIW + 1) words of input, OT x (k * CIW + 1) words of
// weights. q (B, Tp, Cp) int8 channels-last; w (C_out, C_in, k) int8 for the
// conv, (C_in, C_out, k) for the transposed conv; out (B, C_out, T_out) f32.
// Conv: output t reads rows t * stride + j * dil of the padded input.
// Transposed: output t is full index tf = t + trim; tap j = tf % s + m * s
// reads input row tf / s - m (zero outside [0, T)).
__global__ void __launch_bounds__(THREADS)
i8_conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
               const float* __restrict__ s_x, const float* __restrict__ s_w,
               const float* __restrict__ bias, float* __restrict__ out, int sums,
               int C_in, int Cp, int Tp, int C_out, int k, int T_out,
               int stride, int dil, int transposed, int trim, int R) {
  extern __shared__ int smem[];
  int* xs = smem;                       // R x (CIW + 1)
  int* ws = smem + R * (CIW + 1);       // OT x (k * CIW + 1)
  const int wrow = k * CIW + 1;
  const int b = blockIdx.z, t0 = blockIdx.x * TT, o0 = blockIdx.y * OT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int Cw = Cp / 4;
  const int* qw = reinterpret_cast<const int*>(q) + (long long)b * Tp * Cw;
  // the first input row of the window
  const int r0 = transposed ? floor_div(t0 + trim - (k - 1), stride) : t0 * stride;

  int acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0;

  for (int cw0 = 0; cw0 < Cw; cw0 += CIW) {
    __syncthreads();
    for (int i = threadIdx.x; i < R * CIW; i += THREADS) {
      const int r = i / CIW, c = i % CIW, row = r0 + r, cw = cw0 + c;
      int v = 0;
      if (row >= 0 && row < Tp && cw < Cw) v = qw[(long long)row * Cw + cw];
      xs[r * (CIW + 1) + c] = v;
    }
    for (int i = threadIdx.x; i < OT * k * CIW; i += THREADS) {
      const int o = i / (k * CIW), rem = i % (k * CIW), j = rem / CIW, c = rem % CIW;
      const int oo = o0 + o;
      uint32_t word = 0;
      if (oo < C_out) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = (cw0 + c) * 4 + e;
          if (ci < C_in) {
            const long long idx = transposed ? ((long long)ci * C_out + oo) * k + j
                                             : ((long long)oo * C_in + ci) * k + j;
            word |= (uint32_t)(uint8_t)w[idx] << (8 * e);
          }
        }
      }
      ws[o * wrow + j * CIW + c] = (int)word;
    }
    __syncthreads();
    if (!transposed) {
      for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int c = 0; c < CIW; ++c) {
          int xv[4], wv[2];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = (tx + 16 * a) * stride + j * dil;
            xv[a] = r < R ? xs[r * (CIW + 1) + c] : 0;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) wv[e] = ws[(ty + 16 * e) * wrow + j * CIW + c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[a][e] = __dp4a(xv[a], wv[e], acc[a][e]);
        }
      }
    } else {
      const int taps = (k + stride - 1) / stride;
      for (int m = 0; m < taps; ++m) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int tf = t0 + tx + 16 * a + trim;
          const int j = tf % stride + m * stride;
          const int r = tf / stride - m - r0;
          if (j >= k || r < 0 || r >= R) continue;
#pragma unroll
          for (int c = 0; c < CIW; ++c) {
            const int xv = xs[r * (CIW + 1) + c];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[a][e] = __dp4a(xv, ws[(ty + 16 * e) * wrow + j * CIW + c], acc[a][e]);
          }
        }
      }
    }
  }

  const float sx = s_x[b];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int o = o0 + ty + 16 * e;
    if (o >= C_out) continue;
    const float scale = __fmul_rn(sx, s_w[o]);
    const float bo = bias != nullptr ? bias[o] : 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = t0 + tx + 16 * a;
      if (t >= T_out) continue;
      if (sums) {  // the int32 sums themselves, for checking them exactly
        reinterpret_cast<int*>(out)[((long long)b * C_out + o) * T_out + t] = acc[a][e];
        continue;
      }
      float y = __fmul_rn(__int2float_rn(acc[a][e]), scale);
      if (bias != nullptr) y = __fadd_rn(y, bo);
      out[((long long)b * C_out + o) * T_out + t] = y;
    }
  }
}

int window_rows(int k, int stride, int dil, int transposed) {
  if (!transposed) return (TT - 1) * stride + (k - 1) * dil + 1;
  // floor((t0+TT-1+trim)/s) - floor((t0+trim-(k-1))/s) + 1 <= (TT-1+k-1)/s + 2
  return (TT + k - 2) / stride + 2;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a conv launch of this shape takes.
long long kantts_i8_conv_smem(int k, int stride, int dil, int transposed) {
  const int R = window_rows(k, stride, dil, transposed);
  return (long long)(R * (CIW + 1) + OT * (k * CIW + 1)) * 4;
}

int kantts_i8_partials(long long n) {
  long long p = (n + 8 * AMAX_THREADS - 1) / (8 * AMAX_THREADS);
  return (int)(p < 1 ? 1 : (p > MAX_PARTIALS ? MAX_PARTIALS : p));
}

// Dynamic scales: s_static == NULL, partial holds B * P floats.
// Static scale: s_static points at one float, partial is unused.
int kantts_i8_quantize_act(const float* x, float* partial, const float* s_static,
                           float* s_out, void* q, int B, int C, int T, int Cp,
                           int pad_left, int pad_right, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n = (long long)C * T;
  int P = 1;
  if (s_static == nullptr) {
    P = kantts_i8_partials(n);
    i8_amax_kernel<<<dim3(P, B), AMAX_THREADS, 0, stream>>>(x, partial, n, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int Tp = T + pad_left + pad_right;
  dim3 grid((Tp + 31) / 32, (Cp + 31) / 32, B);
  i8_quantize_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      x, partial, P, s_static, s_out, (int8_t*)q, C, T, Cp, Tp, pad_left);
  return (int)cudaGetLastError();
}

// sums != 0 writes the int32 sums into out in place of the float32 result.
int kantts_i8_conv(const void* q, const void* w, const float* s_x, const float* s_w,
                   const float* bias, void* out, int sums, int B, int C_in, int Cp, int Tp,
                   int C_out, int k, int T_out, int stride, int dil, int transposed,
                   int trim, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int R = window_rows(k, stride, dil, transposed);
  const long long smem = kantts_i8_conv_smem(k, stride, dil, transposed);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        i8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T_out + TT - 1) / TT, (C_out + OT - 1) / OT, B);
  i8_conv_kernel<<<grid, THREADS, smem, stream>>>(
      (const int8_t*)q, (const int8_t*)w, s_x, s_w, bias, (float*)out, sums, C_in, Cp, Tp, C_out,
      k, T_out, stride, dil, transposed, trim, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
