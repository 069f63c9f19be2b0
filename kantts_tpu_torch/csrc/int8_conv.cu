// K2: the int8 W8A8 1-D convolution of the HiFi-GAN vocoder, for Hopper
// (sm_90a), with a plain C interface bound by ctypes (ops/int8_conv.py).
//
// Replaces no TPU kernel: the JAX package leaves its int8 conv to XLA
// (lax.conv_general_dilated / conv_transpose with preferred_element_type
// int32, kantts_tpu/models/hifigan/layers.py:161-171, 236-245). PyTorch has
// no int8 conv1d on CUDA, so the port's is this kernel.
//
// What it computes, exactly as int8_conv_torch does:
//   s_x[b] = max(amax |x[b]|, 1e-12) / 127 (__fdiv_rn), or the static
//            max(s_static, 1e-12);
//   q      = clip(rint(x / s_x), -127, 127) (rintf rounds half to even, as
//            jnp.round; the division is __fdiv_rn, as JAX divides);
//   acc    = the int32 sums of the conv of q with the int8 weights, in any
//            order (integer sums are order-exact, so the tiling cannot
//            change them);
//   y      = float(acc) * (s_x[b] * s_w[o]) + bias[o], each op rounded on
//            its own (__fmul_rn, __fadd_rn: no FMA contraction).
//
// Bound on this card: bytes, at every shape of hifigan_v1_16k. A conv reads
// x in float32 and writes y in float32; its operations (2 C_in k an output,
// 3.5e10 MACs for the 104 convs of a 5 s call at B=1) take 0.039 ms at the
// int8 tensor cores' 1,979 TOP/s against 0.275 ms of bytes at 3.35 TB/s,
// and stay below the bytes at mma.sync's lower rate.
//
// How the design meets that bound: one launch a conv, and x crosses device
// memory once in each direction (twice in with a dynamic scale, the second
// time partly from the 50 MB L2).
//   - One persistent cooperative kernel (cudaLaunchCooperativeKernel on
//     occupancy x SMs blocks: 2 an SM, 3 for 16 output channels). Phase 1,
//     with a dynamic scale: each block writes per-example partial maxima of
//     |x| to a scratch buffer (8 examples a pass, their loads in flight
//     together), then cooperative_groups::this_grid().sync(). Phase 2: each
//     block reduces the partials to every example's s_x and walks output
//     tiles. A static scale skips phase 1 and the sync.
//   - The quantize is fused into the loads: a block copies its float32
//     window of x (all input channels; the conv's zero padding as zeros) into
//     shared memory with 16-byte cp.async, one or two tiles ahead (the first
//     ones during phase 1), quantizes it in registers and stores int8
//     channels-last in shared memory (row stride = 4 mod 8 words: the
//     fragment reads are free of bank conflicts). No int8 activation buffer
//     goes to device memory. The division by s_x is a multiply by
//     __frcp_rn(s_x) except within 1e-4 of a half-integer, where __fdiv_rn
//     decides: the rounded values are those of the division everywhere.
//   - Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32 with M = output
//     channels, N = output positions, K = (tap, 32 input channels). A warp
//     holds a 16 or 32 x 32 tile of int32 sums in registers.
//   - Weights packed once (ops/int8_conv.py::pack_weight) in the order of
//     the MMA's A fragments: (C_out/16, taps, C_in/32, 32 lanes x 16 bytes).
//     A warp loads a fragment as one 16-byte ld.global.nc a lane, straight
//     into the registers the MMA reads, one step ahead (the weights are at
//     most 655 KB and stay in L2 and L1; shared memory holds only the
//     activations). C_in is padded with zero weights to a multiple of 32:
//     the 16-channel stage spends half of each k32 step on zeros, which
//     costs no bytes.
//   - The transposed convs run as polyphase convs: output phase t mod s of a
//     stride-s transposed conv is a conv of ceil(k/s) taps (2 in every
//     upsampling layer of hifigan_v1_16k, k = 2s) over the input, its taps
//     packed in reverse, so the same MMA loop serves it. A phase is a tile
//     of its own; the causal and two-ended trims are an offset of the
//     output index.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NWARP = 32;             // output positions a warp: 4 n8 tiles
constexpr int MAX_MB = 128;           // output channels a block

struct Conv {
  const float* x;         // (B, C_in, T) float32
  const int4* wp;         // packed weights (Mp/16, P*k, Cp/32, 32 x 16 bytes)
  const float* s_w;       // (C_out,)
  const float* bias;      // (C_out,) or null
  const float* s_static;  // one float, or null: dynamic scales
  float* partial;         // (B, gridDim.x) partial maxima (dynamic scales)
  float* s_out;           // (B,) the scales used, or null
  void* out;              // (B, C_out, T_out) float32, or the int32 sums
  int sums;
  int vec;                // T % 4 == 0 and x 16-byte aligned: float4 loads
  int B, C_in, T, C_out, T_out;
  int Cp, Mp16;           // C_in padded to 32; C_out padded to 16, in m16 tiles
  int k, dil, stride;     // taps of a phase, their dilation, the input stride
  int pad;                // x index of window row 0 is q0 * stride - pad
  int P, trim;            // phases; output t = q * P + phase - trim
  int q_begin, Q;         // positions q in [q_begin, q_begin + Q) of each phase
  int MB, WM;             // output channels a block, warps along M
  int NB, R, S4;          // positions a block, window rows, row stride (words)
  int RF, xs_words;      // floats a channel in fbuf; words of xs before it
  int nbuf;               // float32 windows in flight (1 or 2)
  int n_mblk, n_nblk;
  int mw;                 // m16 tiles a warp (the kernel's template argument)
  int smem, grid;         // of the plan
};

// clip(rint(v / s), -127, 127) of 16 values, with v / s rounded as
// __fdiv_rn rounds it. inv = __frcp_rn(s): y = v * inv lies within
// |v / s| * 2^-23 of v / s (2^-16 where it matters, |v / s| <= 128), so
// rint(y) equals rint(__fdiv_rn(v, s)) unless y is within that of a
// half-integer; there (rarely, one branch for the 16) the exact division
// decides. Rounding is by the magic number 1.5 * 2^23 (full-rate adds; rint's
// and the int conversion's unit runs at a quarter of that): for |y| <= 127,
// y + M rounds y to an integer, half to even, whose value sits in the low
// bits. NaN clips to -127 either way. -> q[i] in the low byte of each word.
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
constexpr int MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ void quantize16(const float (&v)[16], float s, float inv,
                                           uint32_t (&q)[16]) {
  float y[16];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    y[i] = fminf(fmaxf(__fmul_rn(v[i], inv), -127.0f), 127.0f);
    const float r = __fsub_rn(__fadd_rn(y[i], MAGIC), MAGIC);
    near |= fabsf(fabsf(__fsub_rn(y[i], r)) - 0.5f) < 1e-4f;
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float r = __fsub_rn(__fadd_rn(y[i], MAGIC), MAGIC);
      if (fabsf(fabsf(__fsub_rn(y[i], r)) - 0.5f) < 1e-4f)
        y[i] = fminf(fmaxf(__fdiv_rn(v[i], s), -127.0f), 127.0f);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    q[i] = (uint32_t)(__float_as_int(__fadd_rn(y[i], MAGIC)) - MAGIC_BITS);
}

// Four int8 values (the low bytes of a, b, c, d) as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Phase 1: this block's share of max |x[b]| for every example b: the same
// slice of each example, PB examples a pass, so that a thread has PB loads
// in flight; one block reduction a pass.
constexpr int PB = 8;

__device__ void partial_maxima(const Conv& p, float (*red)[PB]) {
  const long long n = (long long)p.C_in * p.T;
  const int G = gridDim.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  const long long nv = vec ? n >> 2 : n, per = (nv + G - 1) / G;
  const long long lo = per * blockIdx.x, hi = min(nv, lo + per);
  for (int b0 = 0; b0 < p.B; b0 += PB) {
    float m[PB];
#pragma unroll
    for (int u = 0; u < PB; ++u) m[u] = 0.0f;
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      // every load of the pass in flight at once: past the last example the
      // index repeats it (its maximum is not written)
      if (vec) {
        float4 v[PB];
#pragma unroll
        for (int u = 0; u < PB; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(p.x + min(b0 + u, p.B - 1) * n) + i);
#pragma unroll
        for (int u = 0; u < PB; ++u)
          m[u] = fmaxf(m[u], fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                                   fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
      } else {
        float v[PB];
#pragma unroll
        for (int u = 0; u < PB; ++u) v[u] = __ldg(p.x + min(b0 + u, p.B - 1) * n + i);
#pragma unroll
        for (int u = 0; u < PB; ++u) m[u] = fmaxf(m[u], fabsf(v[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < PB; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
      if (lane == 0) red[warp][u] = m[u];
    }
    __syncthreads();
    if (threadIdx.x < PB && b0 + (int)threadIdx.x < p.B) {
      float mm = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, red[w][threadIdx.x]);
      p.partial[(b0 + threadIdx.x) * G + blockIdx.x] = mm;
    }
    __syncthreads();
  }
}

// A block keeps the scales of SB examples in shared memory at a time.
constexpr int SB = 64;

// s[b - b0] = the scale of example b for b in [b0, min(b0 + SB, B)), after
// phase 1 and the grid's sync: a warp an example reduces its partials.
__device__ void scales_of(const Conv& p, int b0, float* s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = b0 + warp; b < p.B && b < b0 + SB; b += WARPS) {
    float m;
    if (p.s_static != nullptr) {
      m = fmaxf(__ldg(p.s_static), 1e-12f);
    } else {
      m = 0.0f;  // the partials were written in this launch: no ldg
      for (int i = lane; i < (int)gridDim.x; i += 32) m = fmaxf(m, p.partial[b * gridDim.x + i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      m = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
    }
    if (lane == 0) s[b - b0] = m;
  }
}

__device__ __forceinline__ void mma_s8(int* c, const int4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tile's example, m-block, phase and n-block; n-blocks run fastest.
struct Tile {
  int b, mb, ph, nb;
};

__device__ __forceinline__ Tile tile_of(const Conv& p, int tile) {
  Tile t;
  t.nb = tile % p.n_nblk;
  int rest = tile / p.n_nblk;
  t.ph = rest % p.P;
  rest /= p.P;
  t.mb = rest % p.n_mblk;
  t.b = rest / p.n_mblk;
  return t;
}

// x index of window row 0 of n-block nb, rounded down to a multiple of 4.
__device__ __forceinline__ long long window_start(const Conv& p, int nb, int* off) {
  const long long x0 = (long long)(p.q_begin + nb * p.NB) * p.stride - p.pad;
  *off = (int)(((x0 % 4) + 4) % 4);
  return x0 - *off;
}

// Copy the float32 window of a tile (all input channels, x indices
// [xa, xa + RF)) into fbuf (C_in rows of RF floats): 16-byte cp.async
// copies, zero-filled outside [0, T), which the caller commits and waits
// for; without aligned float4 rows (p.vec == 0), plain loads and stores.
__device__ void load_window(const Conv& p, int tile, float* fbuf) {
  const Tile t = tile_of(p, tile);
  int off;
  const long long xa = window_start(p, t.nb, &off);
  const float* xb = p.x + (long long)t.b * p.C_in * p.T;
  const int chunks = p.RF / 4;
  for (int i = threadIdx.x; i < p.C_in * chunks; i += THREADS) {
    const int c = i / chunks, j = i - c * chunks;
    const long long xt = xa + 4 * j;
    const float* src = xb + (long long)c * p.T + xt;
    float* dst = fbuf + c * p.RF + 4 * j;
    if (p.vec) {
      const bool inside = xt >= 0 && xt < p.T;  // T % 4 == 0: a chunk is in or out
      cp_async16(dst, inside ? src : xb, inside ? 16 : 0);
    } else {
      float4 v;
      v.x = xt >= 0 && xt < p.T ? __ldg(src) : 0.0f;
      v.y = xt + 1 >= 0 && xt + 1 < p.T ? __ldg(src + 1) : 0.0f;
      v.z = xt + 2 >= 0 && xt + 2 < p.T ? __ldg(src + 2) : 0.0f;
      v.w = xt + 3 >= 0 && xt + 3 < p.T ? __ldg(src + 3) : 0.0f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// MW: m16 tiles a warp (1 for a block of 16 output channels, else 2). The
// 16-channel variant fits 80 registers, so 3 blocks share an SM.
template <int MW>
__global__ void __launch_bounds__(THREADS, MW == 1 ? 3 : 2) i8_conv_kernel(const Conv p) {
  // xs: the int8 window, RF rows x S4 words, channels-last; then nbuf
  // float32 windows of the next tiles, C_in rows x RF floats each
  extern __shared__ __align__(16) uint32_t xs[];
  float* const fbufs = reinterpret_cast<float*>(xs + p.xs_words);
  const int fstride = p.C_in * p.RF;
  __shared__ float red8[WARPS][PB];
  __shared__ float s_win[SB];  // the scales of examples [s_base, s_base + SB)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tiles = p.B * p.n_mblk * p.P * p.n_nblk;

  // the first tiles' windows are in flight during phase 1 and the grid's
  // sync; a tile's window is asked for nbuf tiles ahead
  for (int d = 0; d < p.nbuf; ++d) {
    const int t = blockIdx.x + d * gridDim.x;
    if (t < tiles) load_window(p, t, fbufs + d * fstride);
    cp_async_commit();
  }
  // the words of channels past C_in stay zero (their weights are zero too)
  for (int i = tid; i < p.xs_words; i += THREADS) xs[i] = 0u;
  if (p.s_static == nullptr) {
    partial_maxima(p, red8);
    cg::this_grid().sync();
  }
  if (p.s_out != nullptr && blockIdx.x == 0) {
    for (int b0 = 0; b0 < p.B; b0 += SB) {
      __syncthreads();
      scales_of(p, b0, s_win);
      __syncthreads();
      for (int b = b0 + tid; b < p.B && b < b0 + SB; b += THREADS) p.s_out[b] = s_win[b - b0];
    }
  }
  int s_base = 0;
  __syncthreads();
  scales_of(p, 0, s_win);
  __syncthreads();

  const int wm = warp % p.WM, wn = warp / p.WM;
  const int nC = p.Cp / 32, KT = p.P * p.k, steps = p.k * nC;
  const int cw_n = (p.C_in + 3) / 4;
  int cur_b = -1, it = 0;
  float s = 0.0f, inv = 0.0f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const Tile tc = tile_of(p, tile);
    if (tc.b != cur_b) {  // block-uniform: tiles run in increasing order
      if (tc.b >= s_base + SB) {
        s_base = tc.b;
        __syncthreads();
        scales_of(p, s_base, s_win);
        __syncthreads();
      }
      s = s_win[tc.b - s_base];
      inv = __frcp_rn(s);
      cur_b = tc.b;
    }
    float* const fbuf = fbufs + (it % p.nbuf) * fstride;
    int off;
    window_start(p, tc.nb, &off);
    const int groups = (p.R + off + 3) / 4;
    if (p.nbuf == 2)  // this tile's group is done; the next one may fly on
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      cp_async_wait_all();
    __syncthreads();  // the window has landed; the last tile's MMAs are done
    // quantize: item (group of 4 rows, word of 4 channels), 8 groups
    // running fastest: 4 float4 reads of fbuf, 4 int8 words to xs
    const int groups8 = (groups + 7) / 8 * 8;
    for (int i = tid; i < cw_n * groups8; i += THREADS) {
      const int hi = i / 8, cw = hi % cw_n, rg = i % 8 + 8 * (hi / cw_n);
      if (rg >= groups) continue;
      float v[16];  // v[4 e + u]: channel 4 cw + e, row 4 rg + u
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * cw + e;
        const float4 f = c < p.C_in ? *reinterpret_cast<const float4*>(fbuf + c * p.RF + 4 * rg)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[4 * e] = f.x;
        v[4 * e + 1] = f.y;
        v[4 * e + 2] = f.z;
        v[4 * e + 3] = f.w;
      }
      uint32_t q[16];
      quantize16(v, s, inv, q);
#pragma unroll
      for (int u = 0; u < 4; ++u)  // quantize(0) is 0: padding stays zero
        xs[(4 * rg + u) * p.S4 + cw] = pack4(q[u], q[4 + u], q[8 + u], q[12 + u]);
    }
    __syncthreads();  // xs is ready and fbuf free: a later window flies
    if (tile + p.nbuf * (int)gridDim.x < tiles)
      load_window(p, tile + p.nbuf * gridDim.x, fbuf);
    cp_async_commit();

    const int q0 = p.q_begin + tc.nb * p.NB, ph = tc.ph;
    const int m16_0 = (tc.mb * p.MB) / 16 + wm * MW;
    bool valid[MW];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) valid[mi] = m16_0 + mi < p.Mp16;
    // lane (g, t4) reads position wn * 32 + ni * 8 + g, channel words t4 and 4 + t4
    const uint32_t* xl = xs + ((wn * NWARP + g) * p.stride + off) * p.S4 + t4;
    const int n8_rows = 8 * p.stride * p.S4;
    int acc[MW][4][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    // fragment (mi, tap j, chunk c) of this phase: wp[((m16 * KT + ph * k + j) * nC + c) * 32 + lane]
    const int4* wph = p.wp + ((long long)m16_0 * KT + ph * p.k) * nC * 32 + lane;
    const long long m16_step = (long long)KT * nC * 32;
    // both operands of step it + 1 are loaded while step it's MMAs run
    int4 a[MW], a_next[MW];
    uint32_t bf[4][2], bf_next[4][2];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
      a[mi] = valid[mi] ? __ldg(wph + mi * m16_step) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      bf[ni][0] = xl[ni * n8_rows];
      bf[ni][1] = xl[ni * n8_rows + 4];
    }
    int jn = 0, cn = 0;
    for (int it = 0; it < steps; ++it) {
      if (++cn == nC) {
        cn = 0;
        ++jn;
      }
      if (it + 1 < steps) {
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
          a_next[mi] = valid[mi] ? __ldg(wph + mi * m16_step + (jn * nC + cn) * 32)
                                 : make_int4(0, 0, 0, 0);
        const uint32_t* xr = xl + jn * p.dil * p.S4 + cn * 8;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bf_next[ni][0] = xr[ni * n8_rows];
          bf_next[ni][1] = xr[ni * n8_rows + 4];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        if (!valid[mi]) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni][0], bf[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) a[mi] = a_next[mi];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        bf[ni][0] = bf_next[ni][0];
        bf[ni][1] = bf_next[ni][1];
      }
    }

    // epilogue: c0, c1 at (row g, cols 2 t4, 2 t4 + 1), c2, c3 at row g + 8;
    // t < T_out implies q < q_begin + Q
    const int t_lane = (q0 + wn * NWARP + 2 * t4) * p.P + ph - p.trim;
    // a conv with an even T_out: t_lane is even (q0 is a multiple of 32)
    const bool pairs = p.P == 1 && p.trim == 0 && (p.T_out & 1) == 0;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (m16_0 + mi) * 16 + g + 8 * h;
        if (!valid[mi] || o >= p.C_out) continue;
        const float scale = __fmul_rn(s, __ldg(p.s_w + o));
        const float bo = p.bias != nullptr ? __ldg(p.bias + o) : 0.0f;
        const long long row = ((long long)tc.b * p.C_out + o) * p.T_out;
        if (pairs) {  // c0, c1 (c2, c3) are neighbours in time: one 8-byte store
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int t = t_lane + ni * 8;
            if (t >= p.T_out) continue;  // T_out is even: t + 1 < T_out
            const int v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
            if (p.sums) {
              *reinterpret_cast<int2*>(reinterpret_cast<int*>(p.out) + row + t) =
                  make_int2(v0, v1);
              continue;
            }
            float2 y = make_float2(__fmul_rn(__int2float_rn(v0), scale),
                                   __fmul_rn(__int2float_rn(v1), scale));
            if (p.bias != nullptr) y = make_float2(__fadd_rn(y.x, bo), __fadd_rn(y.y, bo));
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + row + t) = y;
          }
          continue;
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t_lane + (ni * 8 + e) * p.P;
            if ((unsigned)t >= (unsigned)p.T_out) continue;
            const int v = acc[mi][ni][2 * h + e];
            if (p.sums) {  // the int32 sums themselves, for checking them exactly
              reinterpret_cast<int*>(p.out)[row + t] = v;
              continue;
            }
            float y = __fmul_rn(__int2float_rn(v), scale);
            if (p.bias != nullptr) y = __fadd_rn(y, bo);
            reinterpret_cast<float*>(p.out)[row + t] = y;
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

const void* kernel_of(int mw) {
  return mw == 2 ? (const void*)i8_conv_kernel<2> : (const void*)i8_conv_kernel<1>;
}

}  // namespace

extern "C" {

// The launch plan of a conv geometry on the current device, made once per
// layer: tile sizes, shared memory and the cooperative grid (occupancy x
// SMs); the kernels' shared-memory limit is raised here, not per call.
//   C_in, C_out; k: taps of a phase; dil, stride: of the input rows;
//   pad: x index of window row 0 is q0 * stride - pad; P: phases (1 for a
//   conv, the stride of a transposed conv); trim: output t = q * P + phase
//   - trim. -> a handle for kantts_i8_conv (kept for the process), or null
//   with *err set; *grid gets the blocks a launch may take.
void* kantts_i8_plan(int C_in, int C_out, int k, int dil, int stride, int pad, int P,
                     int trim, int* grid, int* err) {
  Conv c = {};
  c.C_in = C_in;
  c.C_out = C_out;
  c.Cp = (C_in + 31) / 32 * 32;
  c.Mp16 = (C_out + 15) / 16;
  c.k = k;
  c.dil = dil;
  c.stride = stride;
  c.pad = pad;
  c.P = P;
  c.trim = trim;
  c.q_begin = trim / P;
  c.MB = 16;
  while (c.MB < c.Mp16 * 16 && c.MB < MAX_MB) c.MB *= 2;
  c.mw = c.MB >= 32 ? 2 : 1;
  c.WM = c.MB / (16 * c.mw);
  c.NB = (WARPS / c.WM) * NWARP;
  c.R = (c.NB - 1) * stride + (k - 1) * dil + 1;
  c.S4 = c.Cp / 4 + 4;
  c.n_mblk = (c.Mp16 * 16 + c.MB - 1) / c.MB;
  // rows for the window and its alignment offset (up to 3), in groups of 4:
  // int8 channels-last (xs) and the next tile's float32 (fbuf)
  c.RF = (c.R + 6) / 4 * 4;
  c.xs_words = c.RF * c.S4;
  // two float32 windows in flight where two blocks an SM still fit
  const long long fbytes = (long long)C_in * c.RF * 4;
  c.nbuf = (long long)c.xs_words * 4 + 2 * fbytes <= 110 * 1024 ? 2 : 1;
  const long long smem = (long long)c.xs_words * 4 + c.nbuf * fbytes;
  const void* fn = kernel_of(c.mw);
  // the block's limit: the opt-in shared memory less the kernel's static share
  cudaFuncAttributes fa;
  int per_sm = 0, dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long max_dyn = (long long)optin - (long long)fa.sharedSizeBytes;
  if (e == cudaSuccess && smem > max_dyn) e = cudaErrorInvalidValue;
  c.smem = (int)smem;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_dyn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, c.smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    *err = (int)e;
    return nullptr;
  }
  c.grid = per_sm * sms;
  Conv* plan = (Conv*)malloc(sizeof(Conv));
  *plan = c;
  *grid = c.grid;
  *err = 0;
  return plan;
}

// One conv: one cooperative launch on the stream. s_static == NULL means
// dynamic scales, with partial holding B * grid floats; s_out (nullable)
// gets the B scales; sums != 0 writes the int32 sums in place of y.
int kantts_i8_conv(const void* plan, const float* x, const void* wp, const float* s_w,
                   const float* bias, const float* s_static, float* partial, float* s_out,
                   void* out, int sums, int B, int T, int T_out, void* stream) {
  Conv c = *(const Conv*)plan;
  c.vec = T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  c.x = x;
  c.wp = (const int4*)wp;
  c.s_w = s_w;
  c.bias = bias;
  c.s_static = s_static;
  c.partial = partial;
  c.s_out = s_out;
  c.out = out;
  c.sums = sums;
  c.B = B;
  c.T = T;
  c.T_out = T_out;
  c.Q = (T_out + c.trim + c.P - 1) / c.P - c.q_begin;
  c.n_nblk = (c.Q + c.NB - 1) / c.NB;
  const int tiles = B * c.n_mblk * c.P * c.n_nblk;
  // a static scale needs no block beyond the tiles; phase 1 takes them all
  const int grid = s_static != nullptr && tiles < c.grid ? tiles : c.grid;
  void* args[] = {&c};
  return (int)cudaLaunchCooperativeKernel(kernel_of(c.mw), dim3(grid), dim3(THREADS), args,
                                          (size_t)c.smem, (cudaStream_t)stream);
}

}  // extern "C"
