// K1: batched width-1 monotonic alignment search (MAS Viterbi) for Hopper.
//
// Replaces kantts_tpu/ops/mas_pallas.py::b_mas_pallas (kernel body
// _make_kernel). Semantics, identical to kantts_tpu/models/sambert/
// alignment.py::b_mas and to the plain version b_mas_torch in
// kantts_tpu_torch/models/sambert/alignment.py:
//   score(i, j)  = log(clamp(attn[i, j], min=1e-30)) for j < in_len, else
//                  -1e30; a NaN cell keeps its NaN, as torch.clamp and
//                  jnp.clip do
//   dp(0, j)     = score(0, 0) if j == 0 else -1e30   (row 0 pinned to col 0)
//   dp(i, j)     = score(i, j) + (shifted >= stay ? shifted : stay), with
//                  shifted = dp(i-1, j-1) (-1e30 for j = 0), stay = dp(i-1, j):
//                  a tie takes j-1, and a comparison with NaN takes "stay"
//   backtrack from (out_len-1, in_len-1); output is a one-hot 0/1 map,
//   zero outside the lengths. Lengths are clamped to the map's shape.
// Each cell takes one logf and one add, and the build uses no fast-math, so
// the hard alignment equals the plain version's bit for bit, NaN included.
//
// What bounds it on the card: the T_mel dependent steps of the recursion
// (the map is read once and the output written once, 2*B*T_mel*T_text*4
// bytes: a few microseconds at 3.35 TB/s). A step is one add and one
// compare per column plus the j-1 neighbour, so the design keeps everything
// else off that chain:
//   - warp variant (T_text <= 1024), two launches. A score pass over the
//     whole card writes log(clamp(attn)) (or -1e30 past in_len) into the
//     output, so the logf of every cell runs on all SMs at once. Then one
//     block per item: warp 0 owns the DP row in registers, R contiguous
//     columns per lane (ceil(T_text/32) rounded up to a power of two, at
//     least 4), two rows a turn; the j-1 neighbour across lanes comes by
//     __shfl_up_sync, so the recursion has no block barrier. The other
//     seven warps copy tiles of score rows ahead of it into a
//     double-buffered ring in shared memory, swizzled so that both their
//     float4 stores and the DP lanes' float4 loads are free of bank
//     conflicts, and write the output's zeros over the scores they have
//     copied. One __syncthreads per tile of rows, not per row. One item per
//     block rather than several: the train batch (B=32) then spreads over
//     32 SMs, and each DP warp has its SM's schedulers to itself and its
//     producers.
//   - block variant (T_text > 1024, up to 6144): one block per item,
//     threads over columns, the DP row double-buffered in shared memory
//     with one __syncthreads per row; each thread loads its next row's
//     cells one row ahead. Slower than the warp variant at every width the
//     warp variant takes (timed by chip_smoke.py), so it is the fallback
//     for wider maps only.
//   - backpointers are bits, one per cell: W = ceil(T_text/32) words per
//     mel row, 32 columns to a word. The block variant packs them with
//     __ballot_sync. A DP lane of the warp variant gathers its R bits of
//     32/R rows in one register and stores it once (one conflict-free
//     store per lane every 32/R rows); after the recursion all warps
//     rearrange those words by row. The bits stay in shared memory when an
//     item's words fit (18 KB at 576x128) and go to a global scratch that
//     the wrapper allocates otherwise (480 KB per item at 4800x800).
//   - the backtrack moves at most one column per row, so for 32 rows the
//     two words around the column at their start hold every bit it reads:
//     each lane of warp 0 stages its row's two words in shared memory, lane
//     0 walks the 32 rows on its offset in that window (a shift, an and and
//     a subtraction per row), and each lane writes its row's one. The
//     zeros were written during the recursion, so the wrapper needs no
//     memset.
//
// What does not carry over from the TPU kernel: the grouping of batch items
// onto sublanes, pltpu.roll for the j-1 shift, PrefetchScalarGridSpec for
// the lengths (each block reads its own), VMEM scratch, and the
// jnp.maximum(i - 1, 0) workaround for a Mosaic dynamic-slice fault. The
// Pallas kernel's jnp.maximum also spreads a NaN that b_mas drops; this
// kernel follows b_mas.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the plain version's constants, rounded from double as torch rounds them
constexpr float kNeg = static_cast<float>(-1e30);
constexpr float kMin = static_cast<float>(1e-30);
constexpr int kWarpThreads = 256;      // warp variant: 1 DP warp + 7 producers
constexpr int kMaxWarpText = 1024;     // widest map of the warp variant
constexpr int kRingBytes = 64 * 1024;  // both score tiles together
constexpr int kBigRingBytes = 192 * 1024;
constexpr int kLoads = 8;              // float4s a producer thread loads at once
constexpr int kScoreBlocks = 132 * 8;  // the score pass: 8 blocks an SM
constexpr int kBlockThreads = 1024;    // block variant
constexpr int kMaxCols = 6;            // block variant: columns per thread
constexpr int kMaxText = kBlockThreads * kMaxCols;
constexpr int kSmemLimit = 220 * 1024;

__device__ __forceinline__ float score(float a) {
  return logf(a < kMin ? kMin : a);  // a NaN fails the compare and stays NaN
}

// Words of the warp variant's raw bit layout for one item (R < 32).
__host__ __device__ inline size_t raw_words(int T_mel, int R) {
  return R < 32 ? static_cast<size_t>((T_mel + 32 / R - 1) / (32 / R)) * 32 : 0;
}

// Warp 0 walks the backpointer bits from (out_len-1, in_len-1) and writes
// the ones of the alignment; the caller has written the zeros. The column
// falls by at most one a row, so for 32 rows the two words around the
// column at their start hold every bit the walk reads: each lane loads its
// row's two words, lane 0 walks the 32 rows in shared memory, and each
// lane writes its row's one.
__device__ void backtrack(const uint32_t* bits, int W, float* out, int T_mel,
                          int T_text, int in_len, int out_len) {
  __shared__ uint64_t win[32];
  __shared__ int cols[32];
  const int lane = threadIdx.x & 31;
  int c = in_len - 1;
  for (int i0 = T_mel - 1; i0 >= 0; i0 -= 32) {
    const int w1 = c > 0 ? c >> 5 : 0;
    const int w0 = w1 > 0 ? w1 - 1 : 0;
    const int lo = 32 * w0;
    const int mine = i0 - lane;
    win[lane] = mine > 0
        ? (static_cast<uint64_t>(bits[static_cast<size_t>(mine) * W + w1]) << 32)
              | bits[static_cast<size_t>(mine) * W + w0]
        : 0;
    __syncwarp();
    if (lane == 0 && c >= 0) {
      // the walk's state is the column's offset in the window, so that each
      // row is a shift, an and and a subtraction
      int d = c - lo;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int i = i0 - t;
        const bool on = i >= 0 && i < out_len;
        cols[t] = on ? d + lo : -1;
        if (on) d -= static_cast<int>((win[t] >> d) & 1u);
      }
      c = d + lo;
    } else if (lane == 0) {
#pragma unroll
      for (int t = 0; t < 32; ++t) cols[t] = -1;
    }
    __syncwarp();
    c = __shfl_sync(0xffffffffu, c, 0);
    if (mine >= 0 && cols[lane] >= 0) out[static_cast<size_t>(mine) * T_text + cols[lane]] = 1.0f;
    __syncwarp();  // win and cols are read before the next rows overwrite them
  }
}

// Warp variant, first pass, over the whole card: the score of every cell
// into `out` (score(attn) for j < in_len, else -1e30), one warp a row.
__global__ void __launch_bounds__(256)
mas_score_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                 float* __restrict__ out, int B, int T_mel, int T_text) {
  const int lane = threadIdx.x & 31;
  const size_t n_rows = static_cast<size_t>(B) * T_mel;
  for (size_t row = static_cast<size_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
       row < n_rows; row += static_cast<size_t>(gridDim.x) * 8) {
    const int in_len = min(max(in_lens[row / T_mel], 0), T_text);
    const float* a = attn + row * T_text;
    float* o = out + row * T_text;
    for (int j = lane; j < T_text; j += 32) o[j] = j < in_len ? score(a[j]) : kNeg;
  }
}

// Warp variant, second pass: one block per item; `out` holds the scores.
template <int R>
__global__ void __launch_bounds__(kWarpThreads)
mas_warp_kernel(const int* __restrict__ in_lens, const int* __restrict__ out_lens,
                float* __restrict__ out, uint32_t* __restrict__ bits_global,
                int T_mel, int T_text, int TR, int bits_in_smem) {
  constexpr int TP = 32 * R;   // padded columns: lane l owns [l*R, l*R + R)
  constexpr int RPW = 32 / R;  // rows of a lane's bits in one word
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int W = (T_text + 31) >> 5;
  const size_t words = static_cast<size_t>(T_mel) * W + raw_words(T_mel, R);
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(ring + 2 * TR * TP);
  uint32_t* bits_g = bits_global + b * words;
  uint32_t* bits = bits_in_smem ? bits_s : bits_g;
  float* o = out + b * static_cast<size_t>(T_mel) * T_text;
  const int in_len = min(max(in_lens[b], 0), T_text);
  const int out_len = min(max(out_lens[b], 0), T_mel);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (T_mel + TR - 1) / TR;

  // A ring slot holds TR rows of TP scores. Lane l's columns [l*R, l*R+R)
  // of a row are R/4 float4s, float4 k4 at k4*128 + ((l + k4) % 32)*4: the
  // DP lanes read one k4 of a row as 32 distinct float4s, and producers
  // writing a row's float4s in column order hit distinct banks too.
  auto slot = [](int l, int k4) { return k4 * 128 + ((l + k4) & 31) * 4; };

  // producers: the scores of tile `tile` into its ring slot, then zeros
  // over them in `out`, 4 columns at a time in column order; kLoads float4s
  // a thread are loaded before any is stored, so that many are in flight
  auto fill = [&](int tile) {
    constexpr int stride = kWarpThreads - 32;
    constexpr int QP = TP / 4;
    float* buf = ring + (tile & 1) * TR * TP;
    const int r0 = tile * TR;
    const int n = min(TR, T_mel - r0) * QP;
    const bool vec = (T_text & 3) == 0;  // rows of `out` are 16-byte aligned
    const float4 neg = make_float4(kNeg, kNeg, kNeg, kNeg);
    for (int g0 = threadIdx.x - 32; g0 < n; g0 += kLoads * stride) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int g = g0 + u * stride, r = g / QP, j = 4 * (g - r * QP);
        const float* row = o + static_cast<size_t>(r0 + r) * T_text + j;
        v[u] = neg;
        if (g < n && j < T_text) {
          if (vec) {
            v[u] = *reinterpret_cast<const float4*>(row);
          } else {
            v[u].x = row[0];
            if (j + 1 < T_text) v[u].y = row[1];
            if (j + 2 < T_text) v[u].z = row[2];
            if (j + 3 < T_text) v[u].w = row[3];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int g = g0 + u * stride, r = g / QP, j = 4 * (g - r * QP);
        float* row = o + static_cast<size_t>(r0 + r) * T_text + j;
        if (g < n) {
          *reinterpret_cast<float4*>(buf + r * TP + slot(j / R, (j % R) >> 2)) = v[u];
          if (j < T_text) {
            if (vec) {
              *reinterpret_cast<float4*>(row) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else {
              for (int c = 0; c < 4 && j + c < T_text; ++c) row[c] = 0.0f;
            }
          }
        }
      }
    }
  };

  // The DP lane's take bits: with R = 32 a row's bits are the lane's word
  // of the row; with R < 32 the lane gathers RPW rows in one register and
  // stores it once (raw layout, word (i / RPW) * 32 + lane), and all warps
  // rearrange the words by row after the recursion. Shared and global
  // stores take separate pointers: one that may be either compiles to
  // slower generic stores.
  auto store_word = [&](size_t at, uint32_t v) {
    if (bits_in_smem) {
      bits_s[at] = v;
    } else {
      bits_g[at] = v;
    }
  };
  const size_t raw_at = static_cast<size_t>(T_mel) * W;  // raw words follow the rows
  uint32_t acc = 0;
  auto take_bits = [&](int i, uint32_t m) {
    if constexpr (R == 32) {
      if (lane < W) store_word(static_cast<size_t>(i) * W + lane, m);
    } else {
      acc |= m << ((i & (RPW - 1)) * R);
      if ((i & (RPW - 1)) == RPW - 1 || i == T_mel - 1) {
        store_word(raw_at + static_cast<size_t>(i / RPW) * 32 + lane, acc);
        acc = 0;
      }
    }
  };

  if (warp != 0) fill(0);
  __syncthreads();
  float p[R];
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (warp != 0) {
      if (tile + 1 < n_tiles) fill(tile + 1);
    } else {
      const float* buf = ring + (tile & 1) * TR * TP;
      const int r0 = tile * TR, rows = min(TR, T_mel - r0);
      auto load_row = [&](int r, float (&s)[R]) {  // R/4 16-byte loads
#pragma unroll
        for (int k4 = 0; k4 < R / 4; ++k4) {
          const float4 v = *reinterpret_cast<const float4*>(buf + r * TP + slot(lane, k4));
          s[4 * k4] = v.x;
          s[4 * k4 + 1] = v.y;
          s[4 * k4 + 2] = v.z;
          s[4 * k4 + 3] = v.w;
        }
      };
      // one row of the recursion on the scores in `cur`, the next row's
      // scores loaded into `nxt` ahead of it
      auto step = [&](int r, const float (&cur)[R], float (&nxt)[R]) {
        if (r + 1 < rows) load_row(r + 1, nxt);
        float left = __shfl_up_sync(0xffffffffu, p[R - 1], 1);
        if (lane == 0) left = kNeg;
        uint32_t m = 0;
#pragma unroll
        for (int k = R - 1; k >= 0; --k) {  // high to low: p[k-1] is still old
          const float shifted = k > 0 ? p[k - 1] : left;
          const bool take = shifted >= p[k];
          p[k] = cur[k] + (take ? shifted : p[k]);
          m |= static_cast<uint32_t>(take) << k;
        }
        take_bits(r0 + r, m);
      };
      float s0[R], s1[R];
      load_row(0, s0);
      int r = 0;
      if (tile == 0) {  // row 0 is pinned to column 0; it has no take bits
#pragma unroll
        for (int k = 0; k < R; ++k) p[k] = (lane == 0 && k == 0) ? s0[0] : kNeg;
        take_bits(0, 0);
        if (rows > 1) load_row(1, s0);
        r = 1;
      }
      for (; r + 1 < rows; r += 2) {  // two rows a turn: the buffers swap roles
        step(r, s0, s1);
        step(r + 1, s1, s0);
      }
      if (r < rows) step(r, s0, s1);
    }
    __syncthreads();  // the next tile is ready and this one is consumed
  }
  if constexpr (R < 32) {  // raw words -> the row layout the backtrack reads
    constexpr uint32_t mask = (1u << R) - 1;
    for (int at = threadIdx.x; at < T_mel * W; at += kWarpThreads) {
      const int i = at / W, w = at - i * W;
      const uint32_t* raw = bits + raw_at + static_cast<size_t>(i / RPW) * 32 + w * RPW;
      const int shift = (i & (RPW - 1)) * R;
      uint32_t word = 0;
#pragma unroll
      for (int g = 0; g < RPW; ++g) word |= ((raw[g] >> shift) & mask) << (g * R);
      bits[at] = word;
    }
    __syncthreads();
  }
  if (warp == 0) backtrack(bits, W, o, T_mel, T_text, in_len, out_len);
}

__global__ void __launch_bounds__(kBlockThreads)
mas_block_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                 const int* __restrict__ out_lens, float* __restrict__ out,
                 uint32_t* __restrict__ bits_global, int T_mel, int T_text,
                 int bits_in_smem) {
  extern __shared__ float4 smem4[];
  float* prev = reinterpret_cast<float*>(smem4);
  float* cur = prev + T_text;
  const int b = blockIdx.x;
  const int W = (T_text + 31) >> 5;
  uint32_t* bits = bits_in_smem
      ? reinterpret_cast<uint32_t*>(prev + 2 * T_text)
      : bits_global + static_cast<size_t>(b) * T_mel * W;
  const size_t plane = static_cast<size_t>(T_mel) * T_text;
  const float* a = attn + b * plane;
  float* o = out + b * plane;
  const int in_len = min(max(in_lens[b], 0), T_text);
  const int out_len = min(max(out_lens[b], 0), T_mel);
  const int tid = threadIdx.x, lane = tid & 31, NT = blockDim.x;

#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = tid + c * NT;
    if (j < T_text) {
      prev[j] = (j == 0 && in_len > 0) ? score(a[0]) : kNeg;
      o[j] = 0.0f;
    }
  }
  float next[kMaxCols];  // this thread's cells of the next row
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = tid + c * NT;
    next[c] = (T_mel > 1 && j < in_len) ? a[T_text + j] : 0.0f;
  }
  __syncthreads();
  for (int i = 1; i < T_mel; ++i) {
    float row[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = tid + c * NT;
      row[c] = next[c];
      next[c] = (i + 1 < T_mel && j < in_len)
          ? a[static_cast<size_t>(i + 1) * T_text + j] : 0.0f;
    }
    const size_t at = static_cast<size_t>(i) * T_text;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = tid + c * NT;
      bool take = false;
      if (j < T_text) {
        const float stay = prev[j];
        const float shifted = j > 0 ? prev[j - 1] : kNeg;
        take = shifted >= stay;
        const float s = j < in_len ? score(row[c]) : kNeg;
        cur[j] = s + (take ? shifted : stay);
        o[at + j] = 0.0f;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, take);
      const int w = (j - lane) >> 5;  // this warp's 32 columns
      if (lane == 0 && w < W) bits[static_cast<size_t>(i) * W + w] = m;
    }
    __syncthreads();  // cur complete, every read of prev done
    float* t = prev;
    prev = cur;
    cur = t;
  }
  if (tid < 32) backtrack(bits, W, o, T_mel, T_text, in_len, out_len);
}

struct Plan {
  int variant;  // 1 warp, 2 block
  int R, TR, threads, bits_in_smem;
  size_t smem, bits_words;  // bits_words: per item
};

Plan plan(int T_mel, int T_text, int variant) {
  Plan p{};
  p.variant = variant != 0 ? variant : (T_text <= kMaxWarpText ? 1 : 2);
  p.bits_words = static_cast<size_t>(T_mel) * ((T_text + 31) / 32);
  if (p.variant == 1) {
    p.R = 4;
    while (32 * p.R < T_text) p.R *= 2;
    p.bits_words += raw_words(T_mel, p.R);
    // a ring of kRingBytes beside the bits, or a larger one when the bits
    // go to global memory anyway: fewer tiles, fewer barriers
    p.bits_in_smem = kRingBytes + p.bits_words * 4 <= kSmemLimit;
    const int TP = 32 * p.R;
    p.TR = (p.bits_in_smem ? kRingBytes : kBigRingBytes) / (2 * 4 * TP);
    if (p.TR > T_mel) p.TR = T_mel;
    p.threads = kWarpThreads;
    p.smem = static_cast<size_t>(2) * p.TR * TP * 4;
  } else {
    p.threads = (T_text + 31) / 32 * 32;
    if (p.threads > kBlockThreads) p.threads = kBlockThreads;
    p.smem = static_cast<size_t>(2) * T_text * 4;
    p.bits_in_smem = p.smem + p.bits_words * 4 <= kSmemLimit;
  }
  if (p.bits_in_smem) p.smem += p.bits_words * 4;
  return p;
}

// Lets kernel `Tag` take up to kSmemLimit bytes of dynamic shared memory;
// set once per process (the port drives one card).
template <int Tag, typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return err;
}

}  // namespace

// Largest T_text one launch takes.
extern "C" int kantts_mas_max_text_len() { return kMaxText; }

// The variant a launch takes (1 warp, 2 block) for `variant` 0 (auto).
extern "C" int kantts_mas_variant(int T_mel, int T_text, int variant) {
  return plan(T_mel, T_text, variant).variant;
}

// 32-bit words of global scratch a launch needs (0: the bits fit in
// shared memory).
extern "C" long long kantts_mas_scratch_words(int B, int T_mel, int T_text,
                                              int variant) {
  if (B <= 0 || T_mel <= 0 || T_text <= 0) return 0;
  const Plan p = plan(T_mel, T_text, variant);
  return p.bits_in_smem ? 0 : static_cast<long long>(B) * p.bits_words;
}

// attn, out: (B, T_mel, T_text) f32, contiguous; the kernel writes all of
// out. in_lens, out_lens: (B,) i32. scratch: kantts_mas_scratch_words
// words, or null when that is 0. variant: 0 auto, 1 warp, 2 block.
// Launches on `stream` and returns a cudaError_t (0 on success).
extern "C" int kantts_mas_width1(const float* attn, const int* in_lens,
                                 const int* out_lens, float* out,
                                 uint32_t* scratch, int B, int T_mel, int T_text,
                                 int variant, void* stream) {
  if (B <= 0 || T_mel <= 0 || T_text <= 0) return 0;
  if (T_text > kMaxText || variant < 0 || variant > 2
      || (variant == 1 && T_text > kMaxWarpText)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(T_mel, T_text, variant);
  if (!p.bits_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define KANTTS_MAS_WARP(RR)                                                   \
  case RR:                                                                    \
    err = allow_smem<RR>(mas_warp_kernel<RR>);                                \
    if (err == cudaSuccess)                                                   \
      mas_warp_kernel<RR><<<B, p.threads, p.smem, s>>>(                       \
          in_lens, out_lens, out, scratch, T_mel, T_text, p.TR,               \
          p.bits_in_smem);                                                    \
    break;
  if (p.variant == 1) {
    const long long rows = static_cast<long long>(B) * T_mel;
    const int grid = static_cast<int>(rows / 8 + 1 < kScoreBlocks ? rows / 8 + 1 : kScoreBlocks);
    mas_score_kernel<<<grid, 256, 0, s>>>(attn, in_lens, out, B, T_mel, T_text);
    switch (p.R) {
      KANTTS_MAS_WARP(4)
      KANTTS_MAS_WARP(8)
      KANTTS_MAS_WARP(16)
      KANTTS_MAS_WARP(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    err = allow_smem<0>(mas_block_kernel);
    if (err == cudaSuccess)
      mas_block_kernel<<<B, p.threads, p.smem, s>>>(
          attn, in_lens, out_lens, out, scratch, T_mel, T_text, p.bits_in_smem);
  }
#undef KANTTS_MAS_WARP
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
