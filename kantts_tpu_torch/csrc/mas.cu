// K1: batched width-1 monotonic alignment search (MAS Viterbi) for Hopper.
//
// Replaces kantts_tpu/ops/mas_pallas.py::b_mas_pallas (kernel body
// _make_kernel). Semantics, identical to kantts_tpu/models/sambert/
// alignment.py::b_mas and to the plain version b_mas_torch in
// kantts_tpu_torch/models/sambert/alignment.py:
//   score(i, j)  = log(max(attn[i, j], 1e-30)) for j < in_len, else -1e30
//   dp(0, j)     = score(0, 0) if j == 0 else -1e30   (row 0 pinned to col 0)
//   dp(i, j)     = score(i, j) + max(dp(i-1, j-1), dp(i-1, j)),
//                  a tie (>=) takes j-1; column -1 reads -1e30
//   backtrack from (out_len-1, in_len-1); output is a one-hot 0/1 map,
//   zero outside the lengths. Lengths are clamped to the map's shape.
//
// What bounds it on the card: the T_mel serial steps of the recursion, not
// bytes or FLOPs. Each step is one add and one compare per column, and the
// whole map is read once (B*T_mel*T_text*4 bytes: 2.4 MB at the train shape
// B=32, 576x128). So the design takes the parallelism the recursion allows,
// and no more:
//   - one thread block per batch item; threads run over the text columns,
//     striding when T_text exceeds the block;
//   - the DP row is double-buffered in shared memory, one __syncthreads()
//     per mel row;
//   - backpointers are uint8 in a global scratch (B, T_mel, T_text) that the
//     wrapper allocates: the long bucket (4800x800) needs 3.84 MB per item,
//     far beyond the 227 KB of shared memory a block can have;
//   - the backtrack is one thread per item, writing ones into an output the
//     wrapper has zeroed.
// Each cell takes one logf and one add in a fixed order, and the build uses
// no fast-math, so the hard alignment equals the plain PyTorch version's
// bit for bit.
//
// What does not carry over from the TPU kernel: the grouping of batch items
// onto sublanes (here items are blocks, run in parallel across SMs),
// pltpu.roll for the j-1 shift (here a shared-memory read of the neighbour),
// PrefetchScalarGridSpec for the lengths (each block reads its own), VMEM
// scratch (shared memory plus a global backpointer scratch), and the
// jnp.maximum(i - 1, 0) workaround for a Mosaic dynamic-slice fault.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;

__global__ void mas_width1_kernel(const float* __restrict__ attn,
                                  const int* __restrict__ in_lens,
                                  const int* __restrict__ out_lens,
                                  float* __restrict__ out,
                                  uint8_t* __restrict__ take,
                                  int T_mel, int T_text) {
  extern __shared__ float rows[];  // 2 * T_text: previous and current DP row
  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(T_mel) * T_text;
  const float* a = attn + b * plane;
  uint8_t* tk = take + b * plane;
  const int in_len = min(max(in_lens[b], 0), T_text);
  const int out_len = min(max(out_lens[b], 0), T_mel);

  float* prev = rows;
  float* cur = rows + T_text;
  for (int j = threadIdx.x; j < T_text; j += blockDim.x) {
    const float s = logf(fmaxf(a[j], 1e-30f));
    prev[j] = (j == 0 && j < in_len) ? s : kNeg;
  }
  __syncthreads();

  for (int i = 1; i < T_mel; ++i) {
    const float* row = a + static_cast<size_t>(i) * T_text;
    uint8_t* tk_row = tk + static_cast<size_t>(i) * T_text;
    for (int j = threadIdx.x; j < T_text; j += blockDim.x) {
      const float stay = prev[j];
      const float shifted = j > 0 ? prev[j - 1] : kNeg;
      const bool from_left = shifted >= stay;
      const float s = j < in_len ? logf(fmaxf(row[j], 1e-30f)) : kNeg;
      cur[j] = s + (from_left ? shifted : stay);
      tk_row[j] = from_left ? 1 : 0;
    }
    __syncthreads();  // cur complete, and every read of prev done
    float* t = prev;
    prev = cur;
    cur = t;
  }

  // __syncthreads() above makes the block's backpointer writes visible here.
  if (threadIdx.x == 0) {
    float* o = out + b * plane;
    int col = in_len - 1;
    for (int i = out_len - 1; i >= 0 && col >= 0; --i) {
      o[static_cast<size_t>(i) * T_text + col] = 1.0f;
      if (i > 0) col -= tk[static_cast<size_t>(i) * T_text + col];
    }
  }
}

}  // namespace

// Largest T_text one launch takes: two DP rows must fit the 48 KB of
// shared memory a block gets without an opt-in attribute.
extern "C" int kantts_mas_max_text_len() { return 48 * 1024 / (2 * sizeof(float)); }

// attn, out: (B, T_mel, T_text) f32, contiguous; out zeroed by the caller.
// in_lens, out_lens: (B,) i32. take: (B, T_mel, T_text) u8 scratch.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kantts_mas_width1(const float* attn, const int* in_lens,
                                 const int* out_lens, float* out,
                                 uint8_t* take, int B, int T_mel, int T_text,
                                 void* stream) {
  if (B <= 0 || T_mel <= 0 || T_text <= 0) return 0;
  if (T_text > kantts_mas_max_text_len()) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((T_text + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = 2 * static_cast<size_t>(T_text) * sizeof(float);
  mas_width1_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      attn, in_lens, out_lens, out, take, T_mel, T_text);
  return static_cast<int>(cudaGetLastError());
}
