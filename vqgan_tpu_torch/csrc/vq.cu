// Nearest-codebook search for vector quantization on Hopper (sm_90a).
//
// Replaces the TPU kernel `_vq_kernel` in vqgan_tpu/ops/vq.py (launched by
// `_vq_forward_pallas`): for every row z_n of z [N, D], the index of the
// codebook row e_k of E [K, D] with the smallest score, and the per-code
// usage histogram of those indices.
//  - exact mode (mode 0): score = (|z|^2 + |e|^2) - 2 z.e in fp32, associated
//    as the JAX package's plain version (`_vq_forward_reference`). The kernel
//    computes |z|^2 itself; |e|^2 comes in precomputed (one small PyTorch
//    reduction in the wrapper, as the JAX wrapper hoists it).
//  - bf16 mode (mode 1): z and E are rounded to bf16 as they are staged, the
//    cross term sums their (exact) products in fp32, and the score drops the
//    per-row constant |z|^2: score = |e|^2 - 2 z.e. The TPU kernel's packed
//    min+argmin (mantissa low bits <- column index) is not ported: both modes
//    compare fp32 scores exactly.
//  - Equal scores go to the lowest index, as torch.argmin and the TPU kernel.
//  - Usage (the TPU kernel's optional fused histogram, always on here): the
//    TPU kernel accumulated it across its sequential grid; blocks here run
//    in no order, so each row's winner is counted with an integer atomicAdd
//    into usage [K] (zeroed by the caller). Integer adds commute, so the
//    counts are exact.
//  - The gather z_q = E[idx] stays outside, as in the JAX package.
//
// What bounds it on this card: at the main path's shape (N = 8192 rows of a
// batch-8 32x32 latent grid, K = 128, D = 256) the work is 2 N K D = 537
// MFLOP of fp32 against 8.5 MB of input (2.55 us at 3.35 TB/s): operations,
// 3.25 us at 165 TFLOP/s, the card's fastest fp32-accurate rate (3xTF32,
// three TF32 products on the tensor cores at 495 TFLOP/s; this SIMT kernel
// has the fp32 units' 67 TFLOP/s, 8.0 us). At K = 8192 it is 34 GFLOP,
// 0.21 ms.
// What the design does about it: an SGEMM-shaped SIMT kernel whose epilogue
// is a running argmin, so the [N, K] score matrix never reaches device memory.
// A block of 16 x 16 threads owns 64 z rows and walks the codebook in tiles of
// 64 codes; D is streamed in chunks of 32 through shared memory (z and E
// chunks stored transposed, rows padded by one float, so stores and reads hit
// distinct banks). Each thread keeps a 4 x 4 tile of dot products in
// registers (rows ty*4+i, codes tx+16j): 8 shared loads per 16 FMAs. After
// each code tile a thread folds its 16 scores into a running (min, argmin)
// per row; at the end the 16 threads that share rows (one half-warp) reduce
// by shuffles. Ragged N and K are masked in the kernel: missing z rows are
// staged as zeros and never written, codes past K never enter the compare.
//
// C interface (ctypes): vq_nearest(...) returns cudaGetLastError() of the
// launch as an int; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTx = 16;                // threads along codes
constexpr int kTy = 16;                // threads along rows
constexpr int kThreads = kTx * kTy;    // 256
constexpr int kMicro = 4;              // rows and codes per thread
constexpr int kBlockN = kTy * kMicro;  // 64 z rows per block
constexpr int kBlockK = kTx * kMicro;  // 64 codes per tile
constexpr int kChunk = 32;             // D columns per stage
constexpr int kPad = 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float stage(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// (s, i) beats (best, best_i): smaller score, or the same score at a lower
// index (torch.argmin's first occurrence).
__device__ __forceinline__ bool better(float s, int i, float best, int best_i) {
  return s < best || (s == best && i < best_i);
}

__global__ void __launch_bounds__(kThreads)
    vq_nearest_kernel(const float* __restrict__ z,
                      const float* __restrict__ codebook,
                      const float* __restrict__ e_sq, int* __restrict__ idx,
                      int* __restrict__ usage, int N, int K, int D, int mode) {
  __shared__ float z_s[kChunk][kBlockN + kPad];  // transposed: [d][row]
  __shared__ float e_s[kChunk][kBlockK + kPad];  // transposed: [d][code]
  __shared__ float zsq_s[kBlockN];

  const bool bf16 = mode == 1;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int row0 = blockIdx.x * kBlockN;

  // |z|^2 of the block's rows (exact mode): one warp per row, in fp32.
  if (!bf16) {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int r = warp; r < kBlockN; r += kThreads / 32) {
      const int row = row0 + r;
      float acc = 0.f;
      if (row < N) {
        const float* zr = z + static_cast<int64_t>(row) * D;
        for (int d = lane; d < D; d += 32) acc = fmaf(zr[d], zr[d], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) zsq_s[r] = acc;
    }
  }

  float best[kMicro];
  int best_i[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += kBlockK) {
    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed
      // 32 consecutive threads read 32 consecutive floats of one row
      for (int t = tid; t < kBlockN * kChunk; t += kThreads) {
        const int r = t / kChunk;
        const int c = t % kChunk;
        const int d = d0 + c;
        const int row = row0 + r;
        const int code = k0 + r;  // kBlockN == kBlockK
        z_s[c][r] = (row < N && d < D)
                        ? stage(z[static_cast<int64_t>(row) * D + d], bf16)
                        : 0.f;
        e_s[c][r] = (code < K && d < D)
                        ? stage(codebook[static_cast<int64_t>(code) * D + d], bf16)
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        float a[kMicro];
        float b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = z_s[c][ty * kMicro + i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = e_s[c][tx + kTx * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // fold this tile's scores into the running argmin, codes ascending
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int code = k0 + tx + kTx * j;
      if (code >= K) continue;
      const float esq = e_sq[code];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        // no contraction into an fma: round as the plain version does
        const float two_dot = __fmul_rn(2.f, acc[i][j]);
        const float s = bf16 ? __fsub_rn(esq, two_dot)
                             : __fsub_rn(__fadd_rn(zsq_s[ty * kMicro + i], esq),
                                         two_dot);
        if (s < best[i]) {  // codes rise within a thread: strict keeps the first
          best[i] = s;
          best_i[i] = code;
        }
      }
    }
  }

  // reduce across the 16 threads (one half-warp) that share these rows
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int off = kTx / 2; off > 0; off /= 2) {
      const float s = __shfl_xor_sync(kFull, best[i], off);
      const int k = __shfl_xor_sync(kFull, best_i[i], off);
      if (better(s, k, best[i], best_i[i])) {
        best[i] = s;
        best_i[i] = k;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int row = row0 + ty * kMicro + i;
      if (row < N) {
        idx[row] = best_i[i];
        atomicAdd(usage + best_i[i], 1);
      }
    }
  }
}

}  // namespace

// z [N, D], codebook [K, D] and e_sq [K]: contiguous fp32 on the device.
// idx [N] int32 out; usage [K] int32 out, zeroed by the caller.
// mode: 0 = exact fp32 scores, 1 = bf16 cross term. The caller checks shapes.
extern "C" int vq_nearest(const void* z, const void* codebook,
                          const void* e_sq, void* idx, void* usage, int N,
                          int K, int D, int mode, void* stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN);
  vq_nearest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(codebook),
      static_cast<const float*>(e_sq), static_cast<int*>(idx),
      static_cast<int*>(usage), N, K, D, mode);
  return static_cast<int>(cudaGetLastError());
}
