// Nearest-codebook search for vector quantization on Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel `_vq_kernel` in vqgan_tpu/ops/vq.py (launched by
// `_vq_forward_pallas`): for every row z_n of z [N, D], the index of the
// codebook row e_k of E [K, D] with the smallest score, and the per-code
// usage histogram of those indices.
//  - exact mode (mode 0, fp32 z and E): score = (|z|^2 + |e|^2) - 2 z.e,
//    associated and rounded as the JAX package's plain version
//    (`_vq_forward_reference`). z.e is 3xTF32 on the tensor cores; the
//    kernel computes |z|^2 itself in fp32; |e|^2 comes in precomputed (one
//    small PyTorch reduction in the wrapper, as the JAX wrapper hoists it).
//  - bf16 mode (mode 1, bf16 z and E: the wrapper casts, as the JAX
//    wrapper does): the cross term sums the (exact) bf16 products in fp32,
//    and the score drops the per-row constant |z|^2: score = |e|^2 - 2 z.e.
//    The TPU kernel's packed min+argmin (mantissa low bits <- column index)
//    is not ported: both modes compare fp32 scores exactly.
//  - Equal scores go to the lowest index, as torch.argmin and the TPU kernel.
//    Every code's dot product takes the same sequence of products and adds
//    (no code-dependent split of D), so equal codes get equal scores.
//  - Usage (the TPU kernel's optional fused histogram, always on here): each
//    block adds the count of every distinct index among its rows to usage
//    [K] (zeroed by the caller) with one integer atomicAdd. Integer adds
//    commute, so the counts are exact.
//  - The gather z_q = E[idx] stays outside, as in the JAX package.
//
// What bounds it on this card: at the main path's shape (N = 8192 rows of a
// batch-8 32x32 latent grid, K = 128, D = 256) the work is 2 N K D = 537
// MFLOP against 8.5 MB of input (2.55 us at 3.35 TB/s): operations, 3.25 us
// at 165 TFLOP/s, the card's fastest fp32-accurate rate (3xTF32, three TF32
// products on the tensor cores at 495 TFLOP/s). The bf16 mode is bound by
// its bytes (its products take 0.54 us at 989 TFLOP/s). At K = 8192 the
// exact mode is 34 GFLOP, 0.208 ms.
// What the design does about it (primitives in flash_tc.cuh):
//  - A block owns 64 z rows, staged once into shared memory (64 KB of fp32
//    at D = 256), and walks the codebook in tiles (64 codes fp32, 128
//    bf16) through two buffers: tile t + 1's 16-byte cp.async copies are
//    issued by every thread while tile t's products run. At the main shape
//    128 blocks are one wave on the 132 SMs; every block reads the whole
//    codebook from L2 (16.8 MB at the main shape, twice the bytes of z).
//  - 8 warps = 2 row groups of 32 rows x 4 code splits: each warp's
//    product is `MmaRows<T>::a_smem_b_nk<2, NT, ...>` (acc += Z E^T, 32
//    rows x 8 NT codes: 16 fp32, 32 bf16) over 256-byte column chunks,
//    m16n8k8 3xTF32 (integer-rounded hi/lo split) or m16n8k16 bf16, fp32
//    accumulation. Columns past D are zeros in both operands, rows past N
//    and codes past K are zeros that never win.
//  - The epilogue runs on the accumulator fragments: each lane folds its
//    codes (2t and 2t + 1 of each n-tile, rows g and g + 8), ascending,
//    into a running (score, index) with a strict compare; the quad reduces
//    by shuffles and the code splits merge through shared memory in order,
//    both with the lowest-index rule. The [N, K] scores never reach memory.
//  - D above 256 columns (on no path) runs in panels of 256: z is not
//    resident then, and each (code tile, panel) restages both operands.
//  - Measured against other tilings and against code tiles by bulk copy
//    (the TMA engine, as the flash kernels stream K/V), which read the
//    bf16 tiles more slowly (copies of this source timed side by side by
//    vqgan_tpu_torch/bench_vq.py, PERF.md). In the exact mode the products
//    bound it: 3xTF32 on mma.sync.
// `nvcc -Xptxas -v` figures and times are in PERF.md (chip_smoke.py).
//
// C interface (ctypes): vq_nearest(...) returns cudaGetLastError() of the
// launch as an int (0 means launched), or kMisaligned, launching nothing,
// when a row of z or E does not start on 16 bytes.

#include <math_constants.h>

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int kPanel = 256;  // staged columns
constexpr unsigned kFull = 0xffffffffu;

// The tiling of a mode. MT: 16-row m-tiles per warp; RG: row groups
// (warps along rows); CS: code splits (warps along a tile's codes); NT:
// 8-code n-tiles per warp (2 fp32, 4 bf16). A block owns 16 MT RG = 64 z
// rows and walks tiles of 8 NT CS codes (64 fp32, 128 bf16) with RG CS = 8
// warps, through two code-tile buffers.
template <typename T>
struct Config {
  static constexpr int MT = 2, RG = 2, CS = 4;
  static constexpr int NT = sizeof(T) == 4 ? 2 : 4;
  static constexpr int kRows = 16 * MT * RG;
  static constexpr int kCodes = 8 * NT * CS;
  static constexpr int kThreads = 32 * RG * CS;
  static constexpr int kLd = kPanel + Pad<T>::kElems;
  static constexpr int kChunk = 256 / sizeof(T);  // columns per product call
  // z, the two code buffers, |z|^2 and the winners, the code splits'
  // (score, index)
  static constexpr size_t kSmem = sizeof(T) * (kRows + 2 * kCodes) * kLd +
                                  (sizeof(float) + sizeof(int)) * kRows *
                                      (CS + 1);
  static_assert(kThreads >= kRows, "one thread per row merges the splits");
};

struct Params {
  const void* z;
  const void* e;
  const float* e_sq;
  int* idx;
  int* usage;
  int N, K, D;
};

// (s, i) beats (best, best_i): smaller score, or the same score at a lower
// index (torch.argmin's first occurrence).
__device__ __forceinline__ bool better(float s, int i, float best, int best_i) {
  return s < best || (s == best && i < best_i);
}

// zsq[r] (+)= the sum of squares of staged row r, columns [0, cols), by 4
// threads per row in a fixed order, in fp32.
template <int ROWS, int THREADS>
__device__ __forceinline__ void row_norms(float* zsq, const float* z_s,
                                          int ld, int cols, bool first) {
  static_assert(ROWS % 16 == 0 && THREADS % 32 == 0, "whole warps per pass");
  for (int i = threadIdx.x; i < 4 * ROWS; i += THREADS) {
    const int r = i >> 2;
    float acc = 0.f;
    for (int c = i & 3; c < cols; c += 4) {
      const float x = z_s[r * ld + c];
      acc = fmaf(x, x, acc);
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    if ((i & 3) == 0) zsq[r] = first ? acc : zsq[r] + acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(Config<T>::kThreads)
    vq_nearest_kernel(const Params p) {
  using C = Config<T>;
  constexpr int MT = C::MT, RG = C::RG, CS = C::CS, NT = C::NT;
  constexpr int kLd = C::kLd;
  constexpr int kRows = C::kRows;
  constexpr int kCodes = C::kCodes;
  constexpr int kChunk = C::kChunk;
  constexpr bool kExact = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* z_s = reinterpret_cast<T*>(smem);  // [kRows][kLd]
  T* e_s = z_s + kRows * kLd;           // 2 x [kCodes][kLd]
  float* zsq_s = reinterpret_cast<float*>(e_s + 2 * kCodes * kLd);
  float* split_s = zsq_s + kRows;                               // [CS][kRows]
  int* split_i = reinterpret_cast<int*>(split_s + CS * kRows);  // [CS][kRows]
  int* win_s = split_i + CS * kRows;                            // [kRows]

  const T* z = static_cast<const T*>(p.z);
  const T* e = static_cast<const T*>(p.e);
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp % RG;  // rows 16 MT rg .. of the block
  const int cs = warp / RG;  // codes 8 NT cs .. of each tile
  const int g = lane >> 2;
  const int n_tiles = (p.K + kCodes - 1) / kCodes;
  const bool resident = p.D <= kPanel;
  // code tile t into its buffer, one cp.async group (empty past the end)
  auto stage_codes = [&](int t) {
    if (t < n_tiles)
      stage_rows<T, kPanel>(e_s + (t & 1) * kCodes * kLd, kLd, e, p.D,
                            t * kCodes, kCodes, p.K, p.D);
    cp_async_commit();
  };

  if (resident) {
    stage_rows<T, kPanel>(z_s, kLd, z, p.D, row0, kRows, p.N, p.D);
    cp_async_commit();
    stage_codes(0);
  }

  float best[MT][2];  // rows g and g + 8 of each m-tile
  int best_i[MT][2];
  float zsq[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      best[i][r] = CUDART_INF_F;
      best_i[i][r] = 0;
    }
  const T* z_w = z_s + rg * 16 * MT * kLd;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kCodes + cs * 8 * NT;
    float esq[NT][2];  // loaded ahead of the products that hide them
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int code = k0 + frag_col(n, j);
        esq[n][j] = code < p.K ? __ldg(p.e_sq + code) : 0.f;
      }
    float acc[MT][NT][4];
    zero(acc);
    if (resident) {
      cp_async_wait<0>();  // z and tile t, for this thread
      // ... for every thread; every warp is done with the buffer of tile
      // t - 1, which tile t + 1 takes
      __syncthreads();
      stage_codes(t + 1);
      const T* e_w = e_s + ((t & 1) * kCodes + cs * 8 * NT) * kLd;
      for (int c = 0; c < p.D; c += kChunk)
        MmaRows<T>::template a_smem_b_nk<MT, NT, kChunk>(acc, z_w + c, kLd,
                                                         e_w + c, kLd);
      if (kExact && t == 0) {
        row_norms<kRows, C::kThreads>(
            zsq_s, reinterpret_cast<const float*>(z_s), kLd, p.D, true);
        __syncthreads();
      }
    } else {  // panels: both operands restaged for every (tile, panel)
      for (int c0 = 0; c0 < p.D; c0 += kPanel) {
        const int cols = min(kPanel, p.D - c0);
        __syncthreads();  // the previous panel is consumed
        stage_rows<T, kPanel>(z_s, kLd, z + c0, p.D, row0, kRows, p.N, cols);
        stage_rows<T, kPanel>(e_s, kLd, e + c0, p.D, t * kCodes, kCodes, p.K,
                              cols);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (kExact && t == 0) {
          row_norms<kRows, C::kThreads>(
              zsq_s, reinterpret_cast<const float*>(z_s), kLd, cols, c0 == 0);
          __syncthreads();
        }
        for (int c = 0; c < cols; c += kChunk)
          MmaRows<T>::template a_smem_b_nk<MT, NT, kChunk>(
              acc, z_w + c, kLd, e_s + cs * 8 * NT * kLd + c, kLd);
      }
    }
    if (kExact && t == 0)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          zsq[i][r] = zsq_s[rg * 16 * MT + i * 16 + g + 8 * r];

    // fold this tile's scores into the running argmin, codes ascending
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int code = k0 + frag_col(n, j);
        if (code >= p.K) continue;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // no contraction into an fma: round as the plain version does
            const float two_dot = __fmul_rn(2.f, acc[i][n][2 * r + j]);
            const float s =
                kExact ? __fsub_rn(__fadd_rn(zsq[i][r], esq[n][j]), two_dot)
                       : __fsub_rn(esq[n][j], two_dot);
            if (s < best[i][r]) {  // codes rise within a lane: strict
              best[i][r] = s;      // keeps the first
              best_i[i][r] = code;
            }
          }
      }
  }

  // the quad that shares a row, then the code splits in order
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        const float s = __shfl_xor_sync(kFull, best[i][r], off);
        const int k = __shfl_xor_sync(kFull, best_i[i][r], off);
        if (better(s, k, best[i][r], best_i[i][r])) {
          best[i][r] = s;
          best_i[i][r] = k;
        }
      }
      if ((lane & 3) == 0) {
        const int row = cs * kRows + rg * 16 * MT + i * 16 + g + 8 * r;
        split_s[row] = best[i][r];
        split_i[row] = best_i[i][r];
      }
    }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kRows) {
    float s = split_s[r];
    int w = split_i[r];
    for (int c = 1; c < CS; ++c)
      if (better(split_s[c * kRows + r], split_i[c * kRows + r], s, w)) {
        s = split_s[c * kRows + r];
        w = split_i[c * kRows + r];
      }
    const int row = row0 + r;
    if (row < p.N) p.idx[row] = w;
    win_s[r] = row < p.N ? w : -1;
  }
  __syncthreads();
  // usage: the first row of each distinct index adds that index's count
  if (r < kRows && win_s[r] >= 0) {
    const int w = win_s[r];
    int count = 0;
    bool first = true;
    for (int q = 0; q < kRows; ++q) {
      if (win_s[q] != w) continue;
      first = first && q >= r;
      ++count;
    }
    if (first) atomicAdd(p.usage + w, count);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Config<T>;
  auto kernel = vq_nearest_kernel<T>;
  static std::atomic<unsigned> raised{0};
  const cudaError_t err = raise_smem_limit(kernel, C::kSmem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + C::kRows - 1) / C::kRows);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// z [N, D] and codebook [K, D]: contiguous, fp32 for mode 0 (exact) and bf16
// for mode 1, every row starting on 16 bytes (D * element size a multiple
// of 16); e_sq [K] fp32 (|e|^2 of the fp32 codebook). idx [N] int32 out;
// usage [K] int32 out, zeroed by the caller. The caller checks shapes.
extern "C" int vq_nearest(const void* z, const void* codebook,
                          const void* e_sq, void* idx, void* usage, int N,
                          int K, int D, int mode, void* stream) {
  const int64_t elem = mode == 0 ? 4 : 2;
  if (!rows_aligned(z, D, 0, 0, N, 1, 1, elem) ||
      !rows_aligned(codebook, D, 0, 0, K, 1, 1, elem))
    return kMisaligned;
  Params p;
  p.z = z;
  p.e = codebook;
  p.e_sq = static_cast<const float*>(e_sq);
  p.idx = static_cast<int*>(idx);
  p.usage = static_cast<int*>(usage);
  p.N = N;
  p.K = K;
  p.D = D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = mode == 0 ? launch<float>(p, st)
                                    : launch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}
