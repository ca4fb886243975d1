// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in vqgan_tpu/ops/attention.py
// (launched by `_flash_forward`): O = softmax(scale * Q K^T) V with an online
// softmax (fp32 running max, sum and accumulator), kv columns past the
// sequence end masked to -1e30, the row sum floored at 1e-30, and the per-row
// log-sum-exp LSE = m + log(l) written in fp32 for a backward pass.
//
// What bounds it on this card: the main path calls it at two shapes.
//  - U-Net mid block, [2B, 16, 8, 64] bf16: a few hundred KB of data and
//    ~4 MFLOP, so the launch itself (a few microseconds) bounds it. One block
//    covers a whole (batch, head) pair; there is no tiling to speak of.
//  - KL-VAE mid block, [B, 1024, 1, 512] fp32: 4*B*S^2*d = 34 GFLOP at B=16
//    against 134 MB of data, i.e. operations. The kernel does no TF32 (the
//    JAX tests' "highest" precision), so the ceiling is the card's fp32 rate
//    outside the tensor cores, and in this first version the shared-memory
//    loads feeding the FMAs come before that.
// What the design does about it: one block of 8 warps per (batch*head, tile
// of 16 query rows); each warp owns 2 query rows, and a lane owns one kv
// column of the 32-wide score tile and every 32nd output column. Q (scaled,
// fp32) and one K/V tile of 32 rows live in shared memory; K rows are padded
// by one float so the lanes' column reads hit distinct banks, V rows are read
// stride-1. Row max and row sum are warp shuffles, probabilities reach the
// P.V product through shuffles, and the accumulator stays in registers. At
// d = 512 fp32 that is 160 KB of dynamic shared memory, set above the 48 KB
// default with cudaFuncSetAttribute. Strides are passed in, so BSHD tensors
// are read and written in place without a transpose.
//
// C interface (ctypes): vq_flash_fwd(...) returns cudaGetLastError() of the
// launch as an int; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 2;                // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // 16 query rows per block
constexpr int kBlockKV = kWarp;          // 32 kv rows per tile, one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq]
  int B, H, Sq, Skv, D;
  // element strides of the batch, sequence and head axes (last axis is 1)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// NJ = ceil(D / 32): output columns per lane (lane + 32 * j).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int k_stride = D + 1;  // odd row stride: conflict-free column reads
  float* q_s = smem;                       // [kBlockQ][D], scaled
  float* k_s = q_s + kBlockQ * D;          // [kBlockKV][D + 1]
  float* v_s = k_s + kBlockKV * k_stride;  // [kBlockKV][D]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid - warp * kWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Stage the query tile in fp32, pre-scaled; rows past Sq are zero.
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int s = q0 + r;
    q_s[i] = s < p.Sq ? load_f32(q + s * p.q_ss + c) * p.scale : 0.f;
  }

  float acc[kRows][NJ];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const float* q_row0 = q_s + (warp * kRows) * D;
  const int n_tiles = (p.Skv + kBlockKV - 1) / kBlockKV;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlockKV;
    __syncthreads();  // the previous tile is consumed; Q is staged
    for (int i = tid; i < kBlockKV * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int s = kv0 + r;
      const bool in = s < p.Skv;
      // zero, not garbage, past the end: p = 0 there, and 0 * NaN is NaN
      k_s[r * k_stride + c] = in ? load_f32(k + s * p.k_ss + c) : 0.f;
      v_s[r * D + c] = in ? load_f32(v + s * p.v_ss + c) : 0.f;
    }
    __syncthreads();

    // Scores of this warp's rows against kv column `lane`.
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* k_row = k_s + lane * k_stride;
    for (int c = 0; c < D; ++c) {
      const float kc = k_row[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = fmaf(q_row0[i * D + c], kc, s[i]);
    }

    // Online softmax: each row lives in one warp, so max and sum are shuffles.
    const bool valid = kv0 + lane < p.Skv;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float si = valid ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      const float pi = expf(si - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pi);
      m[i] = m_new;
      s[i] = pi;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    // acc += P V, with P[row, c] broadcast from lane c.
    const int n_valid = min(kBlockKV, p.Skv - kv0);
    for (int c = 0; c < n_valid; ++c) {
      float pc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pc[i] = __shfl_sync(kFull, s[i], c);
      const float* v_row = v_s + c * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + kWarp * j;
        if (d < D) {
          const float vd = v_row[d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pc[i], vd, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= p.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + kWarp * j;
      if (d < D) store_as(o + row * p.o_ss + d, acc[i][j] / l_safe);
    }
    if (lane == 0) p.lse[static_cast<int64_t>(bh) * p.Sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * p.D +
                       static_cast<size_t>(kBlockKV) * (p.D + 1) +
                       static_cast<size_t>(kBlockKV) * p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 1>(p, stream);
  if (p.D <= 64) return launch<T, 2>(p, stream);
  if (p.D <= 128) return launch<T, 4>(p, stream);
  if (p.D <= 256) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller checks shapes (D a multiple of
// 8, at most 512), dtypes and that every last axis has stride 1.
extern "C" int vq_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Sq, int Skv,
                            int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                            int64_t k_sb, int64_t k_ss, int64_t k_sh,
                            int64_t v_sb, int64_t v_ss, int64_t v_sh,
                            int64_t o_sb, int64_t o_ss, int64_t o_sh,
                            float scale, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                               : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}
