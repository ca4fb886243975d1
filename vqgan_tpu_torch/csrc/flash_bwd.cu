// Flash-attention backward, dK and dV, for Hopper (sm_90a), fp32 and bf16
// inputs. (dQ is its own kernel on the tensor cores, flash_bwd_dq.cu.)
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` in
// vqgan_tpu/ops/attention.py (launched by `_flash_backward`). With
// P = exp(scale * Q K^T - LSE) recomputed from the forward's saved log-sum-exp
// (never stored in device memory), dP = dO V^T and the row term
// delta = rowsum(dO * O) computed by the caller:
//   dV = sum_i P^T dO_i,  dK = scale * sum_i [P * (dP - delta)]^T Q_i
//                                                    (q rows past Sq: P = 0)
// Every sum is taken in fp32. Each output element is written by one thread of
// one block (one block per kv tile, as in the JAX grid): no atomics, so a run
// is bit-for-bit repeatable.
//
// What bounds it on this card, at the shapes it is used at:
//  - U-Net mid block in training, [8, 16, 8, 64] bf16: ~8 MFLOP over
//    ~100 KB of data, so the launch (a few microseconds) bounds it. One
//    block covers a whole (batch, head) pair.
//  - VQ-VAE mid block in VQ-GAN training, [8, 1024, 1, 512] bf16, and the
//    KL-VAE's [B, 1024, 1, 512] fp32: 8*B*S^2*d FLOP (34 GFLOP at B = 8),
//    i.e. operations. This SIMT version does not use the tensor cores; the
//    shared-memory loads that feed its FMAs come before the fp32 rate.
// What the design does about it: 8 warps; the block owns 16 kv rows (2 per
// warp; K and V staged in fp32, [16][D] each) and streams tiles of 32 q rows
// (scaled Q and dO, [32][D+1] each) through shared memory, one row per lane.
// A lane computes the scores and dP of its q row against its warp's 2 kv
// rows, each a private loop over d; tile rows are padded by one float so
// the lanes' reads hit distinct banks; lse and delta of the lane's q row
// come from device memory per tile. The accumulators are in registers,
// lane + 32 * j for the d columns, and P^T.dO and dS^T.Q take the per-lane
// P and dS by shuffles. All data is staged in fp32.
// Shared memory is 4 * (2 * 16 * D + 2 * 32 * (D + 1)) bytes, 192 KB at
// d = 512, raised above the 48 KB default with cudaFuncSetAttribute. The same
// tiles serve every d: at d = 512 the two accumulators of a lane are
// 2 x 2 x 16 floats. `nvcc -Xptxas -v` for sm_90a: no spills and no stack
// frame at any d; 40 registers per thread up to d = 64, 48 at 128, 64 at 256
// and 128 at 512. At d = 512 the 192 KB of shared memory holds one block per
// SM. Strides are passed in, so BSHD tensors are read and written in place;
// the last axis must be contiguous.
//
// C interface (ctypes): vq_flash_bwd_dkv(...) returns cudaGetLastError() of
// the launch as an int; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 2;                    // owned rows per warp
constexpr int kBlockRows = kWarps * kRows;  // 16 owned rows per block
constexpr int kTile = kWarp;                // 32 streamed rows, one per lane
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dk;
  void* dv;
  int B, H, Sq, Skv, D;
  // element strides of the batch, sequence and head axes (last axis is 1)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
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

// Stage `n` rows from row `s0` of a [S, D] slice with row stride `ss` into
// shared memory as fp32 with row stride `ld`, times `mul`; rows past S are 0
// (not garbage: a zero P or dS times garbage could still be NaN).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int64_t ss, int s0, int n, int S, int D,
                                      float mul) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int s = s0 + r;
    dst[r * ld + c] = s < S ? load_f32(src + s * ss + c) * mul : 0.f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* k_s = smem;                        // [16][D]
  float* v_s = k_s + kBlockRows * D;        // [16][D]
  float* q_s = v_s + kBlockRows * D;        // [32][D + 1], scaled
  float* do_s = q_s + kTile * ld;           // [32][D + 1]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kv0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x - warp * kWarp;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.Sq;

  stage(k_s, D, k, p.k_ss, kv0, kBlockRows, p.Skv, D, 1.f);
  stage(v_s, D, v, p.v_ss, kv0, kBlockRows, p.Skv, D, 1.f);

  float dk_acc[kRows][NJ], dv_acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  const float* k_row0 = k_s + (warp * kRows) * D;
  const float* v_row0 = v_s + (warp * kRows) * D;
  const int n_tiles = (p.Sq + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // the previous tile is consumed; K and V are staged
    stage(q_s, ld, q, p.q_ss, q0, kTile, p.Sq, D, p.scale);
    stage(do_s, ld, dout, p.do_ss, q0, kTile, p.Sq, D, 1.f);
    __syncthreads();

    // Scores and dP of q row `lane` against this warp's kv rows.
    const int row = q0 + lane;
    const bool valid = row < p.Sq;
    const float lse_r = valid ? lse[row] : 0.f;
    const float delta_r = valid ? delta[row] : 0.f;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    const float* q_row = q_s + lane * ld;
    const float* do_row = do_s + lane * ld;
    for (int c = 0; c < D; ++c) {
      const float qc = q_row[c];
      const float dc = do_row[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i] = fmaf(qc, k_row0[i * D + c], s[i]);
        dp[i] = fmaf(dc, v_row0[i * D + c], dp[i]);
      }
    }
    // P, zero on q rows past the end, and dS = P * (dP - delta)
    float pr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      pr[i] = valid ? expf(s[i] - lse_r) : 0.f;
      s[i] = pr[i] * (dp[i] - delta_r);
    }

    // dV += P^T dO and dK += dS^T (scale Q), P and dS of q row c from lane c.
    const int n_valid = min(kTile, p.Sq - q0);
    for (int c = 0; c < n_valid; ++c) {
      float pc[kRows], dsc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pc[i] = __shfl_sync(kFull, pr[i], c);
        dsc[i] = __shfl_sync(kFull, s[i], c);
      }
      const float* q_c = q_s + c * ld;
      const float* do_c = do_s + c * ld;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + kWarp * j;
        if (d < D) {
          const float qd = q_c[d];
          const float dd = do_c[d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv_acc[i][j] = fmaf(pc[i], dd, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsc[i], qd, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = kv0 + warp * kRows + i;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + kWarp * j;
      if (d < D) {
        store_as(dk + row * p.dk_ss + d, dk_acc[i][j]);
        store_as(dv + row * p.dv_ss + d, dv_acc[i][j]);
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kBlockRows) * D +
                          2 * static_cast<size_t>(kTile) * (D + 1));
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, NJ>;
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + kBlockRows - 1) / kBlockRows, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
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

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int B, int H, int Sq, int Skv, int D, const int64_t* s,
                   float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = p.dv = nullptr;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.dk_sb = p.dk_ss = p.dk_sh = 0;
  p.dv_sb = p.dv_ss = p.dv_sh = 0;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `in_strides` holds the (batch, sequence,
// head) element strides of q, k, v and dO, 12 values. The caller checks
// shapes (D a multiple of 8, at most 512), dtypes, that every last axis has
// stride 1, and that lse and delta are contiguous [B, H, Sq] fp32.
extern "C" int vq_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Skv, int D,
                                const int64_t* in_strides, int64_t dk_sb,
                                int64_t dk_ss, int64_t dk_sh, int64_t dv_sb,
                                int64_t dv_ss, int64_t dv_sh, float scale,
                                int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Skv, D,
                         in_strides, scale);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                               : dispatch<__nv_bfloat16>(p, st);
  return static_cast<int>(err);
}
