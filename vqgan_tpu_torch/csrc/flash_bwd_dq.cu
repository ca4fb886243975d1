// Flash-attention backward, dQ, for Hopper (sm_90a) on the tensor cores,
// fp32 and bf16 inputs.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` in vqgan_tpu/ops/attention.py
// (launched by `_flash_backward`). With P = exp(scale * Q K^T - LSE)
// recomputed from the forward's saved log-sum-exp (never stored in device
// memory), dP = dO V^T and the row term delta = rowsum(dO * O) computed by
// the caller:
//   dQ = scale * sum_j [P * (dP - delta)] K_j        (kv columns past Skv: P = 0)
// P and dS are fp32. One block owns its query rows and writes each dQ
// element once: no atomics, so a run is bit-for-bit repeatable.
//
// What bounds it on this card, at the main path's shapes (6 * B * S^2 * d
// operations; bytes = Q, dO, dQ, K, V once, LSE and delta):
//  - VQ-VAE mid block in VQ-GAN training, [8, 1024, 1, 512] bf16: 25.8 GFLOP
//    against 42 MB, operations: 0.0261 ms at 989 TFLOP/s.
//  - U-Net mid block in LDM training, [8, 16, 8, 64] bf16: ~6 MFLOP over
//    ~100 KB, so the launch (a few microseconds) bounds it.
//  - (Off the main path: stage-1 KL-VAE training's [16, 1024, 1, 512] fp32,
//    3xTF32 as in the forward: 51.5 GFLOP, three TF32 products each at
//    495 TFLOP/s, 0.312 ms.)
// What the design does about it (primitives in flash_tc.cuh; the forward's
// structure, flash_fwd.cu):
//  - A block owns RG row groups of 16 MT query rows with Q and dO staged
//    once by cp.async, and streams K and V tiles of KV rows by bulk copies
//    on mbarriers, double-buffered.
//  - Per tile, S = Q K^T and dP = dO V^T are mma.sync on the tensor cores;
//    P = exp2(scale * log2(e) * S - log2(e) * LSE) (zero past Skv) and
//    dS = P * (dP - delta) in fp32 registers; then dQ += dS K on the tensor
//    cores, the S fragments serving as dS's A fragments. dS goes in as
//    hi + lo, two bf16 products (one more product per tile; measured at
//    [8,1024,1,512], dS rounded to bf16 once put dQ 6.1e-3 of max|dQ| from
//    the plain version, over the 2e-3 the design allowed, PERF.md), or
//    split for 3xTF32 for fp32. dQ is written once, times the scale, in the
//    input dtype.
//  - Wide heads split columns as the forward does: CS warps share a row
//    group, each computes partial S and dP over its DC = d / CS columns,
//    the partials are summed through shared memory (identical bits in every
//    warp of the group), and each accumulates its own DC columns of dQ.
// Configurations at the main path's shapes, with `nvcc -Xptxas -v` for
// sm_90a (no instance spills or keeps a stack frame):
//  - d = 512 bf16: 8 warps = 4 row groups x 2 column halves, 16 x 256 fp32
//    of dQ per warp, two 16-row K/V buffers; 225 registers, 216,080 bytes
//    of shared memory (Q and dO 64 x 512, K/V 2 x 2 x 16 x 512, exchange).
//  - d = 64 bf16 (U-Net): one warp per 16-row tile, 64-row K/V tiles; 167
//    registers, 41,488 bytes.
// Strides are passed in, so BSHD tensors are read and written in place.
//
// C interface (ctypes): vq_flash_bwd_dq(...) returns cudaGetLastError() of
// the launch as an int (0 means launched), or kMisaligned, launching
// nothing, when a row of q, k, v or dO does not start on 16 bytes.

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;
  int B, H, Sq, Skv, D;
  // element strides of the batch, sequence and head axes (last axis is 1)
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  float scale;
};

// As the forward's Config: DC head columns per warp, CS warps per row
// group, KV rows per K/V tile, RG row groups per block at most, NBUF K/V
// buffers, MT 16-row m-tiles per warp.
template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
struct Config {
  static constexpr int kCols = DC * CS;
  static constexpr int kLd = kCols + Pad<T>::kElems;
  static constexpr int kGroupRows = 16 * MT;

  // Q, dO, the K/V buffers, the column-split exchange (S and dP), one
  // mbarrier per buffer
  static size_t smem_bytes(int rg) {
    const size_t rows = kGroupRows * static_cast<size_t>(rg);
    size_t bytes = sizeof(T) * (2 * rows + 2 * NBUF * KV) * kLd;
    if (CS > 1) bytes += sizeof(float) * rg * CS * 2 * MT * (KV / 2) * 32;
    return bytes + sizeof(uint64_t) * NBUF;
  }
};

template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
__global__ void __launch_bounds__(32 * RG * CS, 1)
    flash_bwd_dq_kernel(const Params p) {
  using C = Config<T, DC, CS, KV, RG, NBUF, MT>;
  constexpr int kLd = C::kLd;
  constexpr int NS = KV / 8;  // n-tiles of the score tile
  constexpr int NO = DC / 8;  // n-tiles of a warp's dQ columns
  constexpr int kSlot = MT * NS * 4 * 32;  // one warp's partial S (or dP)
  extern __shared__ __align__(128) unsigned char smem[];

  const int groups = blockDim.x / (32 * CS);
  const int rows = C::kGroupRows * groups;
  const int warps = groups * CS;
  T* q_s = reinterpret_cast<T*>(smem);  // [rows][kLd]
  T* do_s = q_s + rows * kLd;           // [rows][kLd]
  T* kv_s = do_s + rows * kLd;          // NBUF x (K [KV][kLd], V [KV][kLd])
  float* xch = reinterpret_cast<float*>(kv_s + 2 * NBUF * KV * kLd);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int c0 = cs * DC;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int n_tiles = (p.Skv + KV - 1) / KV;
  const TileStream<T, KV, kLd, C::kCols, NBUF> kv{
      kv_s,
      reinterpret_cast<uint64_t*>(xch + (CS > 1 ? warps * 2 * kSlot : 0)),
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh,
      p.k_ss, p.v_ss, p.Skv, p.D, n_tiles};

  stage_rows<T, C::kCols>(q_s, kLd, q, p.q_ss, q0, rows, p.Sq, p.D);
  stage_rows<T, C::kCols>(do_s, kLd, dout, p.do_ss, q0, rows, p.Sq, p.D);
  cp_async_commit();
  kv.init();
  __syncthreads();  // mbarriers initialised and armed, columns zeroed
  if (warp == 0)
    for (int t = 0; t < (NBUF > 1 ? NBUF - 1 : 1) && t < n_tiles; ++t)
      kv.issue(t);

  // LSE (times log2(e): P = exp2(scale * log2(e) * S - that)) and delta of
  // this lane's rows g and g + 8 of each m-tile; 0 past Sq (those rows have
  // Q = dO = 0, so dS = 0 there, and they are not written)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = p.scale * kLog2e;
  const int g = lane >> 2;
  float lse2[MT][2], delta[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rg * C::kGroupRows + 16 * i + g + 8 * r;
      const int64_t at = static_cast<int64_t>(bh) * p.Sq + row;
      lse2[i][r] = row < p.Sq ? p.lse[at] * kLog2e : 0.f;
      delta[i][r] = row < p.Sq ? p.delta[at] : 0.f;
    }

  float acc[MT][NO][4];
  zero(acc);

  const T* q_w = q_s + rg * C::kGroupRows * kLd + c0;
  const T* do_w = do_s + rg * C::kGroupRows * kLd + c0;
  float* xch_group = xch + rg * CS * 2 * kSlot;
  for (int t = 0; t < n_tiles; ++t) {
    const T* k_t = kv.wait(t);
    const T* v_t = k_t + KV * kLd;
    cp_async_wait<0>();  // Q and dO
    // tile t, Q and dO visible to every warp; every warp is done with tile
    // t - 1, its buffer and the exchange
    __syncthreads();
    if (NBUF > 1 && t + NBUF - 1 < n_tiles && warp == 0)
      kv.issue(t + NBUF - 1);  // overlaps the products of tiles t, t + 1..

    float s[MT][NS][4], dp[MT][NS][4];
    zero(s);
    zero(dp);
    MmaRows<T>::template a_smem_b_nk<MT, NS, DC>(s, q_w, kLd, k_t + c0,
                                                 kLd);
    MmaRows<T>::template a_smem_b_nk<MT, NS, DC>(dp, do_w, kLd, v_t + c0,
                                                 kLd);
    if (CS > 1) {
      // slots: [S of warps 0..CS-1][dP of warps 0..CS-1]
      xch_put(xch_group + cs * kSlot, s);
      xch_put(xch_group + (CS + cs) * kSlot, dp);
      row_sync(1 + rg, 32 * CS);
      xch_sum<CS>(xch_group, s);
      xch_sum<CS>(xch_group + CS * kSlot, dp);
    }

    // dS = P * (dP - delta) into s
    const int kv0 = t * KV;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const float pr = kv0 + frag_col(n, j) < p.Skv
                               ? exp2f(s[i][n][j] * scale2 - lse2[i][r])
                               : 0.f;
          s[i][n][j] = pr * (dp[i][n][j] - delta[i][r]);
        }

    MmaRows<T>::template a_frag_b_kn<MT, NS, NO, true>(acc, s, k_t + c0,
                                                       kLd);
    if (NBUF == 1 && t + 1 < n_tiles) {
      __syncthreads();  // the one buffer is consumed
      if (warp == 0) kv.issue(t + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rg * C::kGroupRows + 16 * i + g + 8 * r;
      if (row >= p.Sq) continue;
      T* dq_row = dq + row * p.dq_ss;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = c0 + frag_col(n, 0);
        if (col < p.D)
          store_pair(dq_row + col, acc[i][n][2 * r] * p.scale,
                     acc[i][n][2 * r + 1] * p.scale);
      }
    }
}

template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Config<T, DC, CS, KV, RG, NBUF, MT>;
  auto kernel = flash_bwd_dq_kernel<T, DC, CS, KV, RG, NBUF, MT>;
  static std::atomic<unsigned> raised{0};
  return launch_tiles(kernel, p, stream, p.Sq, C::kGroupRows, RG, CS,
                      C::smem_bytes(RG), C::smem_bytes, raised);
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (p.D <= 32) return launch<T, 32, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<T, 64, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<T, 128, 1, 32, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<T, 128, 2, 32, 4, 2, 1>(p, st);
  return launch<T, 256, 2, 16, 4, 2, 1>(p, st);
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch<float, 32, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<float, 64, 1, 32, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<float, 64, 2, 32, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<float, 128, 2, 16, 4, 2, 1>(p, st);
  return launch<float, 128, 4, 16, 2, 1, 1>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `in_strides` holds the (batch, sequence,
// head) element strides of q, k, v and dO, 12 values. The caller checks
// shapes (D a multiple of 8, at most 512), dtypes, that every last axis has
// stride 1, and that lse and delta are contiguous [B, H, Sq] fp32; dq is
// fresh (aligned rows).
extern "C" int vq_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Sq, int Skv, int D,
                               const int64_t* in_strides, int64_t dq_sb,
                               int64_t dq_ss, int64_t dq_sh, float scale,
                               int dtype, void* stream) {
  const int64_t* s = in_strides;
  const int64_t elem = dtype == 0 ? 4 : 2;
  const void* inputs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!rows_aligned(inputs[i], s[3 * i], s[3 * i + 1], s[3 * i + 2], B,
                      i == 1 || i == 2 ? Skv : Sq, H, elem))
      return kMisaligned;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_f32(p, st) : dispatch_bf16(p, st);
  return static_cast<int>(err);
}
