// Flash-attention backward, dK and dV, for Hopper (sm_90a) on the tensor
// cores, fp32 and bf16 inputs.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` in
// vqgan_tpu/ops/attention.py (launched by `_flash_backward`). With
// P = exp(scale * Q K^T - LSE) recomputed from the forward's saved
// log-sum-exp (never stored in device memory), dP = dO V^T and the row term
// delta = rowsum(dO * O) computed by the caller:
//   dV = sum_i P^T dO_i,  dK = scale * sum_i [P * (dP - delta)]^T Q_i
//                                                   (q rows past Sq: P = 0)
// Every sum is taken in fp32. One block owns its kv rows and writes each dK
// and dV element once (one block per kv tile, as in the JAX grid): no
// atomics, so a run is bit-for-bit repeatable.
//
// What bounds it on this card, at the main path's shapes (8 * B * S^2 * d
// operations; bytes = Q, dO, K, V, dK, dV once, LSE and delta):
//  - VQ-VAE mid block in VQ-GAN training, [8, 1024, 1, 512] bf16: 34.4 GFLOP
//    against 50 MB, operations: 0.0347 ms at 989 TFLOP/s.
//  - U-Net mid block in LDM training, [8, 16, 8, 64] bf16: ~8 MFLOP over
//    ~100 KB, so the launch (a few microseconds) bounds it.
//  - (Off the main path: stage-1 KL-VAE training's [16, 1024, 1, 512] fp32,
//    3xTF32 as in the forward and dQ: 68.7 GFLOP at 165 TFLOP/s of
//    fp32-accurate products, 0.416 ms.)
// What the design does about it (primitives in flash_tc.cuh; dQ's
// structure, flash_bwd_dq.cu, with the roles of the rows swapped):
//  - The block owns RG row groups of 16 MT kv rows; K and V are staged once
//    by cp.async. Q and dO stream through in tiles of QT rows by bulk copies
//    on an mbarrier per buffer, double-buffered. Each lane loads the LSE
//    and delta of its q columns of the next tile while this tile's
//    products run.
//  - The kernel computes the transposed products, so the owned kv rows are
//    the M dimension of every MMA: S^T = K Q^T and dP^T = V dO^T by
//    mma.sync; P^T = exp2(scale * log2(e) * S^T - log2(e) * LSE) on the
//    accumulator fragments (the LSE per column: a column is a q row; zero
//    on columns past Sq) and dS^T = P^T * (dP^T - delta) in fp32 registers;
//    then dV += P^T dO and dK += dS^T Q, the C fragments serving as A
//    fragments and the B fragments of dO and Q coming by ldmatrix.trans.
//    P and dS go in as hi + lo, two bf16 products each, as dS does in dQ
//    (measured at [8, 1024, 1, 512]: P rounded to bf16 once left 42% of
//    dV's elements off the plain version's, hi + lo 0.28%, PERF.md).
//    fp32 runs every product as 3xTF32. dK is written once, times the
//    scale, in the input dtype.
//  - Two accumulators (dK and dV) per owned row: at d = 512, dQ's layout of
//    16 rows x 256 columns per warp would take 256 registers of
//    accumulators alone. So CS = 4 warps share a row group, each owning
//    DC = 128 columns of dK and dV (64 + 64 fp32 registers); each computes
//    partial S^T and dP^T over its columns, and the partials are summed
//    through shared memory in slot order, so every warp of the group holds
//    the same bits.
// Configurations at the main path's shapes, with `nvcc -Xptxas -v` for
// sm_90a (no instance spills or keeps a stack frame):
//  - d = 512 bf16: 8 warps = 2 row groups x 4 column quarters, 32 kv rows
//    per block (256 blocks at [8, 1024, 1, 512]), 16-row Q/dO tiles; 226
//    registers, 149,520 bytes of shared memory (K, V 32 x 512; two Q/dO
//    buffers of 2 x 16 x 512; the exchange), one block per SM.
//  - d = 64 bf16 (U-Net): one warp per 16 kv rows, 16-row Q/dO tiles, so
//    the U-Net's Sq = Skv = 16 is one tile of one warp per (batch, head);
//    153 registers.
// Strides are passed in, so BSHD tensors are read and written in place.
//
// C interface (ctypes): vq_flash_bwd_dkv(...) returns cudaGetLastError() of
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

// DC head columns per warp, CS warps per row group, QT rows per Q/dO tile,
// RG row groups per block at most, NBUF Q/dO buffers, MT 16-row m-tiles of
// kv rows per warp.
template <typename T, int DC, int CS, int QT, int RG, int NBUF, int MT>
struct Config {
  static constexpr int kCols = DC * CS;
  static constexpr int kLd = kCols + Pad<T>::kElems;
  static constexpr int kGroupRows = 16 * MT;

  // K, V, the Q/dO buffers, the column-split exchange (S^T and dP^T), one
  // mbarrier per buffer
  static size_t smem_bytes(int rg) {
    const size_t rows = kGroupRows * static_cast<size_t>(rg);
    size_t bytes = sizeof(T) * (2 * rows + 2 * NBUF * QT) * kLd;
    if (CS > 1) bytes += sizeof(float) * rg * CS * 2 * MT * (QT / 2) * 32;
    return bytes + sizeof(uint64_t) * NBUF;
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// LSE (times log2(e)) and delta of this lane's q columns of the tile at
// q0 (columns 2t, 2t + 1 of each n-tile); 0 past Sq, where P is zeroed.
template <int NS>
__device__ __forceinline__ void load_column_stats(const float* lse,
                                                  const float* delta, int q0,
                                                  int Sq, float (&lse2)[NS][2],
                                                  float (&dlt)[NS][2]) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = q0 + frag_col(n, c);
      lse2[n][c] = q < Sq ? lse[q] * kLog2e : 0.f;
      dlt[n][c] = q < Sq ? delta[q] : 0.f;
    }
}

template <typename T, int DC, int CS, int QT, int RG, int NBUF, int MT>
__global__ void __launch_bounds__(32 * RG * CS, 1)
    flash_bwd_dkv_kernel(const Params p) {
  using C = Config<T, DC, CS, QT, RG, NBUF, MT>;
  constexpr int kLd = C::kLd;
  constexpr int NS = QT / 8;  // n-tiles of the S^T tile (q columns)
  constexpr int NO = DC / 8;  // n-tiles of a warp's dK/dV columns
  constexpr int kSlot = MT * NS * 4 * 32;  // one warp's partial S^T (or dP^T)
  extern __shared__ __align__(128) unsigned char smem[];

  const int groups = blockDim.x / (32 * CS);
  const int rows = C::kGroupRows * groups;
  const int warps = groups * CS;
  T* k_s = reinterpret_cast<T*>(smem);  // [rows][kLd]
  T* v_s = k_s + rows * kLd;            // [rows][kLd]
  T* qd_s = v_s + rows * kLd;  // NBUF x (Q [QT][kLd], dO [QT][kLd])
  float* xch = reinterpret_cast<float*>(qd_s + 2 * NBUF * QT * kLd);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kv0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int c0 = cs * DC;

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.Sq;
  const int n_tiles = (p.Sq + QT - 1) / QT;
  const TileStream<T, QT, kLd, C::kCols, NBUF> qd{
      qd_s,
      reinterpret_cast<uint64_t*>(xch + (CS > 1 ? warps * 2 * kSlot : 0)),
      static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
      p.q_ss, p.do_ss, p.Sq, p.D, n_tiles};

  stage_rows<T, C::kCols>(k_s, kLd, k, p.k_ss, kv0, rows, p.Skv, p.D);
  stage_rows<T, C::kCols>(v_s, kLd, v, p.v_ss, kv0, rows, p.Skv, p.D);
  cp_async_commit();
  qd.init();
  __syncthreads();  // mbarriers initialised and armed, columns zeroed
  if (warp == 0)
    for (int t = 0; t < (NBUF > 1 ? NBUF - 1 : 1) && t < n_tiles; ++t)
      qd.issue(t);

  const float scale2 = p.scale * kLog2e;
  float lse2_next[NS][2], dlt_next[NS][2];
  load_column_stats(lse, delta, 0, p.Sq, lse2_next, dlt_next);

  float acc_dk[MT][NO][4], acc_dv[MT][NO][4];
  zero(acc_dk);
  zero(acc_dv);

  const T* k_w = k_s + rg * C::kGroupRows * kLd + c0;
  const T* v_w = v_s + rg * C::kGroupRows * kLd + c0;
  float* xch_group = xch + rg * CS * 2 * kSlot;
  for (int t = 0; t < n_tiles; ++t) {
    const T* q_t = qd.wait(t);
    const T* do_t = q_t + QT * kLd;
    cp_async_wait<0>();  // K and V
    // tile t, K and V visible to every warp; every warp is done with tile
    // t - 1, its buffer and the exchange
    __syncthreads();
    if (NBUF > 1 && t + NBUF - 1 < n_tiles && warp == 0)
      qd.issue(t + NBUF - 1);  // overlaps the products of tiles t, t + 1..

    float lse2[NS][2], dlt[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lse2[n][c] = lse2_next[n][c];
        dlt[n][c] = dlt_next[n][c];
      }
    if (t + 1 < n_tiles)  // in flight during this tile's products
      load_column_stats(lse, delta, (t + 1) * QT, p.Sq, lse2_next, dlt_next);

    float s[MT][NS][4], dp[MT][NS][4];
    zero(s);
    zero(dp);
    MmaRows<T>::template a_smem_b_nk<MT, NS, DC>(s, k_w, kLd, q_t + c0,
                                                 kLd);
    MmaRows<T>::template a_smem_b_nk<MT, NS, DC>(dp, v_w, kLd, do_t + c0,
                                                 kLd);
    if (CS > 1) {
      // slots: [S^T of warps 0..CS-1][dP^T of warps 0..CS-1]
      xch_put(xch_group + cs * kSlot, s);
      xch_put(xch_group + (CS + cs) * kSlot, dp);
      row_sync(1 + rg, 32 * CS);
      xch_sum<CS>(xch_group, s);
      xch_sum<CS>(xch_group + CS * kSlot, dp);
    }

    // P^T into s, dS^T = P^T * (dP^T - delta) into dp
    const int q0 = t * QT;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = j & 1;
          const float pr = q0 + frag_col(n, j) < p.Sq
                               ? exp2f(fmaf(s[i][n][j], scale2, -lse2[n][c]))
                               : 0.f;
          s[i][n][j] = pr;
          dp[i][n][j] = pr * (dp[i][n][j] - dlt[n][c]);
        }

    MmaRows<T>::template a_frag_b_kn<MT, NS, NO, true>(acc_dv, s, do_t + c0,
                                                       kLd);
    MmaRows<T>::template a_frag_b_kn<MT, NS, NO, true>(acc_dk, dp, q_t + c0,
                                                       kLd);
    if (NBUF == 1 && t + 1 < n_tiles) {
      __syncthreads();  // the one buffer is consumed
      if (warp == 0) qd.issue(t + 1);
    }
  }

  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv0 + rg * C::kGroupRows + 16 * i + g + 8 * r;
      if (row >= p.Skv) continue;
      T* dk_row = dk + row * p.dk_ss;
      T* dv_row = dv + row * p.dv_ss;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = c0 + frag_col(n, 0);
        if (col < p.D) {
          store_pair(dk_row + col, acc_dk[i][n][2 * r] * p.scale,
                     acc_dk[i][n][2 * r + 1] * p.scale);
          store_pair(dv_row + col, acc_dv[i][n][2 * r],
                     acc_dv[i][n][2 * r + 1]);
        }
      }
    }
}

template <typename T, int DC, int CS, int QT, int RG, int NBUF, int MT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Config<T, DC, CS, QT, RG, NBUF, MT>;
  auto kernel = flash_bwd_dkv_kernel<T, DC, CS, QT, RG, NBUF, MT>;
  static std::atomic<unsigned> raised{0};
  return launch_tiles(kernel, p, stream, p.Skv, C::kGroupRows, RG, CS,
                      C::smem_bytes(RG), C::smem_bytes, raised);
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (p.D <= 32) return launch<T, 32, 1, 16, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<T, 64, 1, 16, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<T, 128, 1, 16, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<T, 128, 2, 16, 4, 2, 1>(p, st);
  return launch<T, 128, 4, 16, 2, 2, 1>(p, st);
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch<float, 32, 1, 16, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<float, 64, 1, 16, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<float, 64, 2, 16, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<float, 128, 2, 16, 4, 2, 1>(p, st);
  return launch<float, 128, 4, 16, 2, 1, 1>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `in_strides` holds the (batch, sequence,
// head) element strides of q, k, v and dO, 12 values. The caller checks
// shapes (D a multiple of 8, at most 512), dtypes, that every last axis has
// stride 1, and that lse and delta are contiguous [B, H, Sq] fp32; dk and dv
// are fresh (aligned rows).
extern "C" int vq_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Skv, int D,
                                const int64_t* in_strides, int64_t dk_sb,
                                int64_t dk_ss, int64_t dk_sh, int64_t dv_sb,
                                int64_t dv_ss, int64_t dv_sh, float scale,
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
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = s[0]; p.q_ss = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_ss = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_ss = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_ss = s[10]; p.do_sh = s[11];
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_f32(p, st) : dispatch_bf16(p, st);
  return static_cast<int>(err);
}
