// Flash-attention forward for Hopper (sm_90a) on the tensor cores, fp32 and
// bf16 inputs.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in vqgan_tpu/ops/attention.py
// (launched by `_flash_forward`): O = softmax(scale * Q K^T) V with an online
// softmax (fp32 running max, sum and accumulator), kv columns past the
// sequence end masked to -1e30, the row sum floored at 1e-30, and the per-row
// log-sum-exp LSE = m + log(l) written in fp32 for a backward pass.
//
// What bounds it on this card, at the main path's shapes (4 * B * S^2 * d
// operations; bytes = Q, K, V and O once, LSE):
//  - VQ-VAE mid block in VQ-GAN training, [8, 1024, 1, 512] bf16: 17.2 GFLOP
//    against 34 MB, operations: 0.0174 ms at 989 TFLOP/s.
//  - KL-VAE mid block in generation, [16, 1024, 1, 512] fp32: 34.4 GFLOP
//    against 134 MB. The JAX side holds fp32 to "highest" precision; the
//    fastest fp32-accurate product here is 3xTF32 (three TF32 products per
//    product on the tensor cores at 495 TFLOP/s), so operations: 0.208 ms.
//    (The fp32 units' 67 TFLOP/s would take 0.513 ms.)
//  - U-Net mid block, [2B, 16, 8, 64] bf16: a few hundred KB and a few
//    MFLOP, so the launch itself (a few microseconds) bounds it.
// What the design does about it (primitives in flash_tc.cuh):
//  - A block owns RG row groups of 16 MT query rows (fewer groups when Sq
//    is small: the U-Net's Sq = 16 takes one 16-row tile per (batch, head))
//    and streams K/V tiles of KV rows through NBUF shared-memory buffers.
//    Q is staged once by 16-byte cp.async; K/V rows arrive by bulk copies
//    (the TMA engine) issued by warp 0 on an mbarrier per buffer, the next
//    tile's copies overlapping this tile's products.
//  - S = Q K^T and O += P V are mma.sync on the tensor cores with fp32
//    accumulation: bf16 m16n8k16 (P rounded to bf16 once: at
//    [8,1024,1,512] the kernel stays within one bf16 step of the plain fp32
//    version, PERF.md), or fp32 as 3xTF32 m16n8k8 (P split hi/lo too). The
//    softmax stays in fp32 registers on the S fragments, which become P's
//    A fragments without a trip through memory; it runs in base 2
//    (exp2 of scale * log2(e) * S), the LSE converted back to base e.
//  - At wide heads the O accumulator does not fit one warp, so CS warps
//    share a row group, each owning DC = d / CS columns: each computes a
//    partial S over its columns, the partials are summed through a small
//    shared-memory exchange (every warp of the group gets the same bits),
//    and each accumulates its own DC columns of O.
//  - Rows are padded by 16 bytes in shared memory (no bank conflicts);
//    columns past d up to the staged width and rows past S are zeros.
// Configurations at the main path's shapes, with `nvcc -Xptxas -v` for
// sm_90a (no instance spills or keeps a stack frame):
//  - d = 512 bf16: 8 warps = 4 row groups x 2 column halves (MT 1), 16 x 256
//    fp32 of O per warp, two 32-row K/V buffers; 232 registers, 216,080
//    bytes of shared memory (Q 64 x 512, K/V 2 x 2 x 32 x 512, exchange).
//  - d = 512 fp32: 8 warps = 2 row groups of 32 rows (MT 2) x 4 column
//    quarters, 2 x 16 x 128 fp32 of O per warp, one 16-row K/V buffer (64
//    query rows per block halve the K/V traffic of 32); 234 registers,
//    214,536 bytes.
//  - d = 64 bf16 (U-Net): one warp per 16-row tile, 64-row K/V tiles; 139
//    registers, 39,184 bytes.
// Strides are passed in, so BSHD tensors are read in place.
//
// C interface (ctypes): vq_flash_fwd(...) returns cudaGetLastError() of the
// launch as an int (0 means launched), or kMisaligned, launching nothing,
// when a row of q, k or v does not start on 16 bytes.

#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

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

// T: element type. DC: head columns per warp; CS: warps per row group (the
// staged width is DC * CS >= d); KV: rows per K/V tile; RG: row groups per
// block at most; NBUF: K/V buffers; MT: 16-row m-tiles per warp (a row
// group is 16 MT rows).
template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
struct Config {
  static constexpr int kCols = DC * CS;
  static constexpr int kLd = kCols + Pad<T>::kElems;
  static constexpr int kGroupRows = 16 * MT;

  // Q, the K/V buffers, the column-split exchange, one mbarrier per buffer
  static size_t smem_bytes(int rg) {
    const size_t rows = kGroupRows * static_cast<size_t>(rg);
    size_t bytes = sizeof(T) * (rows + 2 * NBUF * KV) * kLd;
    if (CS > 1) bytes += sizeof(float) * rg * CS * MT * (KV / 2) * 32;
    return bytes + sizeof(uint64_t) * NBUF;
  }
};

template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
__global__ void __launch_bounds__(32 * RG * CS, 1)
    flash_fwd_kernel(const Params p) {
  using C = Config<T, DC, CS, KV, RG, NBUF, MT>;
  constexpr int kLd = C::kLd;
  constexpr int NS = KV / 8;  // n-tiles of the score tile
  constexpr int NO = DC / 8;  // n-tiles of a warp's output columns
  constexpr int kSlot = MT * NS * 4 * 32;  // one warp's partial scores
  extern __shared__ __align__(128) unsigned char smem[];

  const int groups = blockDim.x / (32 * CS);
  const int rows = C::kGroupRows * groups;
  const int warps = groups * CS;
  T* q_s = reinterpret_cast<T*>(smem);  // [rows][kLd]
  T* kv_s = q_s + rows * kLd;           // NBUF x (K [KV][kLd], V [KV][kLd])
  float* xch = reinterpret_cast<float*>(kv_s + 2 * NBUF * KV * kLd);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int c0 = cs * DC;  // this warp's first head column

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int n_tiles = (p.Skv + KV - 1) / KV;
  const TileStream<T, KV, kLd, C::kCols, NBUF> kv{
      kv_s, reinterpret_cast<uint64_t*>(xch + (CS > 1 ? warps * kSlot : 0)),
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh,
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh,
      p.k_ss, p.v_ss, p.Skv, p.D, n_tiles};

  stage_rows<T, C::kCols>(q_s, kLd, q, p.q_ss, q0, rows, p.Sq, p.D);
  cp_async_commit();
  kv.init();
  __syncthreads();  // mbarriers initialised and armed, columns zeroed
  if (warp == 0)
    for (int t = 0; t < (NBUF > 1 ? NBUF - 1 : 1) && t < n_tiles; ++t)
      kv.issue(t);

  float acc[MT][NO][4];
  zero(acc);
  float m[MT][2], l[MT][2];  // running max; this lane's share of the sums
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }

  const T* q_w = q_s + rg * C::kGroupRows * kLd + c0;
  float* xch_group = xch + rg * CS * kSlot;
  // the softmax runs in base 2: x = scale * log2(e) * S, m and the LSE's
  // max in the same units
  const float scale2 = p.scale * 1.4426950408889634f;
  for (int t = 0; t < n_tiles; ++t) {
    const T* k_t = kv.wait(t);
    const T* v_t = k_t + KV * kLd;
    cp_async_wait<0>();  // Q
    // tile t and Q visible to every warp; every warp is done with tile
    // t - 1, its buffer and the exchange
    __syncthreads();
    if (NBUF > 1 && t + NBUF - 1 < n_tiles && warp == 0)
      kv.issue(t + NBUF - 1);  // overlaps the products of tiles t, t + 1..

    float s[MT][NS][4];
    zero(s);
    MmaRows<T>::template a_smem_b_nk<MT, NS, DC>(s, q_w, kLd, k_t + c0,
                                                 kLd);
    if (CS > 1) {
      xch_put(xch_group + cs * kSlot, s);
      row_sync(1 + rg, 32 * CS);
      xch_sum<CS>(xch_group, s);
    }

    // online softmax on the fragments: rows g (r = 0) and g + 8 (r = 1) of
    // each m-tile
    const int kv0 = t * KV;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x =
              kv0 + frag_col(n, j) < p.Skv ? s[i][n][j] * scale2 : kNegInf;
          s[i][n][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[i][r], quad_max(mx[r]));
        alpha[r] = exp2f(m[i][r] - m_new);
        m[i][r] = m_new;
        l[i][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = exp2f(s[i][n][j] - m[i][j >> 1]);
          s[i][n][j] = e;
          l[i][j >> 1] += e;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][n][j] *= alpha[j >> 1];
    }

    MmaRows<T>::template a_frag_b_kn<MT, NS, NO>(acc, s, v_t + c0, kLd);
    if (NBUF == 1 && t + 1 < n_tiles) {
      __syncthreads();  // the one buffer is consumed
      if (warp == 0) kv.issue(t + 1);
    }
  }

  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rg * C::kGroupRows + 16 * i + g + 8 * r;
      const float l_safe = fmaxf(quad_sum(l[i][r]), 1e-30f);
      if (row >= p.Sq) continue;
      const float inv = 1.f / l_safe;
      T* o_row = o + row * p.o_ss;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = c0 + frag_col(n, 0);
        if (col < p.D)
          store_pair(o_row + col, acc[i][n][2 * r] * inv,
                     acc[i][n][2 * r + 1] * inv);
      }
      if (cs == 0 && (lane & 3) == 0)
        p.lse[static_cast<int64_t>(bh) * p.Sq + row] =
            m[i][r] * 0.6931471805599453f + logf(l_safe);
    }
}

template <typename T, int DC, int CS, int KV, int RG, int NBUF, int MT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Config<T, DC, CS, KV, RG, NBUF, MT>;
  auto kernel = flash_fwd_kernel<T, DC, CS, KV, RG, NBUF, MT>;
  static std::atomic<unsigned> raised{0};
  return launch_tiles(kernel, p, stream, p.Sq, C::kGroupRows, RG, CS,
                      C::smem_bytes(RG), C::smem_bytes, raised);
}

cudaError_t dispatch_bf16(const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  if (p.D <= 32) return launch<T, 32, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<T, 64, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<T, 128, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<T, 128, 2, 64, 4, 2, 1>(p, st);
  return launch<T, 256, 2, 32, 4, 2, 1>(p, st);
}

cudaError_t dispatch_f32(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch<float, 32, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 64) return launch<float, 64, 1, 64, 4, 2, 1>(p, st);
  if (p.D <= 128) return launch<float, 128, 1, 32, 4, 2, 1>(p, st);
  if (p.D <= 256) return launch<float, 128, 2, 32, 4, 2, 1>(p, st);
  return launch<float, 128, 4, 16, 2, 1, 2>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller checks shapes (D a multiple of
// 8, at most 512), dtypes and that every last axis has stride 1; o is fresh
// (aligned rows).
extern "C" int vq_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Sq, int Skv,
                            int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                            int64_t k_sb, int64_t k_ss, int64_t k_sh,
                            int64_t v_sb, int64_t v_ss, int64_t v_sh,
                            int64_t o_sb, int64_t o_ss, int64_t o_sh,
                            float scale, int dtype, void* stream) {
  const int64_t elem = dtype == 0 ? 4 : 2;
  if (!rows_aligned(q, q_sb, q_ss, q_sh, B, Sq, H, elem) ||
      !rows_aligned(k, k_sb, k_ss, k_sh, B, Skv, H, elem) ||
      !rows_aligned(v, v_sb, v_ss, v_sh, B, Skv, H, elem))
    return kMisaligned;
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
  cudaError_t err = dtype == 0 ? dispatch_f32(p, st) : dispatch_bf16(p, st);
  return static_cast<int>(err);
}
