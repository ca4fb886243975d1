// Tensor-core tile primitives for the flash-attention kernels on Hopper
// (sm_90a): cp.async staging of the resident rows, a stream of row tiles
// (K/V, or Q/dO) by bulk copy (TMA) on mbarriers, ldmatrix fragment loads,
// and two MMA policies behind one interface, bf16 (mma.sync m16n8k16, fp32
// accumulation) and fp32 as 3xTF32 (mma.sync m16n8k8 on a split
// x = hi + lo, summing lo*hi + hi*lo + hi*hi, which keeps near-fp32
// agreement: the dropped lo*lo term and the rounding of lo are ~2^-21 of
// each product).
//
// Every product is one warp's: A is 16 rows, B is n-tiles of 8 columns, C
// is the m16n8 fp32 fragment (lane = 4 * g + t holds rows g and g + 8,
// columns 2t and 2t + 1: c[0], c[1] on row g, c[2], c[3] on row g + 8).
// A "k-step" is 32 bytes of a row: 16 bf16 or 8 fp32 values. Both types
// share the ldmatrix addressing in bytes (an 8x8 b16 matrix is 8 rows of 4
// fp32 values, which is the tf32 fragment layout).
//
// Shared-memory rows are padded by 16 bytes: with a row of (16 m + 16) bytes
// the 8 row addresses of an ldmatrix fall in 8 distinct 4-bank groups, and
// for fp32 the scalar B loads of rows 2t and 2t + 1 (below) hit 32 distinct
// banks, so no read of these tiles has a bank conflict.
//
// mma.sync, not wgmma: a wgmma output tile is 64 rows per warpgroup, and at
// d = 512 an fp32 accumulator of 64 x 256 columns takes 256 registers per
// thread, more than a thread has, so the design would have to be FA3's
// (producer warps, TMA, O split across warpgroups and ping-pong softmax).
// mma.sync keeps each warp's 16 rows x 256 columns in 128 registers
// (FA2's budget at head_dim 256). wgmma/TMA is a later option for d = 512.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash_tc {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory row padding, in elements (16 bytes).
template <typename T>
struct Pad {
  static constexpr int kElems = 16 / sizeof(T);
};

// Copy rows [s0, s0 + n) of a [S, d] slice (row stride `ss` elements) into
// shared-memory rows of `ld` elements, columns [0, COLS), 16 bytes per
// cp.async by every thread of the block. Rows past S and columns past d are
// zero-filled (zeros, not garbage: a zero P or dS times garbage can be
// NaN). `src` and every row start must be 16-byte aligned (the wrapper
// checks the base pointer and the strides); d is a multiple of 8.
template <typename T, int COLS>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t ss, int s0, int n, int S,
                                           int d) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = COLS / kVec;
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const int s = s0 + r;
    const bool valid = s < S && c < d;
    const T* g = valid ? src + s * ss + c : src;
    cp_async_16(smem_u32(dst + r * ld + c), g, valid);
  }
}

// ---- row tiles by bulk copy (the TMA engine without a tensor map) ---------
//
// One instruction moves a whole row into shared memory and reports its
// bytes to an mbarrier, so no thread spends registers or issue slots on
// the copy (measured at d = 512: with every thread issuing 16-byte
// cp.async, the copies slowed the products of each tile severalfold).

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Makes the initialised mbarriers visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy shared-memory accesses (and
// those a barrier made visible to it) before its later bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The single arrival of a phase, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the mbarrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Zero rows [r0, r1) x columns [c0, c1) of a tile with 16-byte stores
// (c0 and c1 multiples of 16 bytes), by every thread of the block.
template <typename T>
__device__ __forceinline__ void zero_box(T* dst, int ld, int r0, int r1,
                                         int c0, int c1) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = (c1 - c0) / kVec;
  for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x) {
    const int r = r0 + i / chunks;
    const int c = c0 + (i % chunks) * kVec;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

// The tile stream of one CTA: tiles of ROWS rows of two [S, d] row tensors
// (K and V for the forward and dQ, Q and dO for dK/dV), NBUF buffers of
// (a [ROWS][LD], b [ROWS][LD]) at `tiles`, one mbarrier per buffer at
// `bars`. Tile t goes to buffer t % NBUF. Rows below S arrive by bulk copy
// (COLS >= d columns staged); columns past d are zeroed once, rows past S
// when their tile arrives. Each buffer's mbarrier is armed for its next tile
// as soon as its current tile has arrived, so it is always armed before
// anything copies into it.
//   init()       every thread, then __syncthreads()
//   issue(t)     warp 0, after a __syncthreads() that follows the last read
//                of tile t's buffer
//   wait(t)      every thread; returns tile t's a rows (b follows at
//                + ROWS * LD); then a __syncthreads() before the tile is
//                read
template <typename T, int ROWS, int LD, int COLS, int NBUF>
struct TileStream {
  T* tiles;
  uint64_t* bars;
  const T* a;
  const T* b;
  int64_t a_ss, b_ss;
  int S, D, n_tiles;

  __device__ T* tile(int t) const {
    return tiles + (t % NBUF) * 2 * ROWS * LD;
  }

  __device__ uint32_t tile_bytes(int t) const {
    const int rows = min(ROWS, S - t * ROWS);
    return 2u * rows * D * sizeof(T);
  }

  __device__ void init() const {
    if (D < COLS) zero_box(tiles, LD, 0, 2 * NBUF * ROWS, D, COLS);
    if (threadIdx.x == 0) {
      for (int i = 0; i < NBUF; ++i) mbar_init(&bars[i]);
      fence_mbar_init();
      for (int i = 0; i < NBUF && i < n_tiles; ++i)
        mbar_expect_tx(&bars[i], tile_bytes(i));
    }
  }

  __device__ void issue(int t) const {
    const int s0 = t * ROWS;
    const int rows = min(ROWS, S - s0);
    const uint32_t row_bytes = D * sizeof(T);
    T* a_dst = tile(t);
    T* b_dst = a_dst + ROWS * LD;
    uint64_t* bar = &bars[t % NBUF];
    fence_proxy_async();
    for (int r = threadIdx.x & 31; r < rows; r += 32) {
      bulk_copy(a_dst + r * LD, a + (s0 + r) * a_ss, row_bytes, bar);
      bulk_copy(b_dst + r * LD, b + (s0 + r) * b_ss, row_bytes, bar);
    }
  }

  __device__ T* wait(int t) const {
    uint64_t* bar = &bars[t % NBUF];
    mbar_wait(bar, (t / NBUF) & 1);
    if (threadIdx.x == 0 && t + NBUF < n_tiles)
      mbar_expect_tx(bar, tile_bytes(t + NBUF));
    T* a_dst = tile(t);
    const int rows = S - t * ROWS;
    if (rows < ROWS) {  // the last tile: zeros, not stale rows, past S
      zero_box(a_dst, LD, rows, ROWS, 0, COLS);
      zero_box(a_dst + ROWS * LD, LD, rows, ROWS, 0, COLS);
    }
    return a_dst;
  }
};

// ---- fragments -------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to tf32's 10 mantissa bits (to nearest, ties
// away, by integer arithmetic: cvt.rna.tf32 runs at a fraction of the ALU
// rate and, measured, bounded the whole fp32 kernel), lo = x - hi exactly
// in fp32; the tensor core reads lo's top 10 mantissa bits, so lo keeps
// ~2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a * b in 3xTF32: the small terms first, the large one last.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) = hi + lo, each a pair of bf16: hi rounds to bf16, lo is the
// remainder rounded to bf16, so hi + lo keeps ~16 mantissa bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&x)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][n][j] = 0.f;
}

// ---- the two products of a flash tile, one warp each ------------------------
//
// A warp owns MT m-tiles of 16 rows (rows 16 i .. 16 i + 15 for m-tile i),
// so every B fragment it loads feeds MT products.
// MmaRows<T>::a_smem_b_nk: acc[i][n] += A_i . B^T over KC columns, A = 16 MT
//   rows at `a` (row stride lda), B = NT * 8 rows at `b` (row stride ldb),
//   both [row][k] in shared memory. S = Q K^T and dP = dO V^T (for dK/dV
//   the transposes, S^T = K Q^T and dP^T = V dO^T). The k loop is
//   unrolled whole, so the compiler can issue the next step's ldmatrix
//   before this step's products.
// MmaRows<T>::a_frag_b_kn: acc[i][n] += P_i . B, P the 16 MT x (8 NS) fp32
//   C fragments of an earlier product (in registers), B = (8 NS) rows x
//   (NT * 8) columns at `b`, [k][n] in shared memory. O += P V, dQ += dS K,
//   dV += P^T dO and dK += dS^T Q.
//   SPLIT (bf16 only; fp32 always splits) takes P as hi + lo in two
//   products.

template <typename T>
struct MmaRows;

template <>
struct MmaRows<__nv_bfloat16> {
  using T = __nv_bfloat16;

  template <int MT, int NT, int KC>
  static __device__ __forceinline__ void a_smem_b_nk(float (&acc)[MT][NT][4],
                                                     const T* a, int lda,
                                                     const T* b, int ldb) {
    static_assert(NT % 2 == 0, "B tiles load in pairs");
    const int lane = threadIdx.x & 31;
    const uint32_t a_addr =
        smem_u32(a + (lane & 15) * lda + (lane >> 4) * 8);
    const uint32_t b_addr = smem_u32(
        b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], a_addr + (i * 16 * lda + k) * 2);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, b_addr + (n * 8 * ldb + k) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][n], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][n + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  // P rounds to bf16 once (SPLIT: P = hi + lo, the small product first),
  // then the product accumulates in fp32.
  template <int MT, int NS, int NT, bool SPLIT = false>
  static __device__ __forceinline__ void a_frag_b_kn(
      float (&acc)[MT][NT][4], const float (&p)[MT][NS][4], const T* b,
      int ldb) {
    static_assert(NS % 2 == 0 && NT % 2 == 0, "k16 steps, B tiles in pairs");
    const int lane = threadIdx.x & 31;
    const uint32_t b_addr = smem_u32(
        b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t af[MT][4], lo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* x = p[i][2 * j + (e >> 1)] + 2 * (e & 1);
          if (SPLIT)
            split_bf16(x[0], x[1], af[i][e], lo[i][e]);
          else
            af[i][e] = pack_bf16(x[0], x[1]);
        }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, b_addr + (j * 16 * ldb + n * 8) * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (SPLIT) {
            mma_bf16(acc[i][n], lo[i], bf[0], bf[1]);
            mma_bf16(acc[i][n + 1], lo[i], bf[2], bf[3]);
          }
          mma_bf16(acc[i][n], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][n + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
};

template <>
struct MmaRows<float> {
  using T = float;

  // The two small terms go to their own accumulator, added at the end:
  // twice the independent chains of the large one alone.
  template <int MT, int NT, int KC>
  static __device__ __forceinline__ void a_smem_b_nk(float (&acc)[MT][NT][4],
                                                     const T* a, int lda,
                                                     const T* b, int ldb) {
    static_assert(NT % 2 == 0, "B tiles load in pairs");
    const int lane = threadIdx.x & 31;
    const uint32_t a_addr =
        smem_u32(a + (lane & 15) * lda + (lane >> 4) * 4);
    const uint32_t b_addr = smem_u32(
        b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 4);
    float small[MT][NT][4];
    zero(small);
#pragma unroll
    for (int k = 0; k < KC; k += 8) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ar[4];
        ldsm_x4(ar, a_addr + (i * 16 * lda + k) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(ar[e]), a_hi[i][e], a_lo[i][e]);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t br[4], b_hi[4], b_lo[4];
        ldsm_x4(br, b_addr + (n * 8 * ldb + k) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(br[e]), b_hi[e], b_lo[e]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_tf32(small[i][n], a_lo[i], b_hi[0], b_hi[1]);
          mma_tf32(small[i][n], a_hi[i], b_lo[0], b_lo[1]);
          mma_tf32(acc[i][n], a_hi[i], b_hi[0], b_hi[1]);
          mma_tf32(small[i][n + 1], a_lo[i], b_hi[2], b_hi[3]);
          mma_tf32(small[i][n + 1], a_hi[i], b_lo[2], b_lo[3]);
          mma_tf32(acc[i][n + 1], a_hi[i], b_hi[2], b_hi[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][n][j] += small[i][n][j];
  }

  // The C fragment holds columns 2t and 2t + 1 of each 8-column tile, the
  // tf32 A fragment wants t and t + 4: the k index is permuted instead
  // (k = t reads column 2t, k = t + 4 reads 2t + 1), and B's rows with it,
  // so B comes by scalar loads of rows 2t and 2t + 1.
  template <int MT, int NS, int NT, bool SPLIT = true>
  static __device__ __forceinline__ void a_frag_b_kn(
      float (&acc)[MT][NT][4], const float (&p)[MT][NS][4], const T* b,
      int ldb) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        split_tf32(p[i][j][0], a_hi[i][0], a_lo[i][0]);  // row g,     k = t
        split_tf32(p[i][j][2], a_hi[i][1], a_lo[i][1]);  // row g + 8, k = t
        split_tf32(p[i][j][1], a_hi[i][2], a_lo[i][2]);  // row g, k = t + 4
        split_tf32(p[i][j][3], a_hi[i][3], a_lo[i][3]);  // row g + 8, t + 4
      }
      const T* b0 = b + (j * 8 + 2 * t) * ldb + g;
      const T* b1 = b0 + ldb;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(b0[n * 8], b0_hi, b0_lo);
        split_tf32(b1[n * 8], b1_hi, b1_lo);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_3xtf32(acc[i][n], a_hi[i], a_lo[i], b0_hi, b1_hi, b0_lo, b1_lo);
      }
    }
  }
};

// ---- row operations on C fragments ------------------------------------------

// Max and sum over the 4 lanes (a quad) that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Column (0..8 * NT) of element j of n-tile n in this lane's fragment.
__device__ __forceinline__ int frag_col(int n, int j) {
  return n * 8 + 2 * (threadIdx.x & 3) + (j & 1);
}

// ---- column split: partial products summed across a row group's warps -------
//
// When CS warps share a row group, each computes a score-like product over
// its own CS-th of the head dimension. `xch_put` writes the partial to the
// warp's slot of `xch` ([CS][M * N * 4][32] floats per row group),
// `row_sync` waits for the row group, and `xch_sum` adds the CS partials in
// slot order, so every warp of the row group holds bit-identical sums.

template <int M, int N>
__device__ __forceinline__ void xch_put(float* slot,
                                        const float (&x)[M][N][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        slot[((i * N + n) * 4 + j) * 32 + lane] = x[i][n][j];
}

template <int CS, int M, int N>
__device__ __forceinline__ void xch_sum(const float* group,
                                        float (&x)[M][N][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = ((i * N + n) * 4 + j) * 32 + lane;
        float s = group[at];
#pragma unroll
        for (int c = 1; c < CS; ++c) s += group[c * M * N * 4 * 32 + at];
        x[i][n][j] = s;
      }
}

// Named barrier `id` (1..15) over `threads` threads of the block.
__device__ __forceinline__ void row_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y);

template <>
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <>
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                          float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- host: the layout check and the launch of a tile kernel -----------------

// What an entry point returns, launching nothing, when an input's rows do
// not all start on 16 bytes (the staging copies move 16-byte chunks); the
// wrapper raises on it. CUDA error codes are never negative.
constexpr int kMisaligned = -1;

// True when every row of a [B, S, H, d] tensor at `base` (element strides
// sb, ss, sh; the last axis contiguous) starts on a 16-byte boundary. An
// axis of length 1 is never stepped along, whatever its stride.
inline bool rows_aligned(const void* base, int64_t sb, int64_t ss,
                         int64_t sh, int B, int S, int H, int64_t elem) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         (B == 1 || sb * elem % 16 == 0) && (S == 1 || ss * elem % 16 == 0) &&
         (H == 1 || sh * elem % 16 == 0);
}
//
// Raises `kernel`'s dynamic shared-memory limit to `max_smem` once per
// device: `raised` (one per kernel) holds a bit for each device done, as
// the small main-path shapes are bound by the launch's host time.
template <typename K>
cudaError_t raise_smem_limit(K* kernel, size_t max_smem,
                             std::atomic<unsigned>& raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_smem));
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

// One CTA per tile of `group_rows` * groups owned rows (of `owned`: the
// query rows for the forward and dQ, the kv rows for dK/dV; groups = RG, or
// fewer when `owned` is small: the U-Net's S = 16 takes one 16-row tile) per
// (batch, head), `smem_bytes(groups)` of dynamic shared memory, the
// kernel's limit raised to `max_smem` (`raise_smem_limit`).
template <typename P>
cudaError_t launch_tiles(void (*kernel)(P), const P& p, cudaStream_t stream,
                         int owned, int group_rows, int RG, int CS,
                         size_t max_smem, size_t (*smem_bytes)(int),
                         std::atomic<unsigned>& raised) {
  const cudaError_t err = raise_smem_limit(kernel, max_smem, raised);
  if (err != cudaSuccess) return err;
  const int groups =
      owned < group_rows * RG ? (owned + group_rows - 1) / group_rows : RG;
  const int rows = group_rows * groups;
  const dim3 grid((owned + rows - 1) / rows, p.B * p.H);
  kernel<<<grid, 32 * groups * CS, smem_bytes(groups), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash_tc
