// Tensor-core body of the ftIMM GEMM kernels for Hopper (sm_90a): bf16 x
// bf16 operands, fp32 accumulators, any mix of K-major and MN-major layouts.
//
// One CTA of 384 threads owns one 128 x BN output tile (BN = 128 or 256):
//
//   * warpgroup 2 is the producer.  One of its threads walks K in 64-wide
//     steps and issues TMA copies of the A (128 x 64) and B (64 x BN) boxes
//     into a STAGES-deep ring of shared-memory slots, with the 128-byte
//     swizzle that wgmma reads without bank conflicts.  Each slot has a
//     "full" mbarrier (the copies' bytes arrived) and an "empty" one (both
//     consumer warpgroups finished reading it).
//   * warpgroups 0 and 1 are the consumers: warpgroup w owns rows
//     64w .. 64w + 63 of the tile and issues wgmma.mma_async
//     m64n128k16.f32.bf16.bf16 (one or two per 16-deep K slice, by BN)
//     straight from the swizzled slots.  A slot is released as soon as the
//     wgmma group that read it has retired (wait_group 1), so the copies of
//     the next STAGES - 1 steps stay in flight behind the math.
//
// Layouts.  An operand is either K-major (K has unit stride: A (M, K)
// row-major, B (N, K) row-major) or MN-major (M or N has unit stride).  The
// tensor map of a K-major operand reads a (64 K x rows) box, one 128-byte
// swizzled line per row; an MN-major operand is read as 64-wide blocks of
// (64 MN x 64 K), one line per K row, each block 8 KB.  The wgmma
// descriptor (start address, leading and stride byte offsets, 128-byte
// swizzle) and the instruction's transpose flag say which; nn, tn and nt,
// and transposed views of any of them, all reach this one body.
//
// Edges.  TMA fills a box's elements past the tensor's extent with zeros on
// both operands, so M, N and K need not be tile multiples and no 0 x NaN
// product can occur.  The ragged dW walks a window [k_lo, k_hi) of the rows;
// the rows of its last step past k_hi belong to the next group and are
// zeroed in shared memory on both operands before the wgmma reads them
// (mask_tail).
//
// Epilogue.  At the flush the consumers write their fp32 accumulators into
// a staging tile that reuses the ring; then each of the 256 consumer
// threads takes 16 bytes of outputs at a time, applies the reference's
// epilogue to the fp32 values (scale_vec -> scale -> bias -> act ->
// residual, apply_epi), casts, and stores one 16-byte vector (scalar
// stores only where a row's end is not 16-byte aligned or past N).
//
// The SwiGLU pair (PAIR, a Tile<256, ...>): the second 128-column half of
// each stage's B box comes from the up panels' map at the same n0, not from
// B's at n0 + 128, so the two accumulator halves hold g = x . Wg and u =
// x . Wu at the same (row, column) of a 128 x 128 output tile.  The flush
// forms silu(g) * u in registers and stages only that tile.
//
// What the body cannot take: an operand without a unit-stride dimension,
// with a base not 16-byte aligned, or with its other stride not a multiple
// of 16 bytes.  kernel.py's rule (tma_major) sends such operands to the FMA
// body before the launch; encode_operand below refuses them too.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only: nothing is linked)

#include "ftimm_common.cuh"

namespace ftimm {
namespace tc {

constexpr int BM = 128, BK = 64;
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int BLOCK_BYTES = 64 * 128;     // one 64-line x 128-byte swizzle block

template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BN = BN_, STAGES = STAGES_, NH = BN / 128;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // The flush stages the fp32 (BM, BN) tile, rows padded by 8 floats
  // (16-byte aligned rows, conflict-free fragment writes), in the ring.
  static constexpr int STAGING = BM * (BN + 8) * 4;
  static constexpr int BODY = RING > STAGING ? RING : STAGING;
  // + the barriers, + slack to align the ring to 1024 bytes by hand.
  static constexpr int SMEM = BODY + 16 * STAGES + 1024;
  static_assert(BN % 128 == 0, "BN is a multiple of the wgmma width 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same copy from a rank-3 map: c2 is the group.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A box of an operand's map at (c0, c1), at group g of a rank-3 map when
// g >= 0.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                        int c1, int g) {
  if (g >= 0) {
    tma_load3(dst, map, bar, c0, c1, g);
  } else {
    tma_load(dst, map, bar, c0, c1);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  For a K-major operand
// the stride byte offset is the 1024 bytes between 8-row groups (the
// leading offset is unused); for an MN-major one the leading offset is the
// distance between 64-wide MN blocks and the stride offset the 1024 bytes
// between groups of 8 K rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 256 consumer threads only (the producer warpgroup has left).
template <int ID>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(CONSUMERS) : "memory");
}

// D(64 x 128, fp32) += A(64 x 16) . B(16 x 128); TA_ / TB_ = 1: MN-major.
template <int TA_, int TB_>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA_), "n"(TB_));
}

// 16 bytes of outputs from VEC fp32 values.
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  uint4 r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return r;
}

// Zero lines keep .. 63 (the K rows past the window) of every 64-line block
// of one ring slot: both MN-major operands, 2 A blocks then BN / 64 B blocks.
template <class T>
__device__ __forceinline__ void zero_tail(unsigned char* slot, int keep) {
  constexpr int BLOCKS = 2 + T::BN / 64;
  const int lines = BK - keep;
  for (int i = threadIdx.x; i < BLOCKS * lines * 8; i += CONSUMERS) {
    const int blk = i / (lines * 8), rem = i % (lines * 8);
    reinterpret_cast<uint4*>(slot + blk * BLOCK_BYTES + (keep + rem / 8) * 128)[rem % 8] =
        make_uint4(0, 0, 0, 0);
  }
}

// One 128 x BN tile: C[m0:, n0:] = epi(op(A)[m0:, k_lo:k_hi] . op(B)[k_lo:k_hi, n0:]).
// A's tensor map is read at coordinates {k, m} (K-major) or {m, k}
// (MN-major), B's at {k, n} or {n, k}, and at group ga / gb of a rank-3
// map when that is >= 0 (the grouped and ragged kernels: TMA then
// zero-fills each group's K edge).  Rows m >= M are not stored.  Every
// thread of the CTA calls it.  PAIR: tu is the up panels' map, read as B's
// (K-major boxes of 128 rows); the tile stores silu(g) * u, 128 columns.
template <class T, bool A_MN, bool B_MN, typename TR, typename TC, bool PAIR = false>
__device__ __forceinline__ void run_tile(const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                         int n0, int k_lo, int k_hi, bool mask_tail,
                                         TC* __restrict__ c, int64_t ldc, int M, int N,
                                         const EpiArgs& epi, int g, int ga = -1, int gb = -1,
                                         const CUtensorMap* tu = nullptr) {
  static_assert(!PAIR || T::NH == 2, "the pair holds g and u in the tile's two halves");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t full0 = ring + T::BODY;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const int tid = threadIdx.x;
  const int ktiles = k_hi > k_lo ? cdiv(k_hi - k_lo, BK) : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS) {
      for (int it = 0; it < ktiles; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(empty0 + 8 * s, ((it / T::STAGES) - 1) & 1);
        const uint32_t fb = full0 + 8 * s;
        const uint32_t sa = ring + s * T::STAGE_BYTES, sb = sa + T::A_BYTES;
        const int k0 = k_lo + it * BK;
        mbar_expect_tx(fb, T::STAGE_BYTES);
        if (A_MN) {
          tma_box(sa, ta, fb, m0, k0, ga);
          tma_box(sa + BLOCK_BYTES, ta, fb, m0 + 64, k0, ga);
        } else {
          tma_box(sa, ta, fb, k0, m0, ga);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < T::BN / 64; ++j)
            tma_box(sb + j * BLOCK_BYTES, PAIR && j >= 2 ? tu : tb, fb,
                    n0 + 64 * (PAIR ? j % 2 : j), k0, gb);
        } else if (PAIR) {
          tma_box(sb, tb, fb, k0, n0, gb);
          tma_box(sb + 128 * 128, tu, fb, k0, n0, gb);
        } else {
          tma_box(sb, tb, fb, k0, n0, gb);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on the ring, then the flush ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = tid / 128;
    float acc[T::NH][64];
#pragma unroll
    for (int h = 0; h < T::NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    for (int it = 0; it < ktiles; ++it) {
      const int s = it % T::STAGES;
      mbar_wait(full0 + 8 * s, (it / T::STAGES) & 1);
      const uint32_t sa = ring + s * T::STAGE_BYTES, sb = sa + T::A_BYTES;
      if (mask_tail) {
        const int keep = k_hi - (k_lo + it * BK);
        if (keep < BK) {
          zero_tail<T>(smem + s * T::STAGE_BYTES, keep);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          consumer_sync<2>();
        }
      }
#pragma unroll
      for (int h = 0; h < T::NH; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = A_MN ? smem_desc(sa + w * BLOCK_BYTES + kk * 2048, BLOCK_BYTES, 1024)
                                 : smem_desc(sa + w * BLOCK_BYTES + kk * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < T::NH; ++h) {
          const uint64_t db = B_MN
                                  ? smem_desc(sb + h * 2 * BLOCK_BYTES + kk * 2048, BLOCK_BYTES, 1024)
                                  : smem_desc(sb + h * 128 * 128 + kk * 32, 16, 1024);
          wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[h], da, db);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int h = 0; h < T::NH; ++h) fence_regs(acc[h]);
      wgmma_wait<1>();  // the previous step's group has retired: release its slot
      if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % T::STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < T::NH; ++h) fence_regs(acc[h]);

    // Flush: stage the fp32 accumulators, then each thread takes 16 bytes
    // of outputs at a time: the epilogue, the cast, one vector store.
    consumer_sync<1>();  // both warpgroups are done reading the ring
    constexpr int OUT_N = PAIR ? 128 : T::BN;  // the tile's output columns
    constexpr int P = OUT_N + 8;
    float* stage = reinterpret_cast<float*>(smem);
    const int lane = tid % 32, wi = (tid % 128) / 32;
#pragma unroll
    for (int h = 0; h < OUT_N / 128; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = w * 64 + wi * 16 + lane / 4 + 8 * half;
          const int cl = h * 128 + j * 8 + 2 * (lane % 4);
          const int i = j * 4 + 2 * half;
          *reinterpret_cast<float2*>(stage + rl * P + cl) =
              PAIR ? make_float2(silu_mul(acc[0][i], acc[T::NH - 1][i]),
                                 silu_mul(acc[0][i + 1], acc[T::NH - 1][i + 1]))
                   : make_float2(acc[h][i], acc[h][i + 1]);
        }
    consumer_sync<1>();
    constexpr int VEC = 16 / (int)sizeof(TC);
    constexpr int CHUNKS = OUT_N / VEC;
    const bool vec_ok = (ldc % VEC == 0) && (reinterpret_cast<uintptr_t>(c) % 16 == 0);
    const bool has_epi = epi.scale_vec || epi.has_scale || epi.bias || epi.act || epi.residual;
#pragma unroll 1
    for (int i = tid; i < BM * CHUNKS; i += CONSUMERS) {
      const int rl = i / CHUNKS, cl = (i % CHUNKS) * VEC;
      const int row = m0 + rl, col = n0 + cl;
      if (row >= M || col >= N) continue;
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(v + e) = *reinterpret_cast<const float4*>(stage + rl * P + cl + e);
      if (has_epi) {
#pragma unroll 1
        for (int e = 0; e < VEC; ++e)
          if (col + e < N) v[e] = apply_epi<TR>(v[e], epi, g, row, col + e, N);
      }
      TC* dst = c + (int64_t)row * ldc + col;
      if (vec_ok && col + VEC <= N) {
        *reinterpret_cast<uint4*>(dst) = pack16(v);
      } else {
        for (int e = 0; e < VEC && col + e < N; ++e) dst[e] = from_f<TC>(v[e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against nothing but the CUDA runtime.
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one bf16 operand op(X)(r, k) = X[r * s_r + k * s_k] with
// R rows (M for A, N for B) and K columns.  Returns 0 when it is read
// K-major (box: 64 K x box_rows rows), 1 when MN-major (box: 64 rows x 64 K),
// -1 when TMA cannot take it.  The same rule as kernel.py's tma_major: K
// has unit stride first, else the rows; a 16-byte aligned base; the other
// stride a multiple of 8 elements and at least the unit-stride extent (a
// dimension of extent 1 takes any stride).  G > 1 groups G panels s_g
// elements apart into a rank-3 map (box depth 1), so that a box never
// reads one group's K rows into another's: s_g a multiple of 8 elements
// and at least one panel (kernel.py's tma_major3).
static inline int encode_operand(CUtensorMap* map, const void* base, int64_t R, int64_t K,
                                 int64_t s_r, int64_t s_k, int box_rows, int64_t G = 1,
                                 int64_t s_g = 0) {
  if (R < 1 || K < 1 || G < 1 || reinterpret_cast<uintptr_t>(base) % 16 != 0) return -1;
  int mn;
  cuuint64_t dims[3], stride[2];
  cuuint32_t box[3] = {0, 0, 1};
  int64_t outer_stride;
  if (s_k == 1) {
    mn = 0;
    dims[0] = K, dims[1] = R;
    outer_stride = R == 1 ? (K + 7) / 8 * 8 : s_r;
    box[0] = 64, box[1] = box_rows;
    if (outer_stride < K) return -1;
  } else if (s_r == 1) {
    mn = 1;
    dims[0] = R, dims[1] = K;
    outer_stride = K == 1 ? (R + 7) / 8 * 8 : s_k;
    box[0] = 64, box[1] = 64;
    if (outer_stride < R) return -1;
  } else {
    return -1;
  }
  if (outer_stride % 8 != 0) return -1;
  stride[0] = (cuuint64_t)outer_stride * 2;
  const int rank = G > 1 ? 3 : 2;
  if (rank == 3) {
    if (s_g % 8 != 0 || s_g < outer_stride * (int64_t)dims[1]) return -1;
    dims[2] = G;
    stride[1] = (cuuint64_t)s_g * 2;
  }
  const cuuint32_t estride[3] = {1, 1, 1};
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        stride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? mn : -1;
}

// Dynamic shared memory above 48 KB must be granted to each kernel.
template <class K>
static inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tc
}  // namespace ftimm
