// Group-aware weight stream of the grouped and ragged ftIMM kernels and
// their SwiGLU pairs for Hopper (sm_90a): the MoE decode body ("stream").
// bf16 x bf16, at most NT = 16 token rows per group, each group against its
// own weight panel, or its two (PANELS = 2: the gate and up panels of the
// SwiGLU pair, silu(x . Wg) * (x . Wu)).
//
// What bounds it: at decode every weight byte feeds 16 FMAs at most (16
// rows) -- far below the card's ~295 bf16 FLOP/byte ridge -- so the panels'
// bytes over 3.35 TB/s are the bound: mixtral's capacity dispatch reads all
// 8 expert-down panels (939.5 MB a launch, 0.28 ms), llama4's top-1 routing
// at most 4 of 16 (335.5 MB, 0.10 ms).  The FMA body reached 10-13 % of it;
// a register stream (ftimm_gemm's "stream") reads N-contiguous panels at
// about 1.6 TB/s.  So the design is about bytes in flight, not math:
//
//   * The grid is (128-column N strip, K slice, group).  A CTA of 5 warps:
//     one thread of warp 4 issues TMA copies of (64 K x 128 N) weight boxes
//     and the group's (64 K x 16 rows) activation box into a 4-stage ring
//     (18 KB a stage, the 128-byte swizzle wgmma reads); the copies' bytes
//     stay in flight without holding registers.
//   * The consumer warpgroup (warps 0-3) multiplies with the operands
//     swapped, C^T (128 N x 16 tokens) = W^T . X^T: each 64-column half of
//     the weight box is the 64-row A operand of wgmma.m64n16k16 (MN-major
//     for an N-contiguous "nn" panel, K-major for an "nt" one, the
//     descriptors of ftimm_tc.cuh), the tokens the 16-wide B operand.  At 16
//     rows a CUDA-core consumer would need about 90 % of an SM's FMA rate
//     to keep up with its share of 3.35 TB/s; measured on the H100 one was
//     2.8x slower than this, and an 8-stage ring no faster than 4 (PERF.md).
//   * Groups: the grouped kernel's group g is rows [g*M, g*M + M) of A
//     (a rank-3 map) or a shared 2-D A; the ragged kernel's is rows
//     [offsets[g], offsets[g+1]) of the flat x, read from the device by the
//     CTA -- no host sync, no visit list.  A CTA whose group is empty returns
//     before its first load, so only the reached panels are read.  Token
//     columns past a group's rows (the next group's rows, or TMA's zero fill
//     past the tensor) only reach output columns that are not stored: the
//     product's columns are independent.  A rank-3 weight map zero-fills
//     each panel's K edge.
//   * Slices without atomics: with more than one K slice each CTA writes its
//     fp32 partial to a workspace; the last CTA of a (group, strip) to
//     arrive (a counter, which it resets) sums the partials in slice order
//     and applies the epilogue, so reruns are bit-identical.  Each output
//     row has exactly one writer; the ragged kernel's extra z slot writes
//     zeros to the rows no group owns.
//   * The pair (PANELS = 2): each stage holds the Wg box, the Wu box at the
//     same (k0, n0) and the x box (34 KB; 4 stages and the staging tiles
//     make one 154 KB CTA an SM, 136 KB of weights in flight), and the
//     warpgroup keeps one accumulator set per panel.  Both sets have the
//     same fragment layout, so with one K slice silu(g) * u is formed in
//     registers.  SiLU is not linear: with several slices each CTA writes
//     both fp32 partials, and the last CTA sums g and u separately, in slice
//     order, before it forms silu(g) * u.  The pair takes no epilogue, as in
//     the reference.
#pragma once

#include "ftimm_tc.cuh"

namespace ftimm {
namespace gs {

constexpr int STRIP = 128;  // output columns of one CTA: two 64-row wgmma A blocks
constexpr int NT = 16;      // token rows of a group (the wgmma's n)
constexpr int BK = 64;
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int W_BYTES = STRIP * BK * 2;  // 16 KB
constexpr int X_BYTES = NT * BK * 2;     // 2 KB
constexpr int PITCH = STRIP + 4;         // fp32 staging row pitch
constexpr int STAGES = 4;                // kernel.py's GSTREAM_STAGES
constexpr int STAGING = NT * PITCH * 4;  // one panel's fp32 (NT, STRIP) tile

// The shared memory of one CTA streaming PANELS weight panels (kernel.py's
// gstream_smem): the ring, a staging tile per panel, the barriers, and
// slack to align the ring to 1024 bytes by hand.
template <int PANELS>
struct Ring {
  static constexpr int STAGE_BYTES = PANELS * W_BYTES + X_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM = BYTES + PANELS * STAGING + 16 * STAGES + 1024;
  static_assert(STAGE_BYTES % 1024 == 0, "stages stay aligned to the 128-byte swizzle's 1 KB");
};

struct Args {
  void* c;             // output rows (grouped: (G, M, N); ragged: (T, N))
  float* ws;           // (slices, PANELS, rows, N) fp32 partials when gridDim.y > 1
  int* counters;       // G x strips, 0 between launches
  const int* offsets;  // ragged: (G + 1,) device prefix sums; grouped: null
  int G, M, T, N, K;   // M: rows of a group (grouped); T: output rows
  int slice;           // K rows of one slice, a multiple of 64
  int x3d, w3d;        // the operand's map is rank 3 (read at the group)
  EpiArgs epi;
};

// D(64 x 16, fp32) += A(64 x 16) . B(16 x 16); TA = 1: A is MN-major.
template <int TA>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// The output value of one (row, column) from the fp32 sums of each panel.
template <int PANELS, typename TC>
__device__ __forceinline__ TC flush_value(const float (&v)[PANELS], const Args& p, int g, int erow,
                                          int n) {
  if constexpr (PANELS == 2) {
    return from_f<TC>(silu_mul(v[0], v[1]));
  } else {
    return from_f<TC>(apply_epi<__nv_bfloat16>(v[0], p.epi, g, erow, n, p.N));
  }
}

// Tag: the calling kernel's own type, so that each kernel's stream has its
// own symbol (and name in a profile).  tu: the up panels' map (PANELS = 2).
template <class Tag, bool W_MN, typename TC, int PANELS>
__global__ void __launch_bounds__(THREADS)
    group_stream_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap tu, Args p) {
  using R = Ring<PANELS>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const int tid = threadIdx.x, g = blockIdx.z, strip = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y, n0 = strip * STRIP;
  TC* c = static_cast<TC*>(p.c);

  // This group's rows: output rows row0 .. row0 + rows - 1.
  int rows, row0;
  if (p.offsets != nullptr) {
    const int lo_all = min(max(p.offsets[0], 0), p.T);
    const int hi_all = min(max(p.offsets[p.G], lo_all), p.T);
    if (g == p.G) {  // the zero-fill slot: rows no group owns, once per strip
      if (s != 0) return;
      for (int i = tid; i < p.T * STRIP; i += THREADS) {
        const int t = i / STRIP, n = n0 + i % STRIP;
        if (n < p.N && (t < lo_all || t >= hi_all)) c[(int64_t)t * p.N + n] = from_f<TC>(0.f);
      }
      return;
    }
    const int lo = min(max(p.offsets[g], 0), p.T);
    const int hi = min(max(p.offsets[g + 1], lo), p.T);
    row0 = lo;
    rows = min(hi - lo, NT);
  } else {
    row0 = g * p.M;
    rows = p.M;
  }
  if (rows <= 0) return;  // an empty group reads no panel

  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw + pad;
  float* stage = reinterpret_cast<float*>(smem + R::BYTES);
  const uint32_t full0 = ring + R::BYTES + PANELS * STAGING;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int k_lo = s * p.slice, k_hi = min(p.K, k_lo + p.slice);
  const int ktiles = k_hi > k_lo ? cdiv(k_hi - k_lo, BK) : 0;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      tc::mbar_init(full0 + 8 * st, 1);
      tc::mbar_init(empty0 + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == CONSUMERS) {
      const int xrow = p.offsets != nullptr ? row0 : 0;
      const int xg = p.x3d ? g : -1, wg = p.w3d ? g : -1;
      for (int it = 0; it < ktiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) tc::mbar_wait(empty0 + 8 * st, ((it / STAGES) - 1) & 1);
        const uint32_t fb = full0 + 8 * st, sw = ring + st * R::STAGE_BYTES;
        const int k0 = k_lo + it * BK;
        tc::mbar_expect_tx(fb, R::STAGE_BYTES);
#pragma unroll
        for (int q = 0; q < PANELS; ++q) {
          const CUtensorMap* map = q == 0 ? &tw : &tu;
          const uint32_t dst = sw + q * W_BYTES;
          if (W_MN) {
            tc::tma_box(dst, map, fb, n0, k0, wg);
            tc::tma_box(dst + tc::BLOCK_BYTES, map, fb, n0 + 64, k0, wg);
          } else {
            tc::tma_box(dst, map, fb, k0, n0, wg);
          }
        }
        tc::tma_box(sw + PANELS * W_BYTES, &tx, fb, k0, xrow, xg);
      }
    }
  } else {
    // ---- consumer warpgroup: C^T = W^T . X^T on the tensor cores ----
    // acc[q][h]: panel q, 64-column half h of the strip.
    float acc[PANELS][2][8];
#pragma unroll
    for (int q = 0; q < PANELS; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q][h][i] = 0.f;
    for (int it = 0; it < ktiles; ++it) {
      const int st = it % STAGES;
      tc::mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      const uint32_t sw = ring + st * R::STAGE_BYTES, sx = sw + PANELS * W_BYTES;
#pragma unroll
      for (int q = 0; q < PANELS; ++q) {
        tc::fence_regs(acc[q][0]);
        tc::fence_regs(acc[q][1]);
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = tc::smem_desc(sx + kk * 32, 16, 1024);
#pragma unroll
        for (int q = 0; q < PANELS; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t blk = sw + q * W_BYTES + h * tc::BLOCK_BYTES;
            const uint64_t da = W_MN ? tc::smem_desc(blk + kk * 2048, tc::BLOCK_BYTES, 1024)
                                     : tc::smem_desc(blk + kk * 32, 16, 1024);
            wgmma_m64n16k16<W_MN ? 1 : 0>(acc[q][h], da, db);
          }
      }
      tc::wgmma_commit();
#pragma unroll
      for (int q = 0; q < PANELS; ++q) {
        tc::fence_regs(acc[q][0]);
        tc::fence_regs(acc[q][1]);
      }
      tc::wgmma_wait<1>();  // the previous step's group has retired: release its slot
      if (it > 0) tc::mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < PANELS; ++q) {
      tc::fence_regs(acc[q][0]);
      tc::fence_regs(acc[q][1]);
    }
    // Fragment (row = N column, column = token) -> staging [token][column]:
    // with one slice the pair's silu(g) * u (the panels' fragments share a
    // layout), else each panel's fp32 sum in its own tile.
    const bool fuse = PANELS == 2 && S == 1;
    const int lane = tid % 32, wi = tid / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int nl = h * 64 + wi * 16 + lane / 4 + 8 * half;
            const int t = j * 8 + 2 * (lane % 4) + e, i = j * 4 + 2 * half + e;
            if (fuse) {
              stage[t * PITCH + nl] = silu_mul(acc[0][h][i], acc[PANELS - 1][h][i]);
            } else {
#pragma unroll
              for (int q = 0; q < PANELS; ++q) stage[q * NT * PITCH + t * PITCH + nl] = acc[q][h][i];
            }
          }
  }
  __syncthreads();  // the staging tiles are complete

  // Epilogue rows: the grouped residual is indexed within the group.
  const int erow0 = p.offsets != nullptr ? row0 : 0;
  if (S == 1) {
    for (int i = tid; i < rows * STRIP; i += THREADS) {
      const int t = i / STRIP, nl = i % STRIP, n = n0 + nl;
      if (n >= p.N) continue;
      const float v = stage[t * PITCH + nl];  // the pair: silu(g) * u already
      c[(int64_t)(row0 + t) * p.N + n] =
          PANELS == 2 ? from_f<TC>(v)
                      : from_f<TC>(apply_epi<__nv_bfloat16>(v, p.epi, g, erow0 + t, n, p.N));
    }
    return;
  }
  for (int i = tid; i < PANELS * rows * STRIP; i += THREADS) {
    const int q = i / (rows * STRIP), r = i % (rows * STRIP);
    const int t = r / STRIP, nl = r % STRIP, n = n0 + nl;
    if (n < p.N)
      p.ws[(((int64_t)s * PANELS + q) * p.T + row0 + t) * p.N + n] =
          stage[q * NT * PITCH + t * PITCH + nl];
  }
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (int64_t)g * gridDim.x + strip;
  if (tid == 0) last = atomicAdd(counter, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * STRIP; i += THREADS) {
    const int t = i / STRIP, n = n0 + i % STRIP;
    if (n >= p.N) continue;
    float v[PANELS];
#pragma unroll
    for (int q = 0; q < PANELS; ++q) {  // each panel summed alone, in slice order
      v[q] = 0.f;
      for (int sl = 0; sl < S; ++sl)
        v[q] += __ldcg(&p.ws[(((int64_t)sl * PANELS + q) * p.T + row0 + t) * p.N + n]);
    }
    c[(int64_t)(row0 + t) * p.N + n] = flush_value<PANELS, TC>(v, p, g, erow0 + t, n);
  }
  if (tid == 0) *counter = 0;
}

// Launch the kernel of (weight layout, output type, panels) with the grid
// (strips, slices, groups); 0 or the CUDA error.
template <class Tag, bool W_MN, typename TC, int PANELS>
static int launch_one(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& tu,
                      const Args& p, int slices, int zslots, cudaStream_t stream) {
  auto kernel = group_stream_kernel<Tag, W_MN, TC, PANELS>;
  constexpr int smem = Ring<PANELS>::SMEM;
  const cudaError_t err = tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(p.N, STRIP), slices, zslots);
  kernel<<<grid, THREADS, smem, stream>>>(tx, tw, tu, p);
  return (int)cudaGetLastError();
}

template <class Tag, typename TC, int PANELS>
static int launch_layout(int w_mn, const CUtensorMap& tx, const CUtensorMap& tw,
                         const CUtensorMap& tu, const Args& p, int slices, int zslots,
                         cudaStream_t s) {
  if (w_mn) return launch_one<Tag, true, TC, PANELS>(tx, tw, tu, p, slices, zslots, s);
  return launch_one<Tag, false, TC, PANELS>(tx, tw, tu, p, slices, zslots, s);
}

// Encode the maps and launch.  A: x rows (R_x rows of K, K-major, groups
// s_xg apart or 0 = one flat / shared operand); W: op(W)(n, k) = w[n * s_wn
// + k * s_wk], groups s_wg apart; PANELS = 2: the up panels wu with W's
// strides, and ws holds (slices, 2, rows, N).  Returns
// cudaErrorInvalidValue for what the body does not take (kernel.py's
// grouped_bodies / ragged_bodies rule).
template <class Tag, int PANELS = 1>
static inline int launch(int types, const void* x, int64_t R_x, int64_t s_xg, int64_t s_xm,
                         int64_t s_xk, const void* w, const void* wu, int64_t s_wg,
                         int64_t s_wk, int64_t s_wn, Args p, int slices, int zslots,
                         cudaStream_t s) {
  const int64_t rows = p.offsets != nullptr ? p.T : p.M;
  if (rows > NT || slices < 1 || slices > 65535 || p.slice % BK != 0 ||
      (int64_t)p.slice * (slices - 1) >= p.K || zslots > 65535 ||
      (slices > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, tu;
  const int64_t gx = s_xg != 0 ? p.G : 1, gw = s_wg != 0 ? p.G : 1;
  if (tc::encode_operand(&tx, x, R_x, p.K, s_xm, s_xk, NT, gx, s_xg) != 0)
    return (int)cudaErrorInvalidValue;
  const int w_mn = tc::encode_operand(&tw, w, p.N, p.K, s_wn, s_wk, STRIP, gw, s_wg);
  if (w_mn < 0) return (int)cudaErrorInvalidValue;
  tu = tw;
  if (PANELS == 2 &&
      tc::encode_operand(&tu, wu, p.N, p.K, s_wn, s_wk, STRIP, gw, s_wg) != w_mn)
    return (int)cudaErrorInvalidValue;
  p.x3d = gx > 1;
  p.w3d = gw > 1;
  if (types == 0)
    return launch_layout<Tag, __nv_bfloat16, PANELS>(w_mn, tx, tw, tu, p, slices, zslots, s);
  if (types == 1) return launch_layout<Tag, float, PANELS>(w_mn, tx, tw, tu, p, slices, zslots, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gs
}  // namespace ftimm
