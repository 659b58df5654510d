// ftIMM ragged fused SwiGLU pair for Hopper:
// out[o_g:o_{g+1}] = silu(x[o_g:o_{g+1}] . Wg_g) * (x[o_g:o_{g+1}] . Wu_g).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_ragged_swiglu:
// the capacity-free MoE gate/up projections, x (T, K) rows sorted by expert
// and cut into G groups by the device prefix sums `offsets` (G + 1,), against
// per-expert panels Wg, Wu (G, K, N), in one launch with no (T, N) fp32
// intermediates in device memory.  Rows outside every group come out as
// zeros, as in the reference.  The pair takes no epilogue.
//
// The grid and the row ownership are those of ftimm_gemm_ragged.cu (see
// there, and ftimm_common.cuh: ragged_chunk): each CTA walks its own group's
// rows from offsets[g], so every output row is written by exactly one CTA,
// without atomics, read-modify-write or host synchronisation, and the TPU
// kernel's in-order read-modify-write of shared row tiles is not needed.
//
// Three bodies, those of ftimm_gemm_ragged.cu with a second weight panel;
// the planner (plan_ragged_gemm with panels = 2) picks one among those the
// operands allow (kernel.py, ragged_bodies), from the number of rows:
//
// * Weight stream ("stream", ftimm_gemm_ragged_swiglu_stream_launch): bf16 x
//   bf16, T <= 16 rows in all, x K-major -- llama4-scout at decode (4
//   tokens, top-1): the gate and up panels of the experts the tokens reach,
//   at most 4 of 16, 2 x 4 x 5120 x 8192 bf16 = 0.67 GB, 0.20 ms at 3.35
//   TB/s.  The body of ftimm_gstream.cuh with PANELS = 2 and the grid (N
//   strip, K slice, group + 1): a CTA reads its group's offsets itself and
//   returns before its first load when the group is empty, so an expert with
//   no rows reads neither panel; the extra z slot zero-fills the rows no
//   group owns.
// * Tensor cores ("tc", ftimm_gemm_ragged_swiglu_tc_launch): bf16 x bf16, x
//   K-major and the panels TMA-readable -- prefill (256 rows) and training
//   (1024 routed rows).  The ragged chunks above, each CTA a 128 x 128
//   output tile of ftimm_tc.cuh's pair (Wg and Wu at the same n0 in the two
//   halves of a 128 x 256 stage, silu(g) * u formed in registers at the
//   flush) from its chunk's first row; x rows past the group's end only feed
//   output rows that are not stored, and the panels' 3-D maps zero-fill each
//   panel's K edge.
// * CUDA-core FMAs ("fma", ftimm_gemm_ragged_swiglu_launch): fp32 pairs and
//   operands TMA cannot read: ftimm_common.cuh's accumulate with two B
//   panels against one x chunk.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_gstream.cuh"
#include "ftimm_tc.cuh"

struct RaggedSwigluArgs {
  const void* x;
  const void* wg;
  const void* wu;
  const int* offsets;
  void* out;
  int T, N, K, G;
  int64_t sxm, sxk;
  int64_t swg, swk, swn;
};

template <class C, typename TA, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_ragged_swiglu_kernel(RaggedSwigluArgs p) {
  const ftimm::RaggedChunk r = ftimm::ragged_chunk(C::BM, C::BN, p.N, p.T, p.G, p.offsets);
  TC* out = static_cast<TC*>(p.out);
  if (r.g == p.G) {
    ftimm::ragged_zero_fill<C>(out, r, p.N, p.T, p.G, p.offsets);
    return;
  }
  if (r.rows <= 0) return;
  float acc[2][C::TM][C::TN];
  const TA* x = static_cast<const TA*>(p.x) + (int64_t)r.row0 * p.sxm;
  const TA* ws[2] = {static_cast<const TA*>(p.wg) + (int64_t)r.g * p.swg,
                     static_cast<const TA*>(p.wu) + (int64_t)r.g * p.swg};
  ftimm::accumulate<C, 2>(acc, x, p.sxm, p.sxk, ws, p.swk, p.swn, r.rows, p.N, p.K, 0, r.n0);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = r.n0 + tx + j * (C::BN / C::TN);
      if (row < r.rows && col < p.N)
        out[(int64_t)(r.row0 + row) * p.N + col] =
            ftimm::from_f<TC>(ftimm::silu_mul(acc[0][i][j], acc[1][i][j]));
    }
  }
}

template <class C, typename TA, typename TC>
static void launch(const RaggedSwigluArgs& p, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.T, C::BM) * ftimm::cdiv(p.N, C::BN), p.G + 1);
  ftimm_gemm_ragged_swiglu_kernel<C, TA, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const RaggedSwigluArgs& p, cudaStream_t stream) {
  switch (types) {
    case 0: launch<C, __nv_bfloat16, __nv_bfloat16>(p, stream); return true;
    case 1: launch<C, __nv_bfloat16, float>(p, stream); return true;
    case 2: launch<C, float, float>(p, stream); return true;
  }
  return false;
}

extern "C" int ftimm_gemm_ragged_swiglu_launch(int device, int tile, int types, const void* x,
                                               const void* wg, const void* wu,
                                               const int* offsets, void* out, int T, int N,
                                               int K, int G, long long sxm, long long sxk,
                                               long long swg, long long swk, long long swn,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RaggedSwigluArgs p{x, wg, wu, offsets, out, T, N, K, G, sxm, sxk, swg, swk, swn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (tile) {
#define FTIMM_TILE(ID, T) \
  case ID: ok = launch_types<T>(types, p, s); break;
    FTIMM_TILES(FTIMM_TILE)
#undef FTIMM_TILE
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core body
// ---------------------------------------------------------------------------

// The pair's tile (kernel.py's GROUP_TC_TILE, panels = 2): Wg and Wu at the
// same 128 output columns in the two halves of a 128 x 256 B stage, a
// 4-stage ring of 48 KB stages.
using PairTcTile = ftimm::tc::Tile<256, 4>;
constexpr int PAIR_N = 128;  // output columns of one tile

struct RaggedPairTcArgs {
  const int* offsets;
  void* out;
  int T, N, K, G;
  int w3d;  // the panels' maps are rank 3 (read at the group)
};

template <bool W_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_ragged_swiglu_tc_kernel(const __grid_constant__ CUtensorMap tx,
                                       const __grid_constant__ CUtensorMap tg,
                                       const __grid_constant__ CUtensorMap tu,
                                       RaggedPairTcArgs p) {
  const ftimm::RaggedChunk r =
      ftimm::ragged_chunk(ftimm::tc::BM, PAIR_N, p.N, p.T, p.G, p.offsets);
  TC* out = static_cast<TC*>(p.out);
  if (r.g == p.G) {  // zero-fill: rows of this chunk outside [offsets[0], offsets[G])
    const int lo = min(max(p.offsets[0], 0), p.T);
    const int hi = min(max(p.offsets[p.G], lo), p.T);
    for (int i = threadIdx.x; i < ftimm::tc::BM * PAIR_N; i += ftimm::tc::THREADS) {
      const int rl = i / PAIR_N, row = r.row0 + rl, col = r.n0 + i % PAIR_N;
      if (rl < r.rows && col < p.N && (row < lo || row >= hi))
        out[(int64_t)row * p.N + col] = ftimm::from_f<TC>(0.f);
    }
    return;
  }
  if (r.rows <= 0) return;
  ftimm::tc::run_tile<PairTcTile, false, W_MN, __nv_bfloat16, TC, true>(
      &tx, &tg, r.row0, r.n0, 0, p.K, false, out, p.N, r.row0 + r.rows, p.N, ftimm::EpiArgs{},
      r.g, -1, p.w3d ? r.g : -1, &tu);
}

template <bool W_MN, typename TC>
static int launch_tc(const CUtensorMap& tx, const CUtensorMap& tg, const CUtensorMap& tu,
                     const RaggedPairTcArgs& p, cudaStream_t stream) {
  auto kernel = ftimm_gemm_ragged_swiglu_tc_kernel<W_MN, TC>;
  constexpr int smem = PairTcTile::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.T, ftimm::tc::BM) * ftimm::cdiv(p.N, PAIR_N), p.G + 1);
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(tx, tg, tu, p);
  return (int)cudaGetLastError();
}

extern "C" int ftimm_gemm_ragged_swiglu_tc_launch(int device, int types, const void* x,
                                                  const void* wg, const void* wu,
                                                  const int* offsets, void* out, int T, int N,
                                                  int K, int G, long long sxm, long long sxk,
                                                  long long swg, long long swk, long long swn,
                                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G + 1 > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu;
  const int64_t gw = swg != 0 ? G : 1;
  if (ftimm::tc::encode_operand(&tx, x, T, K, sxm, sxk, ftimm::tc::BM) != 0)
    return (int)cudaErrorInvalidValue;
  const int w_mn = ftimm::tc::encode_operand(&tg, wg, N, K, swn, swk, PAIR_N, gw, swg);
  if (w_mn < 0 || ftimm::tc::encode_operand(&tu, wu, N, K, swn, swk, PAIR_N, gw, swg) != w_mn)
    return (int)cudaErrorInvalidValue;
  const RaggedPairTcArgs p{offsets, out, T, N, K, G, gw > 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0)
    return w_mn ? launch_tc<true, __nv_bfloat16>(tx, tg, tu, p, s)
                : launch_tc<false, __nv_bfloat16>(tx, tg, tu, p, s);
  if (types == 1)
    return w_mn ? launch_tc<true, float>(tx, tg, tu, p, s) : launch_tc<false, float>(tx, tg, tu, p, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight-stream body (T <= 16 rows)
// ---------------------------------------------------------------------------

// Names this kernel's stream instantiations (and their profile entries).
struct ftimm_gemm_ragged_swiglu_stream {};

extern "C" int ftimm_gemm_ragged_swiglu_stream_launch(
    int device, int types, const void* x, const void* wg, const void* wu, const int* offsets,
    void* out, int T, int N, int K, int G, long long sxm, long long sxk, long long swg,
    long long swk, long long swn, int slices, int slice, float* ws, int* counters,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ftimm::gs::Args p{out, ws, counters, offsets, G, 0, T, N, K, slice, 0, 0, ftimm::EpiArgs{}};
  return ftimm::gs::launch<ftimm_gemm_ragged_swiglu_stream, 2>(
      types, x, T, 0, sxm, sxk, wg, wu, swg, swk, swn, p, slices, G + 1,
      static_cast<cudaStream_t>(stream));
}
