// ftIMM fused SwiGLU pair for Hopper: out = silu(x . Wg) * (x . Wu).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_swiglu:
// a dense MLP's gate and up projections in one launch, with no (M, N) fp32
// intermediates in device memory.  The pair takes no epilogue, as in the
// reference.
//
// Three bodies; the planner (core/gemm/tuner.py, plan_gemm with panels = 2)
// picks one among those the operands allow (kernel.py, gemm_bodies):
//
// * Weight stream ("stream", ftimm_gemm_swiglu_stream_launch): bf16 x bf16,
//   at most 16 rows, x K-major -- qwen3-1.7b's decode (4 rows against two
//   2048 x 6144 panels).  About 1 FLOP per weight byte against the card's
//   ~295 bf16 FLOP/byte ridge, so the panels' bytes bound it: 2 x 2048 x
//   6144 bf16 = 50.3 MB, 15.0 us at 3.35 TB/s.  The body is the grouped
//   pair's (ftimm_gstream.cuh, PANELS = 2) with one group and x's group
//   stride 0: a TMA ring per (128-column strip, K slice) CTA whose stages
//   hold the Wg box, the Wu box at the same (k0, n0) and the x box,
//   wgmma.m64n16k16 with the panels as the 64-row operand.  N = 6144 is
//   only 48 strips, yet one K slice (48 CTAs, 2.31 TB/s) read the panels
//   faster on the H100 than 2-16 slices (PERF.md); with several, the
//   slices' partials are summed in slice order, each panel alone, before
//   silu(g) * u.
// * Tensor cores ("tc", ftimm_gemm_swiglu_tc_launch): bf16 x bf16, x K-major
//   and both panels TMA-readable -- the bucket prefills (128 / 256 rows) and
//   training (1024 rows: 2 x 25.8 GFLOP a launch, bound by the 989 TFLOP/s
//   of the tensor cores).  ftimm_tc.cuh's pair tile (run_tile with PAIR):
//   each 48 KB stage holds the x box and the Wg and Wu boxes at the same
//   128 output columns, two accumulator halves per consumer thread, silu(g)
//   * u formed in registers at the flush; 2-D maps, walked in dim_order.
// * CUDA-core FMAs ("fma", ftimm_gemm_swiglu_launch): fp32 pairs and
//   operands TMA cannot read.  ftimm_common.cuh's accumulate with two B
//   panels against one x panel: x is read half as often as two separate
//   GEMMs would read it, and the two fp32 accumulators per thread meet in
//   registers at the flush.  All three operands are masked on the K
//   remainder.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_gstream.cuh"
#include "ftimm_tc.cuh"

struct SwigluArgs {
  const void* x;
  const void* wg;
  const void* wu;
  void* out;
  int M, N, K;
  int64_t sxm, sxk, swk, swn;
};

template <class C, typename TA, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_swiglu_kernel(SwigluArgs p) {
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, 0, m0, n0);
  float acc[2][C::TM][C::TN];
  const TA* ws[2] = {static_cast<const TA*>(p.wg), static_cast<const TA*>(p.wu)};
  ftimm::accumulate<C, 2>(acc, static_cast<const TA*>(p.x), p.sxm, p.sxk, ws, p.swk, p.swn,
                          p.M, p.N, p.K, m0, n0);
  TC* out = static_cast<TC*>(p.out);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = m0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = n0 + tx + j * (C::BN / C::TN);
      if (row < p.M && col < p.N) {
        const float g = acc[0][i][j];
        out[(int64_t)row * p.N + col] =
            ftimm::from_f<TC>(g * (1.f / (1.f + expf(-g))) * acc[1][i][j]);
      }
    }
  }
}

template <class C, typename TA, typename TC>
static void launch(const SwigluArgs& p, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.M, C::BM) * ftimm::cdiv(p.N, C::BN));
  ftimm_gemm_swiglu_kernel<C, TA, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const SwigluArgs& p, cudaStream_t stream) {
  switch (types) {
    case 0: launch<C, __nv_bfloat16, __nv_bfloat16>(p, stream); return true;
    case 1: launch<C, __nv_bfloat16, float>(p, stream); return true;
    case 2: launch<C, float, float>(p, stream); return true;
  }
  return false;
}

extern "C" int ftimm_gemm_swiglu_launch(int device, int tile, int types, const void* x,
                                        const void* wg, const void* wu, void* out, int M,
                                        int N, int K, long long sxm, long long sxk,
                                        long long swk, long long swn, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SwigluArgs p{x, wg, wu, out, M, N, K, sxm, sxk, swk, swn};
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

// The pair's tile: a 128 x 256 B stage whose halves are Wg and Wu at the
// same 128 output columns (kernel.py's GROUP_TC_TILE, panels = 2), a
// 4-stage ring of 48 KB stages.
using PairTcTile = ftimm::tc::Tile<256, 4>;
constexpr int PAIR_N = 128;  // output columns of one tile

struct PairTcArgs {
  void* out;
  int M, N, K;
  int nm_order;
};

template <bool W_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_swiglu_tc_kernel(const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tg,
                                const __grid_constant__ CUtensorMap tu, PairTcArgs p) {
  int m0, n0;
  ftimm::tile_coords(ftimm::tc::BM, PAIR_N, p.M, p.N, p.nm_order, m0, n0);
  ftimm::tc::run_tile<PairTcTile, false, W_MN, __nv_bfloat16, TC, true>(
      &tx, &tg, m0, n0, 0, p.K, false, static_cast<TC*>(p.out), p.N, p.M, p.N,
      ftimm::EpiArgs{}, 0, -1, -1, &tu);
}

template <bool W_MN, typename TC>
static int launch_tc(const CUtensorMap& tx, const CUtensorMap& tg, const CUtensorMap& tu,
                     const PairTcArgs& p, cudaStream_t stream) {
  auto kernel = ftimm_gemm_swiglu_tc_kernel<W_MN, TC>;
  constexpr int smem = PairTcTile::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.M, ftimm::tc::BM) * ftimm::cdiv(p.N, PAIR_N));
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(tx, tg, tu, p);
  return (int)cudaGetLastError();
}

// x must be K-major (kernel.py's gemm_bodies rule for the pair); both
// panels share one layout.
extern "C" int ftimm_gemm_swiglu_tc_launch(int device, int types, const void* x, const void* wg,
                                           const void* wu, void* out, int M, int N, int K,
                                           long long sxm, long long sxk, long long swk,
                                           long long swn, int nm_order, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tg, tu;
  const int w_mn = ftimm::tc::encode_operand(&tg, wg, N, K, swn, swk, PAIR_N);
  if (ftimm::tc::encode_operand(&tx, x, M, K, sxm, sxk, ftimm::tc::BM) != 0 || w_mn < 0 ||
      ftimm::tc::encode_operand(&tu, wu, N, K, swn, swk, PAIR_N) != w_mn)
    return (int)cudaErrorInvalidValue;
  const PairTcArgs p{out, M, N, K, nm_order};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0)
    return w_mn ? launch_tc<true, __nv_bfloat16>(tx, tg, tu, p, s)
                : launch_tc<false, __nv_bfloat16>(tx, tg, tu, p, s);
  if (types == 1)
    return w_mn ? launch_tc<true, float>(tx, tg, tu, p, s) : launch_tc<false, float>(tx, tg, tu, p, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight-stream body (at most 16 rows)
// ---------------------------------------------------------------------------

// Names this kernel's stream instantiations (and their profile entries).
struct ftimm_gemm_swiglu_stream {};

// One group whose x is shared (group stride 0): the grouped pair's setup
// with G = 1, so the Wg, Wu and x boxes share one stage.
extern "C" int ftimm_gemm_swiglu_stream_launch(int device, int types, const void* x,
                                               const void* wg, const void* wu, void* out, int M,
                                               int N, int K, long long sxm, long long sxk,
                                               long long swk, long long swn, int slices,
                                               int slice, float* ws, int* counters,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ftimm::gs::Args p{out, ws, counters, nullptr, 1, M, M, N, K, slice, 0, 0, ftimm::EpiArgs{}};
  return ftimm::gs::launch<ftimm_gemm_swiglu_stream, 2>(types, x, M, 0, sxm, sxk, wg, wu, 0, swk,
                                                        swn, p, slices, 1,
                                                        static_cast<cudaStream_t>(stream));
}
