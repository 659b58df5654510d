// ftIMM grouped fused SwiGLU pair for Hopper:
// out[g] = silu(x[g] . Wg[g]) * (x[g] . Wu[g]) for g < G.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_grouped_swiglu:
// the capacity-mode MoE gate/up projections (E, C, D) x 2 (E, D, F) in one
// launch, with no (E, C, F) fp32 intermediates in device memory.  x may be
// one 2-D panel shared by every group: it is passed with group stride 0, as in
// the grouped kernel.  The pair takes no epilogue, as in the reference.
//
// Three bodies, those of ftimm_gemm_grouped.cu with a second weight panel;
// the planner (core/gemm/tuner.py, plan_batched_gemm with panels = 2) picks
// one among those the operands allow (kernel.py, grouped_bodies):
//
// * Weight stream ("stream", ftimm_gemm_grouped_swiglu_stream_launch): bf16 x
//   bf16, at most 16 rows a group, x K-major -- mixtral-8x7b at decode
//   (capacity 16): every step streams both panels of all 8 experts, 2 x 8 x
//   4096 x 14336 bf16 = 1.88 GB, 0.56 ms at 3.35 TB/s, whatever the router
//   did.  The body of ftimm_gstream.cuh with PANELS = 2: each stage of a
//   (strip, K slice, group) CTA's TMA ring holds the Wg box, the Wu box at
//   the same (k0, n0) and the group's x box, and the warpgroup keeps one
//   wgmma accumulator set per panel; silu(g) * u is formed after the K
//   slices are summed, each panel alone.
// * Tensor cores ("tc", ftimm_gemm_grouped_swiglu_tc_launch): bf16 x bf16
//   with every operand TMA-readable -- the bucket prefills (capacity 48 / 80)
//   and training (capacity 320: 2 x 301 GFLOP a launch, bound by the 989
//   TFLOP/s of the tensor cores).  ftimm_tc.cuh's 128 x 256 tile with the
//   pair's two halves: Wg at n0 and Wu at n0 into one 48 KB stage, two
//   128-column accumulator halves per consumer thread, silu(g) * u formed in
//   registers at the flush of a 128 x 128 output tile; 3-D maps (group
//   outermost) zero-fill each group's K edge, a shared x keeps a 2-D map.
// * CUDA-core FMAs ("fma", ftimm_gemm_grouped_swiglu_launch): fp32 pairs and
//   operands TMA cannot read: ftimm_common.cuh's accumulate with two B
//   panels against one x panel, groups on blockIdx.z.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_gstream.cuh"
#include "ftimm_tc.cuh"

struct GroupedSwigluArgs {
  const void* x;
  const void* wg;
  const void* wu;
  void* out;
  int M, N, K;
  int64_t sxg, sxm, sxk;  // group stride 0: x is shared by every group
  int64_t swg, swk, swn;
};

template <class C, typename TA, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_grouped_swiglu_kernel(GroupedSwigluArgs p) {
  const int g = blockIdx.z;
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, 0, m0, n0);
  float acc[2][C::TM][C::TN];
  const TA* x = static_cast<const TA*>(p.x) + g * p.sxg;
  const TA* ws[2] = {static_cast<const TA*>(p.wg) + g * p.swg,
                     static_cast<const TA*>(p.wu) + g * p.swg};
  ftimm::accumulate<C, 2>(acc, x, p.sxm, p.sxk, ws, p.swk, p.swn, p.M, p.N, p.K, m0, n0);
  TC* out = static_cast<TC*>(p.out) + (int64_t)g * p.M * p.N;
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = m0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = n0 + tx + j * (C::BN / C::TN);
      if (row < p.M && col < p.N)
        out[(int64_t)row * p.N + col] = ftimm::from_f<TC>(ftimm::silu_mul(acc[0][i][j], acc[1][i][j]));
    }
  }
}

template <class C, typename TA, typename TC>
static void launch(const GroupedSwigluArgs& p, int G, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.M, C::BM) * ftimm::cdiv(p.N, C::BN), 1, G);
  ftimm_gemm_grouped_swiglu_kernel<C, TA, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const GroupedSwigluArgs& p, int G, cudaStream_t stream) {
  switch (types) {
    case 0: launch<C, __nv_bfloat16, __nv_bfloat16>(p, G, stream); return true;
    case 1: launch<C, __nv_bfloat16, float>(p, G, stream); return true;
    case 2: launch<C, float, float>(p, G, stream); return true;
  }
  return false;
}

extern "C" int ftimm_gemm_grouped_swiglu_launch(int device, int tile, int types, const void* x,
                                                const void* wg, const void* wu, void* out,
                                                int G, int M, int N, int K, long long sxg,
                                                long long sxm, long long sxk, long long swg,
                                                long long swk, long long swn, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GroupedSwigluArgs p{x, wg, wu, out, M, N, K, sxg, sxm, sxk, swg, swk, swn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (tile) {
#define FTIMM_TILE(ID, T) \
  case ID: ok = launch_types<T>(types, p, G, s); break;
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
  int x3d, w3d;  // the operand's map is rank 3 (read at the group)
};

template <bool X_MN, bool W_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_grouped_swiglu_tc_kernel(const __grid_constant__ CUtensorMap tx,
                                        const __grid_constant__ CUtensorMap tg,
                                        const __grid_constant__ CUtensorMap tu, PairTcArgs p) {
  const int g = blockIdx.z;
  int m0, n0;
  ftimm::tile_coords(ftimm::tc::BM, PAIR_N, p.M, p.N, 0, m0, n0);
  TC* out = static_cast<TC*>(p.out) + (int64_t)g * p.M * p.N;
  ftimm::tc::run_tile<PairTcTile, X_MN, W_MN, __nv_bfloat16, TC, true>(
      &tx, &tg, m0, n0, 0, p.K, false, out, p.N, p.M, p.N, ftimm::EpiArgs{}, g,
      p.x3d ? g : -1, p.w3d ? g : -1, &tu);
}

template <bool X_MN, bool W_MN, typename TC>
static int launch_tc(const CUtensorMap& tx, const CUtensorMap& tg, const CUtensorMap& tu,
                     const PairTcArgs& p, int G, cudaStream_t stream) {
  auto kernel = ftimm_gemm_grouped_swiglu_tc_kernel<X_MN, W_MN, TC>;
  constexpr int smem = PairTcTile::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.M, ftimm::tc::BM) * ftimm::cdiv(p.N, PAIR_N), 1, G);
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(tx, tg, tu, p);
  return (int)cudaGetLastError();
}

template <typename TC>
static int launch_tc_layout(int x_mn, int w_mn, const CUtensorMap& tx, const CUtensorMap& tg,
                            const CUtensorMap& tu, const PairTcArgs& p, int G, cudaStream_t s) {
  if (x_mn && w_mn) return launch_tc<true, true, TC>(tx, tg, tu, p, G, s);
  if (x_mn) return launch_tc<true, false, TC>(tx, tg, tu, p, G, s);
  if (w_mn) return launch_tc<false, true, TC>(tx, tg, tu, p, G, s);
  return launch_tc<false, false, TC>(tx, tg, tu, p, G, s);
}

extern "C" int ftimm_gemm_grouped_swiglu_tc_launch(int device, int types, const void* x,
                                                   const void* wg, const void* wu, void* out,
                                                   int G, int M, int N, int K, long long sxg,
                                                   long long sxm, long long sxk, long long swg,
                                                   long long swk, long long swn, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu;
  const int64_t gx = sxg != 0 ? G : 1, gw = swg != 0 ? G : 1;
  const int x_mn = ftimm::tc::encode_operand(&tx, x, M, K, sxm, sxk, ftimm::tc::BM, gx, sxg);
  const int w_mn = ftimm::tc::encode_operand(&tg, wg, N, K, swn, swk, PAIR_N, gw, swg);
  if (x_mn < 0 || w_mn < 0 ||
      ftimm::tc::encode_operand(&tu, wu, N, K, swn, swk, PAIR_N, gw, swg) != w_mn)
    return (int)cudaErrorInvalidValue;
  const PairTcArgs p{out, M, N, K, gx > 1, gw > 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0) return launch_tc_layout<__nv_bfloat16>(x_mn, w_mn, tx, tg, tu, p, G, s);
  if (types == 1) return launch_tc_layout<float>(x_mn, w_mn, tx, tg, tu, p, G, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight-stream body (at most 16 rows a group)
// ---------------------------------------------------------------------------

// Names this kernel's stream instantiations (and their profile entries).
struct ftimm_gemm_grouped_swiglu_stream {};

extern "C" int ftimm_gemm_grouped_swiglu_stream_launch(
    int device, int types, const void* x, const void* wg, const void* wu, void* out, int G,
    int M, int N, int K, long long sxg, long long sxm, long long sxk, long long swg,
    long long swk, long long swn, int slices, int slice, float* ws, int* counters,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ftimm::gs::Args p{out, ws, counters, nullptr, G, M, G * M, N, K, slice, 0, 0,
                    ftimm::EpiArgs{}};
  return ftimm::gs::launch<ftimm_gemm_grouped_swiglu_stream, 2>(
      types, x, M, sxg, sxm, sxk, wg, wu, swg, swk, swn, p, slices, G,
      static_cast<cudaStream_t>(stream));
}
