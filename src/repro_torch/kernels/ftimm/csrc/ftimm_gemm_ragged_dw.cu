// ftIMM ragged dW for Hopper: dW[g] = x[o_g:o_{g+1}]^T . dy[o_g:o_{g+1}] -> (G, D, F).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_ragged_dw:
// the weight gradient of the capacity-free MoE expert projections.  x (T, D)
// and dy (T, F) hold the routed rows sorted by expert and cut into G
// contiguous groups by the device prefix sums `offsets` (G + 1,); the ragged
// dimension is the contraction (the paper's T2 regime per group: K = routed
// tokens, against a D x F output panel).  An empty group gives a zero panel;
// rows outside every group (offsets[G] < T) enter no panel.
//
// The TPU kernel walks a host-built visit list with the group innermost and
// carries one accumulator across a group's row tiles, flushing it when the
// group changes -- a protocol that needs the grid to run in order.  Here the
// grid is (D tile x F tile, group): each CTA reads offsets[g] and
// offsets[g + 1] on the device (clamped to [0, T]), walks only its own
// group's rows, keeps the fp32 sums in registers and stores its panel tile
// once.  No two CTAs touch one output element, so there are no atomics and
// no host synchronisation, and the result is the same on every run.
//
// Two bodies; the planner (plan_ragged_gemm, ragged="k") picks one among
// those the operands allow (kernel.py, ragged_dw_bodies):
//
// * Tensor cores ("tc", ftimm_gemm_ragged_dw_tc_launch): bf16 x bf16 with x
//   and dy row-major (D and F unit-stride).  The body of ftimm_tc.cuh with a
//   2-stage ring: op(A) = x^T (D x rows) and op(B) = dy (rows x F) are
//   both MN-major, read by TMA as 64-wide blocks of 64 rows from row
//   offsets[g] on, and multiplied by wgmma into fp32 accumulators.  The
//   group's row tail: the last 64-row step reads rows past offsets[g + 1],
//   which belong to the next group (TMA zero-fills only past T), so the
//   consumers zero those lines of both operands in shared memory before the
//   wgmma reads them.  The tile is stored through a staging tile with
//   16-byte vectors; an empty group runs no step and stores its zero panel
//   the same way.  Its sums run in the tensor cores' order, so the result
//   is not bit-identical to the plain version's, but it is the same on
//   every run.
// * CUDA-core FMAs ("fma", ftimm_gemm_ragged_dw_launch): the fp32 and mixed
//   bf16 x fp32 pairs and operands TMA cannot read, through the shared
//   dense body (ftimm_common.cuh: accumulate, which masks the row remainder
//   on BOTH operands, since 0 * NaN is NaN) in BK-row steps.
//
// What bounds it on the H100: at the llama4-scout training shape (T = 1024
// routed rows, D = 5120, F = 8192, G = 16, bf16) the output, not the
// arithmetic: 16 x 5120 x 8192 bf16 = 1.34 GB written (0.40 ms at 3.35
// TB/s) against 27 MB of inputs and 86 GFLOP (0.087 ms at 989 TFLOP/s).
// Every panel is written whole, empty ones too, so the store path decides
// the time: whole 16-byte vectors, and a ring of only 2 stages (a group's
// rows are few: at T = 1024 over 16 experts one or two 64-row steps).
// With skewed routing one expert owns most rows
// and its CTAs walk long K loops while the others only store zeros.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_tc.cuh"

struct RaggedDwArgs {
  const void* x;
  const void* dy;
  const int* offsets;
  void* c;
  int T, D, F, G;
  int64_t sxt, sxd;  // x strides: row (token), column (D)
  int64_t syt, syf;  // dy strides: row (token), column (F)
};

template <class C, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_ragged_dw_kernel(RaggedDwArgs p) {
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.D, p.F, 0, m0, n0);
  const int g = blockIdx.y;
  const int lo = min(max(p.offsets[g], 0), p.T);
  const int hi = min(max(p.offsets[g + 1], lo), p.T);
  float acc[1][C::TM][C::TN];
  // op(A)(d, t) = x[lo + t][d], op(B)(t, f) = dy[lo + t][f]; K = the group's rows.
  const TA* x = static_cast<const TA*>(p.x) + (int64_t)lo * p.sxt;
  const TB* dys[1] = {static_cast<const TB*>(p.dy) + (int64_t)lo * p.syt};
  ftimm::accumulate<C, 1>(acc, x, p.sxd, p.sxt, dys, p.syt, p.syf, p.D, p.F, hi - lo, m0, n0);
  TC* c = static_cast<TC*>(p.c) + (int64_t)g * p.D * p.F;
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = m0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = n0 + tx + j * (C::BN / C::TN);
      if (row < p.D && col < p.F) c[(int64_t)row * p.F + col] = ftimm::from_f<TC>(acc[0][i][j]);
    }
  }
}

template <class C, typename TA, typename TB, typename TC>
static void launch(const RaggedDwArgs& p, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.D, C::BM) * ftimm::cdiv(p.F, C::BN), p.G);
  ftimm_gemm_ragged_dw_kernel<C, TA, TB, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const RaggedDwArgs& p, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, stream); return true;
    FTIMM_TYPES(FTIMM_TYPE)
    FTIMM_MIXED_TYPES(FTIMM_TYPE)
#undef FTIMM_TYPE
  }
  return false;
}

extern "C" int ftimm_gemm_ragged_dw_launch(int device, int tile, int types, const void* x,
                                           const void* dy, const int* offsets, void* c, int T,
                                           int D, int F, int G, long long sxt, long long sxd,
                                           long long syt, long long syf, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RaggedDwArgs p{x, dy, offsets, c, T, D, F, G, sxt, sxd, syt, syf};
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

struct RaggedDwTcArgs {
  const int* offsets;
  void* c;
  int T, D, F;
};

template <class Tl, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_ragged_dw_tc_kernel(const __grid_constant__ CUtensorMap tx,
                                   const __grid_constant__ CUtensorMap tdy, RaggedDwTcArgs p) {
  int m0, n0;
  ftimm::tile_coords(ftimm::tc::BM, Tl::BN, p.D, p.F, 0, m0, n0);
  const int g = blockIdx.y;
  const int lo = min(max(p.offsets[g], 0), p.T);
  const int hi = min(max(p.offsets[g + 1], lo), p.T);
  const ftimm::EpiArgs none{nullptr, 0, 0, 0.f, nullptr, 0, 0, nullptr, 0};
  TC* c = static_cast<TC*>(p.c) + (int64_t)g * p.D * p.F;
  ftimm::tc::run_tile<Tl, true, true, __nv_bfloat16, TC>(&tx, &tdy, m0, n0, lo, hi, true, c, p.F,
                                                          p.D, p.F, none, g);
}

template <class Tl, typename TC>
static int launch_tc(const CUtensorMap& tx, const CUtensorMap& tdy, const RaggedDwTcArgs& p,
                     int G, cudaStream_t stream) {
  auto kernel = ftimm_gemm_ragged_dw_tc_kernel<Tl, TC>;
  constexpr int smem = Tl::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.D, ftimm::tc::BM) * ftimm::cdiv(p.F, Tl::BN), G);
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(tx, tdy, p);
  return (int)cudaGetLastError();
}

// The tensor-core tile menu (kernel.py's TC_TILES), with a 2-stage ring.
using DwTcTile0 = ftimm::tc::Tile<128, 2>;
using DwTcTile1 = ftimm::tc::Tile<256, 2>;
#define FTIMM_DW_TC_TILES(X) X(0, DwTcTile0) X(1, DwTcTile1)

template <class Tl>
static int launch_tc_tile(int types, const void* x, const void* dy, int64_t sxt, int64_t sxd,
                          int64_t syt, int64_t syf, const RaggedDwTcArgs& p, int G,
                          cudaStream_t s) {
  // op(A)(d, t) = x[t][d], op(B)(t, f) = dy[t][f]: both must be MN-major.
  CUtensorMap tx, tdy;
  if (ftimm::tc::encode_operand(&tx, x, p.D, p.T, sxd, sxt, ftimm::tc::BM) != 1 ||
      ftimm::tc::encode_operand(&tdy, dy, p.F, p.T, syf, syt, Tl::BN) != 1)
    return (int)cudaErrorInvalidValue;
  if (types == 0) return launch_tc<Tl, __nv_bfloat16>(tx, tdy, p, G, s);
  if (types == 1) return launch_tc<Tl, float>(tx, tdy, p, G, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ftimm_gemm_ragged_dw_tc_launch(int device, int tile, int types, const void* x,
                                              const void* dy, const int* offsets, void* c, int T,
                                              int D, int F, int G, long long sxt, long long sxd,
                                              long long syt, long long syf, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RaggedDwTcArgs p{offsets, c, T, D, F};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define FTIMM_TILE(ID, Tl) \
  case ID: return launch_tc_tile<Tl>(types, x, dy, sxt, sxd, syt, syf, p, G, s);
    FTIMM_DW_TC_TILES(FTIMM_TILE)
#undef FTIMM_TILE
  }
  return (int)cudaErrorInvalidValue;
}
