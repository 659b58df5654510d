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
// group's rows in BK-row steps through the shared dense body
// (ftimm_common.cuh: accumulate, which masks the row remainder on BOTH
// operands, since 0 * NaN is NaN), keeps the fp32 sums in registers and
// stores its panel tile once.  No two CTAs touch one output element, so there
// are no atomics and no host synchronisation, and the result is the same on
// every run.
//
// What bounds it on the H100: at the llama4-scout training shape (T = 1024
// routed rows, D = 5120, F = 8192, G = 16, bf16) the output, not the
// arithmetic: 16 x 5120 x 8192 bf16 = 1.34 GB written (0.40 ms at 3.35
// TB/s) against 27 MB of inputs and 86 GFLOP (0.087 ms at 989 TFLOP/s).
// Every panel is written whole, empty ones too.  The store is coalesced: the
// threads of a warp write neighbouring columns of one output row.  With
// skewed routing one expert owns most rows and its CTAs walk long K loops
// while the others only store zeros; that imbalance is accepted for now
// (PERF.md records the time).
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

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
