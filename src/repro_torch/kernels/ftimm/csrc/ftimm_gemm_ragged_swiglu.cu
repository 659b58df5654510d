// ftIMM ragged fused SwiGLU pair for Hopper:
// out[o_g:o_{g+1}] = silu(x[o_g:o_{g+1}] . Wg_g) * (x[o_g:o_{g+1}] . Wu_g).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_ragged_swiglu:
// the capacity-free MoE gate/up projections, x (T, K) rows sorted by expert
// and cut into G groups by the device prefix sums `offsets` (G + 1,), against
// per-expert panels Wg, Wu (G, K, N), in one launch with no (T, N) fp32
// intermediates in device memory.  Rows outside every group come out as
// zeros, as in the reference.
//
// The grid and the row ownership are those of ftimm_gemm_ragged.cu (see
// there, and ftimm_common.cuh: ragged_chunk): each CTA walks its own group's
// rows from offsets[g], so every output row is written by exactly one CTA,
// without atomics, read-modify-write or host synchronisation, and the TPU
// kernel's in-order read-modify-write of shared row tiles is not needed.
//
// What bounds it on the H100: at decode (llama4-scout: 4 tokens, top-1) the
// bytes of the gate and up panels of the experts that tokens reach -- at most
// 4 of 16, 2 x 4 x 5120 x 8192 bf16 = 0.67 GB, 0.20 ms at 3.35 TB/s; an
// expert with no rows reads neither panel.  The design loads each x chunk
// into shared memory once for both panels and keeps two fp32 accumulators per
// thread; the SwiGLU product is formed in registers at the flush.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

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
      if (row < r.rows && col < p.N) {
        const float g = acc[0][i][j];
        out[(int64_t)(r.row0 + row) * p.N + col] =
            ftimm::from_f<TC>(g * (1.f / (1.f + expf(-g))) * acc[1][i][j]);
      }
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
