// ftIMM fused SwiGLU pair for Hopper: out = silu(x . Wg) * (x . Wu).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_swiglu:
// a dense MLP's gate and up projections in one launch, with no (M, N) fp32
// intermediates in device memory.
//
// What bounds it on the H100: at decode (4 rows) the two weight panels, 2 x
// d_model x d_ff bf16, read once over 3.35 TB/s; at prefill the fp32 FMAs on
// the CUDA cores.  The design loads each x tile into shared memory once for
// both panels and keeps two fp32 accumulators per thread, so x is read half
// as often as two separate GEMMs would read it and the SwiGLU product is
// formed in registers at the flush (g * sigmoid(g) * u), never stored as two
// fp32 (M, N) panels.  All three operands are masked on the K remainder.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

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
