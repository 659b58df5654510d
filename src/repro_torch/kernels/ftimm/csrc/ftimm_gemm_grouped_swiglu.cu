// ftIMM grouped fused SwiGLU pair for Hopper:
// out[g] = silu(x[g] . Wg[g]) * (x[g] . Wu[g]) for g < G.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_grouped_swiglu:
// the capacity-mode MoE gate/up projections (E, C, D) x 2 (E, D, F) in one
// launch, with no (E, C, F) fp32 intermediates in device memory.  x may be
// one 2-D panel shared by every group: it is passed with group stride 0, as in
// the grouped kernel.
//
// The body is ftimm_gemm_swiglu.cu's with a group grid axis: groups on
// blockIdx.z, output tiles on blockIdx.x, and per-group operand strides.
//
// What bounds it on the H100: capacity dispatch runs every expert on its
// padded capacity rows whatever the router did, so at mixtral-8x7b decode
// (C = 16) the launch streams both panels of all 8 experts every step,
// 2 x 8 x 4096 x 14336 bf16 = 1.88 GB, 0.56 ms at 3.35 TB/s.  The design
// loads each x tile into shared memory once for both panels and keeps two
// fp32 accumulators per thread (the SwiGLU product is formed in registers at
// the flush); the planner gives the skinny capacity rows the 16-row tile,
// which puts the most CTAs, and so the most loads in flight, on the 132 SMs.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

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
      if (row < p.M && col < p.N) {
        const float gv = acc[0][i][j];
        out[(int64_t)row * p.N + col] =
            ftimm::from_f<TC>(gv * (1.f / (1.f + expf(-gv))) * acc[1][i][j]);
      }
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
