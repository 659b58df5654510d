// ftIMM dense GEMM for Hopper: C = epi(op(A) . op(B)), trans nn / tn / nt.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm (the
// M-parallel ftIMM strategy, paper Alg. 4).
//
// What bounds it on the H100: on the serving path it is the weight stream.
// A decode step multiplies 4 rows by every projection panel, about 0.5
// FLOP per weight byte against the card's ~295 bf16 FLOP/byte ridge, so the
// kernel can be no faster than its weight bytes over 3.35 TB/s.  The design
// answers with occupancy rather than reuse: the planner gives skinny-M
// shapes the 16 x 32 tile, which puts the most CTAs (and so the most loads
// in flight) on the 132 SMs, every panel element is read once per CTA with
// loads coalesced along the operand's unit-stride dimension, and the next K
// step is staged in registers while the current one computes.  The prefill
// shapes (hundreds of rows) take the larger tiles, whose fp32 FMAs on the
// CUDA cores (67 TFLOP/s) are then the bound; tensor-core MMA (wgmma) and
// TMA pipelines are later work.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  int64_t sam, sak, sbk, sbn;
  int nm_order;
  ftimm::EpiArgs epi;
};

template <class C, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_kernel(GemmArgs p) {
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, p.nm_order, m0, n0);
  float acc[1][C::TM][C::TN];
  const TB* bs[1] = {static_cast<const TB*>(p.b)};
  ftimm::accumulate<C, 1>(acc, static_cast<const TA*>(p.a), p.sam, p.sak, bs, p.sbk, p.sbn,
                          p.M, p.N, p.K, m0, n0);
  TC* c = static_cast<TC*>(p.c);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = m0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = n0 + tx + j * (C::BN / C::TN);
      if (row < p.M && col < p.N)
        c[(int64_t)row * p.N + col] =
            ftimm::from_f<TC>(ftimm::apply_epi<TA>(acc[0][i][j], p.epi, 0, row, col, p.N));
    }
  }
}

template <class C, typename TA, typename TB, typename TC>
static void launch(const GemmArgs& p, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.M, C::BM) * ftimm::cdiv(p.N, C::BN));
  ftimm_gemm_kernel<C, TA, TB, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const GemmArgs& p, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, stream); return true;
    FTIMM_TYPES(FTIMM_TYPE)
    FTIMM_MIXED_TYPES(FTIMM_TYPE)
#undef FTIMM_TYPE
  }
  return false;
}

extern "C" int ftimm_gemm_launch(int device, int tile, int types, const void* a, const void* b,
                                 void* c, int M, int N, int K, long long sam, long long sak,
                                 long long sbk, long long sbn, int nm_order,
                                 const float* scale_vec, int has_scale, float scale,
                                 const float* bias, int act, const void* residual,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs p{a, b, c, M, N, K, sam, sak, sbk, sbn, nm_order,
                   ftimm::EpiArgs{scale_vec, 0, has_scale, scale, bias, 0, act, residual, 0}};
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
