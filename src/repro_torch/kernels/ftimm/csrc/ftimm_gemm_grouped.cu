// ftIMM grouped GEMM for Hopper: C[g] = epi(op(A[g]) . op(B[g])) for g < G.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_grouped
// (and its batched wrapper ftimm_gemm_batched).  Either operand may be one
// 2-D panel shared by every group: it is passed with group stride 0.  bias
// and the dequant scale vector are (N,) shared or (G, N) per group; the
// residual is (G, M, N).
//
// What bounds it on the H100: on the serving path it carries the attention
// products, QK^T ("nt", K = head_dim = 128) and PV ("nn", K = cache length),
// in fp32 -- the reference computes them in full fp32, so this kernel runs
// fp32 FMAs on the CUDA cores, no TF32.  At decode each group has 2 query
// rows against the whole cache view, so the bound is the fp32 K/V bytes
// over 3.35 TB/s.  Groups go on blockIdx.z and tiles on blockIdx.x, so the
// slots x kv-heads groups multiply the CTA count of one small product; the
// planner picks the tile that fills the 132 SMs best.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

struct GroupedArgs {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  int64_t sag, sam, sak;  // group stride 0: A is shared by every group
  int64_t sbg, sbk, sbn;
  int nm_order;
  ftimm::EpiArgs epi;
};

template <class C, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_grouped_kernel(GroupedArgs p) {
  const int g = blockIdx.z;
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, p.nm_order, m0, n0);
  float acc[1][C::TM][C::TN];
  const TA* a = static_cast<const TA*>(p.a) + g * p.sag;
  const TB* bs[1] = {static_cast<const TB*>(p.b) + g * p.sbg};
  ftimm::accumulate<C, 1>(acc, a, p.sam, p.sak, bs, p.sbk, p.sbn, p.M, p.N, p.K, m0, n0);
  TC* c = static_cast<TC*>(p.c) + (int64_t)g * p.M * p.N;
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
            ftimm::from_f<TC>(ftimm::apply_epi<TA>(acc[0][i][j], p.epi, g, row, col, p.N));
    }
  }
}

template <class C, typename TA, typename TB, typename TC>
static void launch(const GroupedArgs& p, int G, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.M, C::BM) * ftimm::cdiv(p.N, C::BN), 1, G);
  ftimm_gemm_grouped_kernel<C, TA, TB, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const GroupedArgs& p, int G, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, G, stream); return true;
    FTIMM_TYPES(FTIMM_TYPE)
    FTIMM_MIXED_TYPES(FTIMM_TYPE)
#undef FTIMM_TYPE
  }
  return false;
}

extern "C" int ftimm_gemm_grouped_launch(
    int device, int tile, int types, const void* a, const void* b, void* c, int G, int M,
    int N, int K, long long sag, long long sam, long long sak, long long sbg, long long sbk,
    long long sbn, int nm_order, const float* scale_vec, long long scale_vec_g, int has_scale,
    float scale, const float* bias, long long bias_g, int act, const void* residual,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GroupedArgs p{a,   b,   c,   M,   N,        K,
                      sag, sam, sak, sbg, sbk,      sbn,
                      nm_order,
                      ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g,
                                     act, residual, (int64_t)M * N}};
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
