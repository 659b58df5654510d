// ftIMM ragged grouped GEMM for Hopper: y[o_g:o_{g+1}] = epi(x[o_g:o_{g+1}] . op(W_g)).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_ragged:
// the capacity-free MoE expert projection, x (T, K) rows sorted by expert and
// cut into G contiguous groups by the device prefix sums `offsets` (G + 1,),
// against per-expert panels W (G, K, N) ("nn") or (G, N, K) ("nt").  The
// epilogue takes per-expert (G, N) or shared (N,) bias and dequant scale
// vectors, a scalar scale and the activation; it has no residual.  Rows
// outside every group (offsets[G] < T) come out as zeros, as in the reference.
//
// The TPU kernel walks a host-built, sorted list of (row tile, group) visits
// and relies on the grid running in order: a row tile shared by two groups is
// written by read-modify-write on adjacent visits.  CTAs run in no order, so
// this design does not copy that protocol.  The grid is (row chunk x N tile,
// group + 1) and each CTA walks its own group's rows from offsets[g] in BM-row
// chunks (ftimm_common.cuh: ragged_chunk): a chunk starts at its group's first
// row, not at a tile boundary, so two groups never share an output tile and
// each output row is written by exactly one CTA.  The offsets stay on the
// device -- no host synchronisation per layer.  The extra y slot zero-fills
// the rows no group owns.  Chosen over "one CTA per row tile, looping over the
// groups that touch it" because that CTA would need a second pass (or a loop
// with a per-group accumulator flush) for each boundary, and its panel loads
// would depend on a search over the offsets.
//
// What bounds it on the H100: at decode (llama4-scout: 4 tokens, top-1) the
// bytes of the expert panels that tokens reach -- at most 4 of the 16 down
// panels, 4 x 8192 x 5120 bf16 = 0.34 GB, 0.10 ms at 3.35 TB/s.  A group with
// no rows reads no panel: its CTAs return before their first load.  At the
// bucket prefill (256 rows) the fp32 FMAs on the CUDA cores bound it; tensor
// core MMA is later work.
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

struct RaggedArgs {
  const void* x;
  const void* w;
  const int* offsets;
  void* c;
  int T, N, K, G;
  int64_t sxm, sxk;
  int64_t swg, swk, swn;
  ftimm::EpiArgs epi;
};

template <class C, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_ragged_kernel(RaggedArgs p) {
  const ftimm::RaggedChunk r = ftimm::ragged_chunk(C::BM, C::BN, p.N, p.T, p.G, p.offsets);
  TC* c = static_cast<TC*>(p.c);
  if (r.g == p.G) {
    ftimm::ragged_zero_fill<C>(c, r, p.N, p.T, p.G, p.offsets);
    return;
  }
  if (r.rows <= 0) return;
  float acc[1][C::TM][C::TN];
  const TA* x = static_cast<const TA*>(p.x) + (int64_t)r.row0 * p.sxm;
  const TB* ws[1] = {static_cast<const TB*>(p.w) + (int64_t)r.g * p.swg};
  ftimm::accumulate<C, 1>(acc, x, p.sxm, p.sxk, ws, p.swk, p.swn, r.rows, p.N, p.K, 0, r.n0);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = r.n0 + tx + j * (C::BN / C::TN);
      if (row < r.rows && col < p.N)
        c[(int64_t)(r.row0 + row) * p.N + col] = ftimm::from_f<TC>(
            ftimm::apply_epi<TA>(acc[0][i][j], p.epi, r.g, r.row0 + row, col, p.N));
    }
  }
}

template <class C, typename TA, typename TB, typename TC>
static void launch(const RaggedArgs& p, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.T, C::BM) * ftimm::cdiv(p.N, C::BN), p.G + 1);
  ftimm_gemm_ragged_kernel<C, TA, TB, TC><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const RaggedArgs& p, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, stream); return true;
    FTIMM_TYPES(FTIMM_TYPE)
    FTIMM_MIXED_TYPES(FTIMM_TYPE)
#undef FTIMM_TYPE
  }
  return false;
}

extern "C" int ftimm_gemm_ragged_launch(int device, int tile, int types, const void* x,
                                        const void* w, const int* offsets, void* c, int T,
                                        int N, int K, int G, long long sxm, long long sxk,
                                        long long swg, long long swk, long long swn,
                                        const float* scale_vec, long long scale_vec_g,
                                        int has_scale, float scale, const float* bias,
                                        long long bias_g, int act, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RaggedArgs p{x,   w,   offsets, c,   T,   N,  K, G, sxm, sxk, swg, swk, swn,
                     ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g,
                                    act, nullptr, 0}};
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
