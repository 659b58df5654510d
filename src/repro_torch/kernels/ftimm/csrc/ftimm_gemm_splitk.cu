// ftIMM split-K GEMM for Hopper: fp32 partials P[s] = op(A)[:, K_s] . op(B)[K_s, :].
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_splitk
// (the K-parallel ftIMM strategy, paper Alg. 5).  Split s owns the K range
// [s * k_per_split, min((s + 1) * k_per_split, K)), with k_per_split =
// cdiv(cdiv(K, BK), nsplit) * BK as in the reference; a split past the end
// of K stores zeros.  The kernel writes the (nsplit, M, N) fp32 partials; the
// caller (kernel.py) sums them in split order and applies the epilogue to the
// fp32 sum, as the reference does outside its kernel -- the activation is
// nonlinear, so a per-split flush would be wrong.  No atomics: every partial
// element has one writer, and the fixed-order sum makes replays
// bit-identical.
//
// What bounds it on the H100: the shapes it exists for are the T2 products
// of training, K = tokens >> M, N (the dW = x^T dy of a projection: K = 1024
// rows against a 2048 x 2048 panel), where a grid over M x N alone has too
// few CTAs to fill 132 SMs for long K loops.  Splitting K multiplies the CTAs
// by nsplit at the cost of nsplit fp32 M x N partials written and read back.
// The arithmetic runs on the CUDA cores (fp32 FMA, 67 TFLOP/s), so at those
// shapes the operations bound it; the body is the dense kernels' (shared
// ftimm_common.cuh accumulate, both operands masked on the K remainder).
//
// C interface, bound from kernel.py with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched).
#include "ftimm_common.cuh"

struct SplitkArgs {
  const void* a;
  const void* b;
  float* partials;
  int M, N, K, k_per_split;
  int64_t sam, sak, sbk, sbn;
  int nm_order;
};

template <class C, typename TA, typename TB>
__global__ void __launch_bounds__(C::THREADS) ftimm_gemm_splitk_kernel(SplitkArgs p) {
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, p.nm_order, m0, n0);
  const int s = blockIdx.z;
  const long long lo = (long long)s * p.k_per_split;
  const int k0 = lo < p.K ? (int)lo : p.K;
  const int k1 = lo + p.k_per_split < p.K ? (int)(lo + p.k_per_split) : p.K;
  float acc[1][C::TM][C::TN];
  const TA* a = static_cast<const TA*>(p.a) + (int64_t)k0 * p.sak;
  const TB* bs[1] = {static_cast<const TB*>(p.b) + (int64_t)k0 * p.sbk};
  ftimm::accumulate<C, 1>(acc, a, p.sam, p.sak, bs, p.sbk, p.sbn, p.M, p.N, k1 - k0, m0, n0);
  float* c = p.partials + (int64_t)s * p.M * p.N;
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = m0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = n0 + tx + j * (C::BN / C::TN);
      if (row < p.M && col < p.N) c[(int64_t)row * p.N + col] = acc[0][i][j];
    }
  }
}

template <class C, typename TA, typename TB>
static void launch(const SplitkArgs& p, int nsplit, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.M, C::BM) * ftimm::cdiv(p.N, C::BN), 1, nsplit);
  ftimm_gemm_splitk_kernel<C, TA, TB><<<grid, C::THREADS, 0, stream>>>(p);
}

template <class C>
static bool launch_types(int types, const SplitkArgs& p, int nsplit, cudaStream_t stream) {
  switch (types) {  // the partials are fp32 whatever the output type
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB>(p, nsplit, stream); return true;
    FTIMM_TYPES(FTIMM_TYPE)
    FTIMM_MIXED_TYPES(FTIMM_TYPE)
#undef FTIMM_TYPE
  }
  return false;
}

extern "C" int ftimm_gemm_splitk_launch(int device, int tile, int types, const void* a,
                                        const void* b, float* partials, int M, int N, int K,
                                        int nsplit, int k_per_split, long long sam,
                                        long long sak, long long sbk, long long sbn,
                                        int nm_order, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nsplit < 1 || nsplit > 65535) return (int)cudaErrorInvalidValue;
  const SplitkArgs p{a, b, partials, M, N, K, k_per_split, sam, sak, sbk, sbn, nm_order};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (tile) {
#define FTIMM_TILE(ID, T) \
  case ID: ok = launch_types<T>(types, p, nsplit, s); break;
    FTIMM_TILES(FTIMM_TILE)
#undef FTIMM_TILE
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
