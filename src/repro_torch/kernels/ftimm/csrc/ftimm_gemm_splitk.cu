// ftIMM split-K GEMM for Hopper: C = epi(sum_s op(A)[:, K_s] . op(B)[K_s, :]).
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_splitk
// (the K-parallel ftIMM strategy, paper Alg. 5).  Split s owns the K range
// [s * k_per_split, min((s + 1) * k_per_split, K)), with k_per_split =
// cdiv(cdiv(K, BK), nsplit) * BK as in the reference; a split past the end
// of K contributes zeros.  The fp32 partials are summed in split order and
// the epilogue runs on the fp32 sum, as in the reference -- the activation
// is nonlinear, so a per-split flush would be wrong.  No atomics on the
// output: the fixed-order sum makes replays bit-identical.
//
// What bounds it on the H100: the shapes it exists for are the T2 products
// of training, K = tokens against a large M x N (the dW = x^T dy of a
// projection: K = 1024 rows against a 2048 x 2048 or 2048 x 6144 panel),
// where splitting K multiplies the CTAs by nsplit at the cost of nsplit
// fp32 M x N partials written and read back.  Two bodies; the caller
// (ops.gemm with nsplit > 1) passes the body, kernel.py's rule (gemm_bodies)
// decides which the operands allow:
//
// * Tensor cores ("tc", ftimm_gemm_splitk_tc_launch): bf16 x bf16 with
//   TMA-readable operands.  One CTA per (output tile, split), the split the
//   fastest-varying grid index, so that a tile's splits run together and
//   their partials meet in L2.  Each runs ftimm_tc.cuh's run_tile over its
//   split's [k_lo, k_hi) (TMA zero-fills past K) and flushes its fp32
//   partial tile to a (nsplit, M, N) workspace; then it bumps the tile's
//   arrival counter.  The last CTA to arrive (it resets the counter) sums
//   the tile's partials in split order 0 .. nsplit - 1, applies the
//   epilogue (scale_vec -> scale -> bias -> act -> residual) and stores the
//   output once.  Not the tensor cores bound it but the partials' bytes
//   (nsplit x 4 x M x N, written and read back) and each CTA's fixed cost
//   (one 132 KB CTA an SM): on the H100 a wave of CTAs took 13-16 us
//   whatever its K range, so where the M x N tiles alone fill the card --
//   qwen's dW, 256 and 768 tiles -- nsplit 1 (ftimm_gemm) is the faster
//   at every split count (PERF.md).
// * CUDA-core FMAs ("fma", ftimm_gemm_splitk_launch): fp32, the mixed bf16 x
//   fp32 pairs and operands TMA cannot read.  Each split runs the shared
//   accumulate of ftimm_common.cuh (both operands masked on the K
//   remainder) and writes its (M, N) fp32 partial; the caller (kernel.py)
//   sums them in split order and applies the epilogue.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_tc.cuh"

// ---------------------------------------------------------------------------
// CUDA-core FMA body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Tensor-core body: the ordered reduction inside the kernel
// ---------------------------------------------------------------------------

struct SplitkTcArgs {
  void* c;
  float* ws;      // (nsplit, M, N) fp32 partials
  int* counters;  // one per output tile, 0 between launches
  int M, N, K, nsplit, k_per_split;
  int nm_order;
  ftimm::EpiArgs epi;
};

// Grid: one CTA per (output tile, split), blockIdx.x = tile * nsplit + split.
template <class T, bool A_MN, bool B_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_splitk_tc_kernel(const __grid_constant__ CUtensorMap ta,
                                const __grid_constant__ CUtensorMap tb, SplitkTcArgs p) {
  __shared__ int last;
  const int S = p.nsplit, s = blockIdx.x % S, tile = blockIdx.x / S;
  int m0, n0;
  ftimm::tile_coords_of(tile, ftimm::tc::BM, T::BN, p.M, p.N, p.nm_order, m0, n0);
  const long long lo = (long long)s * p.k_per_split;
  const int k_lo = lo < p.K ? (int)lo : p.K;
  const int k_hi = lo + p.k_per_split < p.K ? (int)(lo + p.k_per_split) : p.K;
  const int64_t plane = (int64_t)p.M * p.N;
  ftimm::tc::run_tile<T, A_MN, B_MN, __nv_bfloat16, float>(&ta, &tb, m0, n0, k_lo, k_hi, false,
                                                           p.ws + s * plane, p.N, p.M, p.N,
                                                           ftimm::EpiArgs{}, 0);
  // The producer warpgroup has released its registers: only the 256
  // consumer threads go on, synchronising on a named barrier.
  const int tid = threadIdx.x;
  if (tid >= ftimm::tc::CONSUMERS) return;
  __threadfence();  // this CTA's partial is visible before its arrival
  ftimm::tc::consumer_sync<1>();
  int* counter = p.counters + tile;
  if (tid == 0) last = atomicAdd(counter, 1) == S - 1;
  ftimm::tc::consumer_sync<1>();
  if (!last) return;
  __threadfence();
  // Sum the tile's partials in split order, 4 columns a thread at a time.
  TC* c = static_cast<TC*>(p.c);
  const bool vec = p.N % 4 == 0;
  constexpr int CHUNKS = T::BN / 4;
#pragma unroll 1
  for (int i = tid; i < ftimm::tc::BM * CHUNKS; i += ftimm::tc::CONSUMERS) {
    const int row = m0 + i / CHUNKS, col = n0 + (i % CHUNKS) * 4;
    if (row >= p.M || col >= p.N) continue;
    const int w = min(4, p.N - col);
    const float* src = p.ws + (int64_t)row * p.N + col;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sl = 0; sl < S; ++sl, src += plane) {
      if (vec) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
        v[0] += q.x, v[1] += q.y, v[2] += q.z, v[3] += q.w;
      } else {
        for (int e = 0; e < w; ++e) v[e] += __ldcg(src + e);
      }
    }
    TC* dst = c + (int64_t)row * p.N + col;
    for (int e = 0; e < w; ++e)
      dst[e] = ftimm::from_f<TC>(
          ftimm::apply_epi<__nv_bfloat16>(v[e], p.epi, 0, row, col + e, p.N));
  }
  if (tid == 0) *counter = 0;
}

template <class T, bool A_MN, bool B_MN, typename TC>
static int launch_tc(const CUtensorMap& ta, const CUtensorMap& tb, const SplitkTcArgs& p,
                     cudaStream_t stream) {
  auto kernel = ftimm_gemm_splitk_tc_kernel<T, A_MN, B_MN, TC>;
  constexpr int smem = T::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas =
      (long long)ftimm::cdiv(p.M, ftimm::tc::BM) * ftimm::cdiv(p.N, T::BN) * p.nsplit;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)ctas), ftimm::tc::THREADS, smem, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

template <class T, typename TC>
static int launch_tc_layout(int a_mn, int b_mn, const CUtensorMap& ta, const CUtensorMap& tb,
                            const SplitkTcArgs& p, cudaStream_t s) {
  if (a_mn && b_mn) return launch_tc<T, true, true, TC>(ta, tb, p, s);
  if (a_mn) return launch_tc<T, true, false, TC>(ta, tb, p, s);
  if (b_mn) return launch_tc<T, false, true, TC>(ta, tb, p, s);
  return launch_tc<T, false, false, TC>(ta, tb, p, s);
}

// The tensor-core tile menu, in the order of kernel.py's TC_TILES.
using TcTile0 = ftimm::tc::Tile<128, 4>;
using TcTile1 = ftimm::tc::Tile<256, 4>;
#define FTIMM_TC_TILES(X) X(0, TcTile0) X(1, TcTile1)

template <class T>
static int launch_tc_tile(int types, const void* a, const void* b, int64_t sam, int64_t sak,
                          int64_t sbk, int64_t sbn, const SplitkTcArgs& p, cudaStream_t s) {
  CUtensorMap ta, tb;
  const int a_mn = ftimm::tc::encode_operand(&ta, a, p.M, p.K, sam, sak, ftimm::tc::BM);
  const int b_mn = ftimm::tc::encode_operand(&tb, b, p.N, p.K, sbn, sbk, T::BN);
  if (a_mn < 0 || b_mn < 0) return (int)cudaErrorInvalidValue;
  if (types == 0) return launch_tc_layout<T, __nv_bfloat16>(a_mn, b_mn, ta, tb, p, s);
  if (types == 1) return launch_tc_layout<T, float>(a_mn, b_mn, ta, tb, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ftimm_gemm_splitk_tc_launch(int device, int tile, int types, const void* a,
                                           const void* b, void* c, int M, int N, int K,
                                           int nsplit, int k_per_split, long long sam,
                                           long long sak, long long sbk, long long sbn,
                                           int nm_order, float* ws, int* counters,
                                           const float* scale_vec, int has_scale, float scale,
                                           const float* bias, int act, const void* residual,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nsplit < 1 || k_per_split < 1 || k_per_split % ftimm::tc::BK != 0 || ws == nullptr ||
      counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const SplitkTcArgs p{c, ws, counters, M, N, K, nsplit, k_per_split, nm_order,
                       ftimm::EpiArgs{scale_vec, 0, has_scale, scale, bias, 0, act, residual, 0}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
#define FTIMM_TILE(ID, T) \
  case ID: return launch_tc_tile<T>(types, a, b, sam, sak, sbk, sbn, p, s);
    FTIMM_TC_TILES(FTIMM_TILE)
#undef FTIMM_TILE
  }
  return (int)cudaErrorInvalidValue;
}
