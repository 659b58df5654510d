// ftIMM grouped GEMM for Hopper: C[g] = epi(op(A[g]) . op(B[g])) for g < G.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm_grouped
// (and its batched wrapper ftimm_gemm_batched).  Either operand may be one
// 2-D panel shared by every group: it is passed with group stride 0.  bias
// and the dequant scale vector are (N,) shared or (G, N) per group; the
// residual is (G, M, N).  Groups go on blockIdx.z.  Four bodies; the
// planner (core/gemm/tuner.py, plan_batched_gemm) picks one among those the
// operands allow (kernel.py, grouped_bodies):
//
// * Weight stream ("stream", ftimm_gemm_grouped_stream_launch): bf16 x bf16,
//   at most 16 rows a group, A K-major -- the capacity-MoE expert down
//   projection at decode (mixtral: (8, 16, 14336) . (8, 14336, 4096)).
//   Bound: the 939.5 MB of panels over 3.35 TB/s (0.28 ms); the body of
//   ftimm_gstream.cuh (a TMA ring per (strip, K slice, group) CTA, wgmma
//   with the weight as the 64-row operand).
// * Tensor cores ("tc", ftimm_gemm_grouped_tc_launch): bf16 x bf16 with both
//   operands TMA-readable -- the expert products of prefill and training
//   (mixtral trains at capacity 320: 301 GFLOP a launch, bound by the
//   989 TFLOP/s of the tensor cores).  The body of ftimm_tc.cuh with 3-D
//   tensor maps (group outermost), so TMA zero-fills each group's K edge
//   and no box reads one group's rows into another's contraction; a shared
//   2-D operand keeps a 2-D map (TMA encodes no zero stride).
// * Few-rows fp32 stream ("rows", ftimm_gemm_grouped_rows_launch): fp32 x
//   fp32 with at most 8 rows a group, trans "nt" or "nn", B's rows unit
//   stride and 16-byte aligned -- the decode attention products QK^T ("nt",
//   K = head_dim) and PV ("nn", K = the cache length), 1-7 query rows a
//   group against the cache view, which the reference computes in full fp32
//   (no TF32 here either).  Bound: the fp32 K / V bytes over 3.35 TB/s; the
//   body of ftimm_rows.cuh (B through a per-warp cp.async ring, A on chip,
//   the slots x kv-heads groups cut into cache-row strips or K slices).
// * CUDA-core FMAs ("fma", ftimm_gemm_grouped_launch): everything else --
//   fp32 products of more than 8 rows a group (prefill and training
//   attention, fp32 experts), the mixed bf16 x fp32 pairs and operands
//   neither TMA nor the rows body can read.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_gstream.cuh"
#include "ftimm_rows.cuh"
#include "ftimm_tc.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core body
// ---------------------------------------------------------------------------

struct GroupedTcArgs {
  void* c;
  int M, N, K;
  int nm_order;
  int a3d, b3d;  // the operand's map is rank 3 (read at the group)
  ftimm::EpiArgs epi;
};

template <class T, bool A_MN, bool B_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_grouped_tc_kernel(const __grid_constant__ CUtensorMap ta,
                                 const __grid_constant__ CUtensorMap tb, GroupedTcArgs p) {
  const int g = blockIdx.z;
  int m0, n0;
  ftimm::tile_coords(ftimm::tc::BM, T::BN, p.M, p.N, p.nm_order, m0, n0);
  TC* c = static_cast<TC*>(p.c) + (int64_t)g * p.M * p.N;
  ftimm::tc::run_tile<T, A_MN, B_MN, __nv_bfloat16, TC>(&ta, &tb, m0, n0, 0, p.K, false, c, p.N,
                                                         p.M, p.N, p.epi, g, p.a3d ? g : -1,
                                                         p.b3d ? g : -1);
}

template <class T, bool A_MN, bool B_MN, typename TC>
static int launch_tc(const CUtensorMap& ta, const CUtensorMap& tb, const GroupedTcArgs& p, int G,
                     cudaStream_t stream) {
  auto kernel = ftimm_gemm_grouped_tc_kernel<T, A_MN, B_MN, TC>;
  constexpr int smem = T::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.M, ftimm::tc::BM) * ftimm::cdiv(p.N, T::BN), 1, G);
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

template <class T, typename TC>
static int launch_tc_layout(int a_mn, int b_mn, const CUtensorMap& ta, const CUtensorMap& tb,
                            const GroupedTcArgs& p, int G, cudaStream_t s) {
  if (a_mn && b_mn) return launch_tc<T, true, true, TC>(ta, tb, p, G, s);
  if (a_mn) return launch_tc<T, true, false, TC>(ta, tb, p, G, s);
  if (b_mn) return launch_tc<T, false, true, TC>(ta, tb, p, G, s);
  return launch_tc<T, false, false, TC>(ta, tb, p, G, s);
}

// The grouped tensor-core tile (kernel.py's GROUP_TC_TILE): 128 x 128, a
// 4-stage ring.
using GroupedTcTile = ftimm::tc::Tile<128, 4>;

extern "C" int ftimm_gemm_grouped_tc_launch(
    int device, int types, const void* a, const void* b, void* c, int G, int M,
    int N, int K, long long sag, long long sam, long long sak, long long sbg, long long sbk,
    long long sbn, int nm_order, const float* scale_vec, long long scale_vec_g, int has_scale,
    float scale, const float* bias, long long bias_g, int act, const void* residual,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  using T = GroupedTcTile;
  CUtensorMap ta, tb;
  const int64_t ga = sag != 0 ? G : 1, gb = sbg != 0 ? G : 1;
  const int a_mn = ftimm::tc::encode_operand(&ta, a, M, K, sam, sak, ftimm::tc::BM, ga, sag);
  const int b_mn = ftimm::tc::encode_operand(&tb, b, N, K, sbn, sbk, T::BN, gb, sbg);
  if (a_mn < 0 || b_mn < 0) return (int)cudaErrorInvalidValue;
  const GroupedTcArgs p{c, M, N, K, nm_order, ga > 1, gb > 1,
                        ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g,
                                       act, residual, (int64_t)M * N}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0) return launch_tc_layout<T, __nv_bfloat16>(a_mn, b_mn, ta, tb, p, G, s);
  if (types == 1) return launch_tc_layout<T, float>(a_mn, b_mn, ta, tb, p, G, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight-stream body (at most 16 rows a group)
// ---------------------------------------------------------------------------

// Names this kernel's stream instantiations (and their profile entries).
struct ftimm_gemm_grouped_stream {};

extern "C" int ftimm_gemm_grouped_stream_launch(
    int device, int types, const void* a, const void* b, void* c,
    int G, int M, int N, int K, long long sag, long long sam, long long sak, long long sbg,
    long long sbk, long long sbn, int slices, int slice, float* ws, int* counters,
    const float* scale_vec, long long scale_vec_g, int has_scale, float scale,
    const float* bias, long long bias_g, int act, const void* residual, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ftimm::gs::Args p{c, ws, counters, nullptr, G, M, G * M, N, K, slice, 0, 0,
                    ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g, act,
                                   residual, (int64_t)M * N}};
  return ftimm::gs::launch<ftimm_gemm_grouped_stream>(types, a, M, sag, sam, sak, b, nullptr,
                                                      sbg, sbk, sbn, p, slices, G,
                                                      static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Few-rows fp32 stream (at most 8 rows a group; ftimm_rows.cuh)
// ---------------------------------------------------------------------------

// nt = 1: QK^T-like ("nt"), the grid (strips of `span` cache rows, K slices
// of `width`, G); nt = 0: PV-like ("nn"), (strips of `width` columns, K
// slices of `span` rows, G).  ws: (slices, G, M, N) fp32 and counters (G x
// strips) when there is more than one K slice.
extern "C" int ftimm_gemm_grouped_rows_launch(
    int device, int types, const void* a, const void* b, void* c, int G, int M, int N, int K,
    long long sag, long long sam, long long sak, long long sbg, long long sbk, long long sbn,
    int nt, int width, int span, float* ws, int* counters, const float* scale_vec,
    long long scale_vec_g, int has_scale, float scale, const float* bias, long long bias_g,
    int act, const void* residual, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return ftimm::rows::launch(types, a, b, c, G, M, N, K, sag, sam, sak, sbg, sbk, sbn, nt, width,
                             span, ws, counters,
                             ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias,
                                            bias_g, act, residual, (int64_t)M * N},
                             static_cast<cudaStream_t>(stream));
}
