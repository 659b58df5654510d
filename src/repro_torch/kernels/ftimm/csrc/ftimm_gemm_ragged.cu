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
// Three bodies; the planner (plan_ragged_gemm, ragged="m") picks one among
// those the operands allow (kernel.py, ragged_bodies), from the number of
// rows it knows (the per-group counts stay on the device):
//
// * Weight stream ("stream", ftimm_gemm_ragged_stream_launch): bf16 x bf16,
//   T <= 16 rows in all, x K-major -- the expert down projection at decode
//   (llama4-scout: 4 tokens, top-1, so at most 4 of the 16 (8192, 5120)
//   panels are reached: 335.5 MB, 0.10 ms at 3.35 TB/s).  The body of
//   ftimm_gstream.cuh with the grid (N strip, K slice, group + 1): a CTA
//   reads offsets[g], offsets[g + 1] itself and returns before its first
//   load when its group is empty, so only the reached panels are read; the
//   extra z slot zero-fills the rows no group owns.
// * Tensor cores ("tc", ftimm_gemm_ragged_tc_launch): bf16 x bf16, x
//   K-major and the panels TMA-readable -- prefill and training (llama4
//   trains 1024 routed rows; the remat with fp32 output and the dX "nt" of
//   a bf16 cotangent too).  The grid above, each CTA a 128 x 128 tile of the
//   body of ftimm_tc.cuh from its chunk's first row; x rows past the
//   group's end only feed output rows that are not stored, so nothing is
//   masked in shared memory, and the panels go through a 3-D map (group
//   outermost) that zero-fills each panel's K edge.
// * CUDA-core FMAs ("fma", ftimm_gemm_ragged_launch): fp32 and mixed bf16 x
//   fp32 pairs, operands TMA cannot read, and the quantized expert panels
//   (int8 weights against bf16 / fp32 rows, int8 x int8 into an int32
//   accumulator, fp8 x fp8), through the shared strided body
//   (ftimm_common.cuh: accumulate); the (G, N) dequant vector rides in
//   EpiArgs' scale_vec at the group's row.  At llama4's decode (4 rows to
//   4 experts) a quantized call reads 1-byte panels but only 32 contiguous
//   bytes of a K row a CTA (Tile0), so it is far from its bytes bound:
//   putting 1-byte panels on the stream and the tensor cores is later work.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_gstream.cuh"
#include "ftimm_tc.cuh"

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
  typename ftimm::AccOf<TA, TB>::type acc[1][C::TM][C::TN];
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
            ftimm::apply_epi<float>((float)acc[0][i][j], p.epi, r.g, r.row0 + row, col, p.N));
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

// The quantized forward codes, on the tiles of FTIMM_QUANT_TILES only.
template <class C>
static bool launch_quant_types(int types, const RaggedArgs& p, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, stream); return true;
    FTIMM_QUANT_TYPES(FTIMM_TYPE)
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
  if (!ok) {
    switch (tile) {
#define FTIMM_TILE(ID, T) \
  case ID: ok = launch_quant_types<T>(types, p, s); break;
      FTIMM_QUANT_TILES(FTIMM_TILE)
#undef FTIMM_TILE
    }
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core body
// ---------------------------------------------------------------------------

struct RaggedTcArgs {
  const int* offsets;
  void* c;
  int T, N, K, G;
  int w3d;  // the panels' map is rank 3 (read at the group)
  ftimm::EpiArgs epi;
};

template <class Tl, bool W_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_ragged_tc_kernel(const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tw, RaggedTcArgs p) {
  const ftimm::RaggedChunk r =
      ftimm::ragged_chunk(ftimm::tc::BM, Tl::BN, p.N, p.T, p.G, p.offsets);
  TC* c = static_cast<TC*>(p.c);
  if (r.g == p.G) {  // zero-fill: rows of this chunk outside [offsets[0], offsets[G])
    const int lo = min(max(p.offsets[0], 0), p.T);
    const int hi = min(max(p.offsets[p.G], lo), p.T);
    for (int i = threadIdx.x; i < ftimm::tc::BM * Tl::BN; i += ftimm::tc::THREADS) {
      const int rl = i / Tl::BN, row = r.row0 + rl, col = r.n0 + i % Tl::BN;
      if (rl < r.rows && col < p.N && (row < lo || row >= hi))
        c[(int64_t)row * p.N + col] = ftimm::from_f<TC>(0.f);
    }
    return;
  }
  if (r.rows <= 0) return;
  ftimm::tc::run_tile<Tl, false, W_MN, __nv_bfloat16, TC>(
      &tx, &tw, r.row0, r.n0, 0, p.K, false, c, p.N, r.row0 + r.rows, p.N, p.epi, r.g, -1,
      p.w3d ? r.g : -1);
}

template <class Tl, bool W_MN, typename TC>
static int launch_tc(const CUtensorMap& tx, const CUtensorMap& tw, const RaggedTcArgs& p,
                     cudaStream_t stream) {
  auto kernel = ftimm_gemm_ragged_tc_kernel<Tl, W_MN, TC>;
  constexpr int smem = Tl::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.T, ftimm::tc::BM) * ftimm::cdiv(p.N, Tl::BN), p.G + 1);
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

// The ragged tensor-core tile (kernel.py's GROUP_TC_TILE): 128 x 128, a
// 4-stage ring.
using RaggedTcTile = ftimm::tc::Tile<128, 4>;

extern "C" int ftimm_gemm_ragged_tc_launch(int device, int types, const void* x,
                                           const void* w, const int* offsets, void* c, int T,
                                           int N, int K, int G, long long sxm, long long sxk,
                                           long long swg, long long swk, long long swn,
                                           const float* scale_vec, long long scale_vec_g,
                                           int has_scale, float scale, const float* bias,
                                           long long bias_g, int act, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G + 1 > 65535) return (int)cudaErrorInvalidValue;
  using Tl = RaggedTcTile;
  CUtensorMap tx, tw;
  const int64_t gw = swg != 0 ? G : 1;
  if (ftimm::tc::encode_operand(&tx, x, T, K, sxm, sxk, ftimm::tc::BM) != 0)
    return (int)cudaErrorInvalidValue;
  const int w_mn = ftimm::tc::encode_operand(&tw, w, N, K, swn, swk, Tl::BN, gw, swg);
  if (w_mn < 0) return (int)cudaErrorInvalidValue;
  const RaggedTcArgs p{offsets, c, T, N, K, G, gw > 1,
                       ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g,
                                      act, nullptr, 0}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0)
    return w_mn ? launch_tc<Tl, true, __nv_bfloat16>(tx, tw, p, s)
                : launch_tc<Tl, false, __nv_bfloat16>(tx, tw, p, s);
  if (types == 1)
    return w_mn ? launch_tc<Tl, true, float>(tx, tw, p, s)
                : launch_tc<Tl, false, float>(tx, tw, p, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight-stream body (T <= 16 rows)
// ---------------------------------------------------------------------------

// Names this kernel's stream instantiations (and their profile entries).
struct ftimm_gemm_ragged_stream {};

extern "C" int ftimm_gemm_ragged_stream_launch(
    int device, int types, const void* x, const void* w,
    const int* offsets, void* c, int T, int N, int K, int G, long long sxm, long long sxk,
    long long swg, long long swk, long long swn, int slices, int slice, float* ws,
    int* counters, const float* scale_vec, long long scale_vec_g, int has_scale, float scale,
    const float* bias, long long bias_g, int act, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ftimm::gs::Args p{c, ws, counters, offsets, G, 0, T, N, K, slice, 0, 0,
                    ftimm::EpiArgs{scale_vec, scale_vec_g, has_scale, scale, bias, bias_g, act,
                                   nullptr, 0}};
  return ftimm::gs::launch<ftimm_gemm_ragged_stream>(types, x, T, 0, sxm, sxk, w, nullptr, swg,
                                                     swk, swn, p, slices, G + 1,
                                                     static_cast<cudaStream_t>(stream));
}
