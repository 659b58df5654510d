// Shared device code of the ftIMM GEMM kernels for Hopper (sm_90a).
//
// One CTA owns one (BM, BN) output tile.  It walks K in BK steps through
// shared memory and keeps its fp32 accumulators in registers: each thread
// owns a TM x TN micro-tile, strided across the CTA tile so that shared-memory
// reads and global stores of neighbouring threads touch neighbouring
// addresses.  The next K step's operand panels are staged in registers while
// the current step computes (register double buffering), so one global load
// latency per step hides behind the FMAs.
//
// Operands are addressed through element strides, op(X)(row, k) =
// X[row * s_row + k * s_k], which is how the three trans variants (nn / tn /
// nt) and a group-shared 2-D operand (group stride 0) reach one body.  The
// panel loader walks whichever of row / k has unit stride fastest, so a warp
// reads consecutive addresses in every layout.
//
// Masking: every load outside [0, rows) x [0, K) is predicated off and writes
// 0 to shared memory, on BOTH operands (0 * NaN is NaN, so masking one side
// is not enough) -- out-of-range memory is never read.  M / N edges are
// masked again at the store.  Shapes need not be tile multiples.
//
// The epilogue runs on the fp32 accumulator at the flush, in the order
// scale_vec -> scale -> bias -> activation -> residual, then the cast to the
// output type -- the order of the reference's Epilogue.apply.
//
// The dtype axis (the reference's _acc_dtype / _dot_operands): int8 x int8
// accumulates in int32 (an exact integer sum; K * 127^2 passes fp32's 2^24
// at K > 1,040, so an fp32 sum would drift from it), converted to fp32 at
// the flush, where the dequant vector (scale_vec) multiplies it.  Every
// other pair -- bf16 / fp32 with int8 (weight-only quantization), fp8 with
// fp8, bf16 / fp32 with fp8 (the straight-through dX) -- is widened to fp32
// at load (int8 and fp8 values are exact in fp32) and summed in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftimm {

using fp8e4 = __nv_fp8_e4m3;
using fp8e5 = __nv_fp8_e5m2;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }
template <> __device__ __forceinline__ float to_f<fp8e4>(fp8e4 x) { return static_cast<float>(x); }
template <> __device__ __forceinline__ float to_f<fp8e5>(fp8e5 x) { return static_cast<float>(x); }

// The accumulator type of an operand pair: int for int8 x int8, else float.
template <typename TA, typename TB> struct AccOf { using type = float; };
template <> struct AccOf<int8_t, int8_t> { using type = int; };

// An operand element widened to the accumulator type.
template <typename V, typename T> __device__ __forceinline__ V widen(T x) { return to_f(x); }
template <> __device__ __forceinline__ int widen<int, int8_t>(int8_t x) { return (int)x; }

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return a * b + acc; }

// The residual's type: A's, or fp32 when A is a 1-byte quantized operand
// (the wrapper widens the caller's bf16 / fp32 residual to fp32, exactly).
template <typename TA> struct ResidualOf { using type = TA; };
template <> struct ResidualOf<int8_t> { using type = float; };
template <> struct ResidualOf<fp8e4> { using type = float; };
template <> struct ResidualOf<fp8e5> { using type = float; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// The compiled tile menu.  The planner (core/gemm/tuner.py) chooses among
// exactly these; kernel.py's TILES lists them in the same order.
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
};
using Tile0 = TileCfg<16, 32, 64, 2, 2>;     // skinny M (decode): most CTAs
using Tile1 = TileCfg<32, 64, 32, 2, 4>;
using Tile2 = TileCfg<64, 64, 32, 4, 4>;
using Tile3 = TileCfg<128, 128, 16, 8, 8>;   // large M: most reuse per byte

// Each kernel's C entry switches over these tile ids and, inside, over the
// operand type codes shared with kernel.py (_TYPE_CODES): code, A, B -> C.
// Codes 0-2 pair operands of one type; every kernel takes them.  Codes 3-6
// pair a bf16 operand with an fp32 one -- in the backward an fp32 cotangent
// (of the fp32 logits or router scores) meets bf16 weights or activations --
// and are taken by the kernels whose two operands are independent (dense,
// grouped, ragged, ragged dW, split-K).  Loads convert either type to fp32,
// so a mixed product is the fp32 product of the exact operand values.  The
// residual has A's type.
#define FTIMM_TILES(X) X(0, ftimm::Tile0) X(1, ftimm::Tile1) X(2, ftimm::Tile2) X(3, ftimm::Tile3)
#define FTIMM_TYPES(X)                              \
  X(0, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16) \
  X(1, __nv_bfloat16, __nv_bfloat16, float)         \
  X(2, float, float, float)
#define FTIMM_MIXED_TYPES(X)                \
  X(3, __nv_bfloat16, float, __nv_bfloat16) \
  X(4, __nv_bfloat16, float, float)         \
  X(5, float, __nv_bfloat16, __nv_bfloat16) \
  X(6, float, __nv_bfloat16, float)
// Codes 7-16 are the quantized forward products, taken by the dense and
// ragged kernels' FMA bodies only: weight-only (bf16 / fp32 x int8), full
// int8 (int8 x int8, int32 accumulator) and fp8 (e4m3 x e4m3, e5m2 x e5m2),
// each to bf16 or fp32.  Codes 17-20 are the straight-through dX of the
// dense kernel: a bf16 / fp32 cotangent against the fp8 panel ("nt"), to
// fp32 (the int8 panel's dX is code 8 or 10).  They are compiled for the
// tiles of FTIMM_QUANT_TILES only, the menu the planner gives a call with
// a 1-byte operand (kernel.py, QUANT_TILES).
#define FTIMM_QUANT_TYPES(X)               \
  X(7, __nv_bfloat16, int8_t, __nv_bfloat16) \
  X(8, __nv_bfloat16, int8_t, float)         \
  X(9, float, int8_t, __nv_bfloat16)         \
  X(10, float, int8_t, float)                \
  X(11, int8_t, int8_t, __nv_bfloat16)       \
  X(12, int8_t, int8_t, float)               \
  X(13, ftimm::fp8e4, ftimm::fp8e4, __nv_bfloat16) \
  X(14, ftimm::fp8e4, ftimm::fp8e4, float)   \
  X(15, ftimm::fp8e5, ftimm::fp8e5, __nv_bfloat16) \
  X(16, ftimm::fp8e5, ftimm::fp8e5, float)
#define FTIMM_QUANT_DX_TYPES(X)        \
  X(17, __nv_bfloat16, ftimm::fp8e4, float) \
  X(18, float, ftimm::fp8e4, float)      \
  X(19, __nv_bfloat16, ftimm::fp8e5, float) \
  X(20, float, ftimm::fp8e5, float)
#define FTIMM_QUANT_TILES(X) X(0, ftimm::Tile0) X(2, ftimm::Tile2)

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ROWS x BK panel of one operand for one K step, staged in registers as
// the accumulator type V.
template <int ROWS, int BK, int THREADS, typename T, typename V = float>
struct Panel {
  static_assert((ROWS * BK) % THREADS == 0, "panel must split evenly over the CTA");
  static constexpr int PER = ROWS * BK / THREADS;
  V r[PER];

  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t s_row, int64_t s_k,
                                       int row0, int rows, int k0, int K, bool k_fast,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      const int rr = k_fast ? idx / BK : idx % ROWS;
      const int kk = k_fast ? idx % BK : idx / ROWS;
      const int gr = row0 + rr, gk = k0 + kk;
      r[i] = (gr < rows && gk < K) ? widen<V>(p[(int64_t)gr * s_row + (int64_t)gk * s_k]) : V(0);
    }
  }

  // Shared layout [BK][ROWS + 1]: the odd row pitch keeps both walk orders
  // free of bank conflicts.
  __device__ __forceinline__ void store(V (*s)[ROWS + 1], bool k_fast, int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * THREADS;
      const int rr = k_fast ? idx / BK : idx % ROWS;
      const int kk = k_fast ? idx % BK : idx / ROWS;
      s[kk][rr] = r[i];
    }
  }
};

// acc[nb] += op(A)[m0:m0+BM, :] . op(B_nb)[:, n0:n0+BN] for NB panels B_nb
// that share the A panel (NB = 2 is the fused SwiGLU pair).  Acc is the
// pair's accumulator type (AccOf): the panels are staged in it.
template <class C, int NB, typename Acc, typename TA, typename TB>
__device__ __forceinline__ void accumulate(Acc (&acc)[NB][C::TM][C::TN],
                                           const TA* __restrict__ a, int64_t sam, int64_t sak,
                                           const TB* const (&b)[NB], int64_t sbk, int64_t sbn,
                                           int M, int N, int K, int m0, int n0) {
  __shared__ Acc sA[C::BK][C::BM + 1];
  __shared__ Acc sB[NB][C::BK][C::BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (C::BN / C::TN);
  const int ty = tid / (C::BN / C::TN);
  const bool a_kfast = (sak == 1);
  const bool b_kfast = (sbk == 1);

#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[nb][i][j] = Acc(0);

  Panel<C::BM, C::BK, C::THREADS, TA, Acc> pa;
  Panel<C::BN, C::BK, C::THREADS, TB, Acc> pb[NB];
  pa.load(a, sam, sak, m0, M, 0, K, a_kfast, tid);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) pb[nb].load(b[nb], sbn, sbk, n0, N, 0, K, b_kfast, tid);

  for (int k0 = 0; k0 < K; k0 += C::BK) {
    __syncthreads();  // the previous step's reads of shared memory are done
    pa.store(sA, a_kfast, tid);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pb[nb].store(sB[nb], b_kfast, tid);
    __syncthreads();
    if (k0 + C::BK < K) {  // stage the next step while this one computes
      pa.load(a, sam, sak, m0, M, k0 + C::BK, K, a_kfast, tid);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        pb[nb].load(b[nb], sbn, sbk, n0, N, k0 + C::BK, K, b_kfast, tid);
    }
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      Acc av[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) av[i] = sA[kk][ty + i * (C::BM / C::TM)];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          const Acc bv = sB[nb][kk][tx + j * (C::BN / C::TN)];
#pragma unroll
          for (int i = 0; i < C::TM; ++i) acc[nb][i][j] = mac(av[i], bv, acc[nb][i][j]);
        }
    }
  }
}

// Flush-time epilogue operands.  Vectors are fp32 (N,) shared by every group
// (group stride 0) or (G, N) per group (group stride N).
struct EpiArgs {
  const float* scale_vec;
  int64_t scale_vec_g;
  int has_scale;
  float scale;
  const float* bias;
  int64_t bias_g;
  int act;               // 0 none, 1 silu, 2 gelu (tanh form)
  const void* residual;  // (G, M, N) contiguous, the operands' type
  int64_t res_g;
};

template <typename TR>
__device__ __forceinline__ float apply_epi(float v, const EpiArgs& e, int g, int row, int col,
                                           int N) {
  if (e.scale_vec) v *= e.scale_vec[g * e.scale_vec_g + col];
  if (e.has_scale) v *= e.scale;
  if (e.bias) v += e.bias[g * e.bias_g + col];
  if (e.act == 1) {
    v = v * (1.f / (1.f + expf(-v)));
  } else if (e.act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    v = 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (e.residual)
    v += to_f(static_cast<const TR*>(e.residual)[g * e.res_g + (int64_t)row * N + col]);
  return v;
}

// The SwiGLU pair's flush: silu(g) * u on the fp32 pre-activations.
__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// Which output tile tile t is: t walks the (M, N) tile grid with M outer
// ("mn") or N outer ("nm"), the reference's dim_order.
__device__ __forceinline__ void tile_coords_of(int t, int BM, int BN, int M, int N, int nm_order,
                                               int& m0, int& n0) {
  const int gm = cdiv(M, BM), gn = cdiv(N, BN);
  const int mt = nm_order ? t % gm : t / gn;
  const int nt = nm_order ? t / gm : t % gn;
  m0 = mt * BM;
  n0 = nt * BN;
}

// The output tile this CTA owns: tile blockIdx.x.
__device__ __forceinline__ void tile_coords(int BM, int BN, int M, int N, int nm_order, int& m0,
                                            int& n0) {
  tile_coords_of(blockIdx.x, BM, BN, M, N, nm_order, m0, n0);
}

// The ragged kernels' grid: blockIdx.x = (row chunk, N tile) with N inner,
// blockIdx.y = the group, and one more y slot (== G) that zero-fills the rows
// no group owns.  Group g's rows are [offsets[g], offsets[g + 1]), read from
// device memory by the CTA itself (no host round trip).  A CTA of group g
// owns rows row0 .. row0 + rows - 1 with row0 = offsets[g] + chunk * BM, so
// every output row is written by exactly one CTA per N tile: no atomics, no
// read-modify-write, no ordering between CTAs.  A CTA past its group's last
// row returns before it loads anything, so an empty group reads no panel.
// Offsets are clamped to [0, T]: a malformed array can give wrong rows but
// never an access outside x or the output.
struct RaggedChunk {
  int g;     // group, or G for the zero-fill CTA
  int n0;    // first column of the N tile
  int row0;  // first row of the chunk
  int rows;  // rows of the chunk this CTA owns (<= BM); 0 = nothing to do
};

__device__ __forceinline__ RaggedChunk ragged_chunk(int BM, int BN, int N, int T, int G,
                                                    const int* __restrict__ offsets) {
  const int gn = cdiv(N, BN);
  const int chunk = blockIdx.x / gn;
  RaggedChunk r;
  r.g = blockIdx.y;
  r.n0 = (blockIdx.x % gn) * BN;
  if (r.g == G) {  // zero-fill: rows of this chunk outside [offsets[0], offsets[G])
    r.row0 = chunk * BM;
    r.rows = min(BM, T - r.row0);
    return r;
  }
  const int lo = min(max(offsets[r.g], 0), T);
  const int hi = min(max(offsets[r.g + 1], lo), T);
  r.row0 = lo + chunk * BM;
  r.rows = min(BM, hi - r.row0);
  return r;
}

// The zero-fill CTA's store: rows of its chunk that no group owns.
template <class C, typename TC>
__device__ __forceinline__ void ragged_zero_fill(TC* __restrict__ c, const RaggedChunk& r, int N,
                                                 int T, int G, const int* __restrict__ offsets) {
  const int lo = min(max(offsets[0], 0), T);
  const int hi = min(max(offsets[G], lo), T);
  const int tx = threadIdx.x % (C::BN / C::TN);
  const int ty = threadIdx.x / (C::BN / C::TN);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = r.row0 + ty + i * (C::BM / C::TM);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int col = r.n0 + tx + j * (C::BN / C::TN);
      if (ty + i * (C::BM / C::TM) < r.rows && col < N && (row < lo || row >= hi))
        c[(int64_t)row * N + col] = from_f<TC>(0.f);
    }
  }
}

}  // namespace ftimm
