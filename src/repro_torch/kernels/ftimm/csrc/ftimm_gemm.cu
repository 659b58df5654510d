// ftIMM dense GEMM for Hopper: C = epi(op(A) . op(B)), trans nn / tn / nt.
//
// Replaces the TPU kernel src/repro/kernels/ftimm/kernel.py:ftimm_gemm (the
// M-parallel ftIMM strategy, paper Alg. 4, and its K-parallel strategy for a
// small M x N, Sec. IV-B).  Three bodies, one per regime; the planner
// (core/gemm/tuner.py, plan_gemm) picks one for each shape from the CMR
// model, among those the operands allow (kernel.py, gemm_bodies):
//
// * Tensor cores ("tc", ftimm_gemm_tc_launch): bf16 x bf16 with TMA-able
//   operands, large M -- training's forward, remat, dX and dW, the bucket
//   prefills, the unembed.  The body of ftimm_tc.cuh: TMA into a 4-stage
//   swizzled ring, a producer warp and two consumer warpgroups on
//   wgmma.m64n128k16, fp32 accumulators, the epilogue at the flush and
//   16-byte stores; 128 x 128 or 128 x 256 tiles, walked in dim_order.
//   Bound on the H100: the bf16 tensor-core rate (989 TFLOP/s) for the
//   square-ish training shapes, the operand bytes (3.35 TB/s) for the
//   skinny ones.
//
// * Weight stream ("stream", ftimm_gemm_stream_launch): bf16 x bf16 with
//   M <= 16 -- every decode projection, the decode routers and the decode
//   unembed.  About 0.5 FLOP per weight byte against the card's ~295 bf16
//   FLOP/byte ridge, so the weight's bytes over 3.35 TB/s are the bound
//   and the design is about keeping enough of them in flight.  An M x N
//   tile too small to fill 132 SMs is split along K (the paper's
//   K-parallel strategy): each CTA owns a 128-wide N strip and one K
//   slice, the planner choosing the slice count that gives each SM a CTA
//   (qwen's k/v projection, 2048 x 1024: 8 strips x 16 slices of 128 K
//   rows).  The CTA stages its <= 16 activation rows of the slice in
//   shared memory while its first weight loads are in flight, and streams
//   the weight with 16-byte vector loads along its unit-stride dimension,
//   8 independent loads per thread in flight: for B (K, N) with N
//   unit-stride (nn) 16 threads cover 256 contiguous bytes of a K row, 8
//   columns each, and the CTA walks 16 rows at a time; for B (N, K) with K
//   unit-stride (nt) a warp reads 512 contiguous bytes of each of 4 rows at
//   a time.  The math is fp32 FMAs on the unpacked bf16 pairs (at M = 4 a
//   3.35 TB/s stream needs 13 TFLOP/s of the 67 the CUDA cores give;
//   mma.sync with the weight as the 16-row operand was not tried).  The
//   fp32 partials of the slices go to a workspace; the last CTA of a strip
//   to finish (a per-strip counter, which it resets) sums them in slice
//   order, so reruns are bit-identical (no atomics on the
//   output), and applies the epilogue to the sum.
//
// * CUDA-core FMAs ("fma", ftimm_gemm_launch): everything else -- fp32 and
//   mixed bf16 x fp32 pairs (the fp32 cotangents of the logits and the
//   router), operands TMA cannot read (no unit-stride dimension, a
//   misaligned base or stride), and every product with a 1-byte operand
//   (the quantized matmul's forward, int8 / fp8 / weight-only int8, and
//   its straight-through dX against the 1-byte panel).  The shared strided
//   body of ftimm_common.cuh (accumulate): one CTA per tile of the
//   FTIMM_TILES menu (FTIMM_QUANT_TILES for the quantized codes), operands
//   widened in registers, staged in shared memory, CUDA-core FMAs (67
//   TFLOP/s) -- or, for int8 x int8, integer multiply-adds into an int32
//   accumulator (33.5 TOP/s), exact as the reference's int32 MXU sum.  A
//   quantized decode call (M <= 16) is bound by its weight bytes, now one
//   a weight: wgmma / the stream for 1-byte operands are later work.
//
// C interface, bound from kernel.py with ctypes.  Each entry returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a tile, type code or operand it does not take.
#include "ftimm_common.cuh"
#include "ftimm_tc.cuh"


// ---------------------------------------------------------------------------
// CUDA-core FMA body
// ---------------------------------------------------------------------------

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
  using TR = typename ftimm::ResidualOf<TA>::type;
  int m0, n0;
  ftimm::tile_coords(C::BM, C::BN, p.M, p.N, p.nm_order, m0, n0);
  typename ftimm::AccOf<TA, TB>::type acc[1][C::TM][C::TN];
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
            ftimm::from_f<TC>(ftimm::apply_epi<TR>((float)acc[0][i][j], p.epi, 0, row, col, p.N));
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

// The quantized codes, on the tiles of FTIMM_QUANT_TILES only.
template <class C>
static bool launch_quant_types(int types, const GemmArgs& p, cudaStream_t stream) {
  switch (types) {
#define FTIMM_TYPE(ID, TA, TB, TC) \
  case ID: launch<C, TA, TB, TC>(p, stream); return true;
    FTIMM_QUANT_TYPES(FTIMM_TYPE)
    FTIMM_QUANT_DX_TYPES(FTIMM_TYPE)
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

struct TcArgs {
  void* c;
  int M, N, K;
  int nm_order;
  ftimm::EpiArgs epi;
};

template <class T, bool A_MN, bool B_MN, typename TC>
__global__ void __launch_bounds__(ftimm::tc::THREADS, 1)
    ftimm_gemm_tc_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, TcArgs p) {
  int m0, n0;
  ftimm::tile_coords(ftimm::tc::BM, T::BN, p.M, p.N, p.nm_order, m0, n0);
  ftimm::tc::run_tile<T, A_MN, B_MN, __nv_bfloat16, TC>(&ta, &tb, m0, n0, 0, p.K, false,
                                                         static_cast<TC*>(p.c), p.N, p.M, p.N,
                                                         p.epi, 0);
}

template <class T, bool A_MN, bool B_MN, typename TC>
static int launch_tc(const CUtensorMap& ta, const CUtensorMap& tb, const TcArgs& p,
                     cudaStream_t stream) {
  auto kernel = ftimm_gemm_tc_kernel<T, A_MN, B_MN, TC>;
  constexpr int smem = T::SMEM;
  const cudaError_t err = ftimm::tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ftimm::cdiv(p.M, ftimm::tc::BM) * ftimm::cdiv(p.N, T::BN));
  kernel<<<grid, ftimm::tc::THREADS, smem, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

template <class T, typename TC>
static int launch_tc_layout(int a_mn, int b_mn, const CUtensorMap& ta, const CUtensorMap& tb,
                            const TcArgs& p, cudaStream_t s) {
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
                          int64_t sbk, int64_t sbn, const TcArgs& p, cudaStream_t s) {
  CUtensorMap ta, tb;
  const int a_mn = ftimm::tc::encode_operand(&ta, a, p.M, p.K, sam, sak, ftimm::tc::BM);
  const int b_mn = ftimm::tc::encode_operand(&tb, b, p.N, p.K, sbn, sbk, T::BN);
  if (a_mn < 0 || b_mn < 0) return (int)cudaErrorInvalidValue;
  if (types == 0) return launch_tc_layout<T, __nv_bfloat16>(a_mn, b_mn, ta, tb, p, s);
  if (types == 1) return launch_tc_layout<T, float>(a_mn, b_mn, ta, tb, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ftimm_gemm_tc_launch(int device, int tile, int types, const void* a,
                                    const void* b, void* c, int M, int N, int K, long long sam,
                                    long long sak, long long sbk, long long sbn, int nm_order,
                                    const float* scale_vec, int has_scale, float scale,
                                    const float* bias, int act, const void* residual,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const TcArgs p{c, M, N, K, nm_order,
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

// ---------------------------------------------------------------------------
// Weight-stream body (M <= 16, K-parallel)
// ---------------------------------------------------------------------------

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_STRIP = 128;  // output columns of one CTA

struct StreamArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  void* c;
  int M, N, K;
  int64_t sam, sak, sbk, sbn;
  int slice;      // K rows of one slice (a multiple of 64); gridDim.y slices
  float* ws;      // (slices, M, N) fp32 partials when gridDim.y > 1
  int* counters;  // one per strip, 0 between launches
  ftimm::EpiArgs epi;
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 consecutive bf16 at p, of which the first `valid` exist.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int valid) {
  if (valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = make_uint4(0, 0, 0, 0);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
  for (int j = 0; j < valid; ++j) e[j] = p[j];
  return r;
}

// Stage the slice's activation rows in shared memory: A(m, k0 + kk) at
// s[m * m_step + kk * k_step], zeros for rows m >= M and columns past kl.
template <int MT>
__device__ __forceinline__ void stage_rows(const StreamArgs& p, __nv_bfloat16* s, int k0, int kl,
                                           int kpad, bool k_inner) {
  for (int i = threadIdx.x; i < MT * kpad; i += STREAM_THREADS) {
    const int m = k_inner ? i / kpad : i % MT;
    const int kk = k_inner ? i % kpad : i / MT;
    s[i] = (m < p.M && kk < kl) ? p.a[(int64_t)m * p.sam + (int64_t)(k0 + kk) * p.sak]
                                : __float2bfloat16(0.f);
  }
}

// The CTA's (MT, STRIP) sums `out` of slice blockIdx.y: stored through the
// epilogue when K is one slice; else written as this slice's partial, and
// the last CTA of the strip to arrive sums every slice's partial in slice
// order, applies the epilogue and stores.
template <int MT, typename TC>
__device__ __forceinline__ void stream_finish(const StreamArgs& p, const float (*out)[STREAM_STRIP],
                                              int n0) {
  __shared__ int last;
  TC* c = static_cast<TC*>(p.c);
  const int S = gridDim.y, s = blockIdx.y;
  if (S == 1) {
    for (int i = threadIdx.x; i < MT * STREAM_STRIP; i += STREAM_THREADS) {
      const int m = i / STREAM_STRIP, n = n0 + i % STREAM_STRIP;
      if (m < p.M && n < p.N)
        c[(int64_t)m * p.N + n] = ftimm::from_f<TC>(
            ftimm::apply_epi<__nv_bfloat16>(out[m][i % STREAM_STRIP], p.epi, 0, m, n, p.N));
    }
    return;
  }
  for (int i = threadIdx.x; i < MT * STREAM_STRIP; i += STREAM_THREADS) {
    const int m = i / STREAM_STRIP, n = n0 + i % STREAM_STRIP;
    if (m < p.M && n < p.N) p.ws[((int64_t)s * p.M + m) * p.N + n] = out[m][i % STREAM_STRIP];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&p.counters[blockIdx.x], 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * STREAM_STRIP; i += STREAM_THREADS) {
    const int m = i / STREAM_STRIP, n = n0 + i % STREAM_STRIP;
    if (m >= p.M || n >= p.N) continue;
    float v = 0.f;
    for (int t = 0; t < S; ++t) v += __ldcg(&p.ws[((int64_t)t * p.M + m) * p.N + n]);
    c[(int64_t)m * p.N + n] =
        ftimm::from_f<TC>(ftimm::apply_epi<__nv_bfloat16>(v, p.epi, 0, m, n, p.N));
  }
  if (threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

// B (K, N) with N unit-stride: 16 threads cover the strip's 128 columns of
// one K row (256 contiguous bytes, 8 columns a thread), so the CTA walks 16
// rows at a time; a thread keeps U = 8 rows of 16-byte loads in flight.
template <int MT, typename TC>
__global__ void __launch_bounds__(STREAM_THREADS) ftimm_gemm_stream_n_kernel(StreamArgs p) {
  constexpr int U = 8, TPR = STREAM_STRIP / 8, ROWS = STREAM_THREADS / TPR;
  extern __shared__ __align__(16) unsigned char dyn[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(dyn);  // [kl][MT]
  __shared__ float red[STREAM_THREADS / 32][STREAM_STRIP];  // per row m
  __shared__ float out[MT][STREAM_STRIP];
  const int n0 = blockIdx.x * STREAM_STRIP, k0 = blockIdx.y * p.slice;
  const int kl = min(p.K - k0, p.slice);
  const int tid = threadIdx.x, cg = tid % TPR, tr = tid / TPR;
  const int col = n0 + cg * 8;
  const int valid = col < p.N ? p.N - col : 0;
  const __nv_bfloat16* bp = p.b + (int64_t)k0 * p.sbk + col;
  // The first U weight rows are in flight while the activation rows are
  // staged: the two loads' latencies overlap.
  uint4 w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = tr + ROWS * u;
    w[u] = (k < kl && valid > 0) ? load8(bp + (int64_t)k * p.sbk, valid) : make_uint4(0, 0, 0, 0);
  }
  stage_rows<MT>(p, sa, k0, kl, kl, false);
  __syncthreads();
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int kk = tr; kk < kl; kk += ROWS * U) {
    if (kk != tr) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + ROWS * u;
        w[u] = (k < kl && valid > 0) ? load8(bp + (int64_t)k * p.sbk, valid)
                                     : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = kk + ROWS * u;
      if (k < kl) {
        float f[8];
        unpack8(w[u], f);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float av = __bfloat162float(sa[k * MT + m]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(av, f[j], acc[m][j]);
        }
      }
    }
  }
  // Per row m: the warp's two K rows (lanes 16 apart), then the 8 warps in
  // warp order.
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = acc[m][j] + __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
      if (lane < TPR) red[warp][lane * 8 + j] = v;
    }
    __syncthreads();
    if (tid < STREAM_STRIP) {
      float v = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < STREAM_THREADS / 32; ++w8) v += red[w8][tid];
      out[m][tid] = v;
    }
    __syncthreads();
  }
  stream_finish<MT, TC>(p, out, n0);
}

// B (N, K) with K unit-stride: a warp owns 16 rows of the strip, taken 4 at
// a time, its lanes 8 consecutive K each (a warp reads 512 contiguous
// bytes of a row), U = 2 steps of the 4 rows' 16-byte loads in flight.
template <int MT, typename TC>
__global__ void __launch_bounds__(STREAM_THREADS) ftimm_gemm_stream_k_kernel(StreamArgs p) {
  constexpr int U = 2, R = 4, STEP = 32 * 8;
  constexpr int WARP_ROWS = STREAM_STRIP / (STREAM_THREADS / 32);
  extern __shared__ __align__(16) unsigned char dyn[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(dyn);  // [MT][kpad]
  __shared__ float out[MT][STREAM_STRIP];
  const int n0 = blockIdx.x * STREAM_STRIP, k0 = blockIdx.y * p.slice;
  const int kl = min(p.K - k0, p.slice);
  const int kpad = (kl + 7) / 8 * 8;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // The first U steps of weight loads are in flight while the activation
  // rows are staged.
  uint4 w[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane * 8 + STEP * u, n = n0 + warp * WARP_ROWS + r;
      w[u][r] = (k < kl && n < p.N) ? load8(p.b + (int64_t)n * p.sbn + k0 + k, kl - k)
                                    : make_uint4(0, 0, 0, 0);
    }
  stage_rows<MT>(p, sa, k0, kl, kpad, true);
  __syncthreads();

  for (int rg = 0; rg < WARP_ROWS; rg += R) {
    const int nr = n0 + warp * WARP_ROWS + rg;
    float acc[R][MT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

    for (int kk = lane * 8; kk < kl; kk += STEP * U) {
      if (kk != lane * 8 || rg != 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int k = kk + STEP * u, n = nr + r;
            w[u][r] = (k < kl && n < p.N) ? load8(p.b + (int64_t)n * p.sbn + k0 + k, kl - k)
                                          : make_uint4(0, 0, 0, 0);
          }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + STEP * u;
        if (k < kl) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float av[8];
            unpack8(*reinterpret_cast<const uint4*>(sa + m * kpad + k), av);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float f[8];
              unpack8(w[u][r], f);
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[r][m] = fmaf(av[j], f[j], acc[r][m]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float v = acc[r][m];
#pragma unroll
        for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) out[m][warp * WARP_ROWS + rg + r] = v;
      }
  }
  __syncthreads();
  stream_finish<MT, TC>(p, out, n0);
}

template <int MT, typename TC>
static int launch_stream(const StreamArgs& p, int slices, cudaStream_t stream) {
  const dim3 grid(ftimm::cdiv(p.N, STREAM_STRIP), slices);
  if (p.sbk == 1) {
    const size_t smem = (size_t)MT * ((p.slice + 7) / 8 * 8) * 2;
    ftimm_gemm_stream_k_kernel<MT, TC><<<grid, STREAM_THREADS, smem, stream>>>(p);
  } else {
    const size_t smem = (size_t)MT * p.slice * 2;
    ftimm_gemm_stream_n_kernel<MT, TC><<<grid, STREAM_THREADS, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int MT>
static int launch_stream_types(int types, const StreamArgs& p, int slices, cudaStream_t s) {
  if (types == 0) return launch_stream<MT, __nv_bfloat16>(p, slices, s);
  if (types == 1) return launch_stream<MT, float>(p, slices, s);
  return (int)cudaErrorInvalidValue;
}

// mt: the compiled row count (kernel.py's STREAM_ROWS) that holds M.
extern "C" int ftimm_gemm_stream_launch(int device, int mt, int types, const void* a,
                                        const void* b, void* c, int M, int N, int K,
                                        long long sam, long long sak, long long sbk,
                                        long long sbn, int slices, int slice, float* ws,
                                        int* counters, const float* scale_vec, int has_scale,
                                        float scale, const float* bias, int act,
                                        const void* residual, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // B is read with 16-byte vectors along its unit-stride dimension, K first
  // (kernel.py's tma_major rule); the other stride keeps every vector aligned.
  const bool k_unit = sbk == 1, n_unit = !k_unit && sbn == 1;
  const long long other = k_unit ? sbn : sbk;
  const int other_extent = k_unit ? N : K;
  if (M > mt || slices < 1 || slice % 64 != 0 || (int64_t)slice * (slices - 1) >= K ||
      (!n_unit && !k_unit) || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      (other_extent > 1 && other % 8 != 0) ||
      (slices > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StreamArgs p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), c,
                     M, N, K, sam, sak, sbk, sbn, slice, ws, counters,
                     ftimm::EpiArgs{scale_vec, 0, has_scale, scale, bias, 0, act, residual, 0}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 4: return launch_stream_types<4>(types, p, slices, s);
    case 8: return launch_stream_types<8>(types, p, slices, s);
    case 16: return launch_stream_types<16>(types, p, slices, s);
  }
  return (int)cudaErrorInvalidValue;
}
