// Few-rows fp32 stream of the grouped ftIMM kernel for Hopper (sm_90a): the
// decode attention products ("rows").  fp32 x fp32 -> fp32, at most MAX_M = 8
// rows a group, trans "nt" (QK^T: K = head_dim, N = the cache rows) or "nn"
// (PV: K = the cache rows, N = head_dim).
//
// What bounds it: at decode each group multiplies 1-8 query rows against its
// cache view, so every cache byte feeds at most 8 FMAs -- the fp32 K / V
// bytes over 3.35 TB/s are the bound.  The products stay in full fp32 (the
// reference's are; TF32 would change the numerics), so the tensor cores are
// out and the design is about reading the cache once, fast, across enough
// CTAs:
//
//   * B is the stream, A stays on chip.  B's rows -- the cache's head_dim
//     vectors, unit stride along the row, rows and groups 16-byte aligned --
//     are read once from device memory with 16-byte cp.async copies into a
//     per-warp ring of STAGES stages (2 KB a stage; each lane reads back only
//     the words it copied, so no barrier orders the ring).  A group's A
//     (at most 8 rows) is loaded once per CTA: "nt" into registers (the
//     lane's head_dim slices of every row), "nn" into shared memory (the
//     rows' probabilities over the CTA's K slice).  Each B element feeds all
//     M rows in registers; M is a template parameter, so no lane computes a
//     padding row.
//   * Lanes take float4 slices of a row: LPR lanes a row (16 for rows of at
//     most 64 floats, else 32), J float4s a lane (2 for rows of 129-256
//     floats); WIDTH = 4 * LPR * J floats.  "nt": a CTA takes one group and a
//     strip of `span` cache rows, its warps take rows; each of the M dot
//     products ends in an xor-shuffle reduction over the row's lanes (a
//     fixed order), and K past WIDTH is cut into K slices of WIDTH.  "nn": a
//     CTA takes one group, a WIDTH-wide column strip and a K slice of `span`
//     cache rows; warps take rows, and the warps' partials are summed in
//     shared memory in warp order.
//   * K slices without atomics on the output: with more than one slice each
//     CTA writes its fp32 partial to a workspace; the last CTA of a (group,
//     tile) to arrive (a counter, which it resets) sums the partials in slice
//     order and applies the epilogue, so reruns are bit-identical.
//   * Masking: the K remainder is masked on both operands (0 x NaN = NaN):
//     "nt" A's slices past k_hi load 0 and B's float4 copies past k_hi copy 0
//     bytes (cp.async zero-fills the rest of the 16); "nn" A's rows past k_hi
//     load 0 and B's rows past k_hi copy nothing.  The M edge is the template
//     M, the N edge is masked at the copy and at the store; memory outside
//     the operands is never read.
//   * The epilogue runs on the fp32 sum at the flush (ftimm::apply_epi:
//     scale_vec -> scale -> bias -> activation -> residual).
#pragma once

#include "ftimm_common.cuh"

namespace ftimm {
namespace rows {

constexpr int MAX_M = 8;        // kernel.py's ROWS_MAX
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;       // a warp's cp.async ring
constexpr int STAGE_F4 = 128;   // float4s of one warp's stage: 2 KB
constexpr int RING_BYTES = WARPS * STAGES * STAGE_F4 * 16;  // 64 KB
constexpr int SPAN_MAX = 2048;  // "nn": cache rows of one K slice (kernel.py's ROWS_SPAN_MAX)

struct Args {
  const float* a;
  const float* b;
  float* c;               // (G, M, N)
  float* ws;              // (slices, G, M, N) fp32 partials when gridDim.y > 1
  int* counters;          // G x gridDim.x, 0 between launches
  int G, M, N, K;
  int64_t sag, sam, sak;  // op(A)(m, k) = a[g * sag + m * sam + k * sak]
  int64_t sbg, sbr;       // row r of group g's B starts at b + g * sbg + r * sbr
  int span;               // "nt": cache rows (N) of a CTA; "nn": K rows of a slice
  EpiArgs epi;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of the float4 at element e of a row whose elements end at hi: 16, a
// 4-12 byte tail, or 0.
__device__ __forceinline__ int tail_bytes(int e, int hi) { return 4 * min(max(hi - e, 0), 4); }

// One warp's view of the rows it streams: rows [r_lo, r_hi) of the CTA in
// row steps of RPW rows (one a half-warp when LPR = 16), step i taken by
// warp i % WARPS, U steps a stage.  Lane (sub, q) copies the J float4s at
// elements e0 + 4 * (q + LPR * j) of row r_lo + RPW * i + sub.
template <int LPR, int J>
struct Stream {
  static constexpr int RPW = 32 / LPR;
  static constexpr int U = STAGE_F4 / (32 * J);
  const float* bg;
  int64_t sbr;
  int r_lo, r_hi, e0, e_hi;
  int steps;      // row steps of this warp
  int sub, q, w;
  uint32_t ring;  // this warp's STAGES x STAGE_F4 float4s

  __device__ __forceinline__ int stages() const { return cdiv(steps, U); }
  __device__ __forceinline__ int row(int t, int u) const {
    return r_lo + RPW * (w + WARPS * (t * U + u)) + sub;
  }
  __device__ __forceinline__ bool live(int t, int u) const {
    return t * U + u < steps && row(t, u) < r_hi;
  }
  __device__ __forceinline__ uint32_t slot(int t, int u, int j) const {
    return ring + (((t % STAGES) * STAGE_F4) + (u * J + j) * 32 + (threadIdx.x % 32)) * 16;
  }
  // Stage t's copies (a stage past the warp's last is an empty group).
  __device__ __forceinline__ void issue(int t) const {
    if (t < stages()) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = row(t, u);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int e = e0 + 4 * (q + LPR * j);
          // Rows past r_hi and elements past e_hi are not read: the
          // copy's missing bytes are zeros.
          const int bytes = t * U + u < steps && r < r_hi ? tail_bytes(e, e_hi) : 0;
          cp_async16(slot(t, u, j), bytes ? bg + r * sbr + e : bg, bytes);
        }
      }
    }
    cp_commit();
  }
  __device__ __forceinline__ float4 read(int t, int u, int j) const {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(slot(t, u, j))
                 : "memory");
    return v;
  }
};

template <int LPR, int J>
__device__ __forceinline__ Stream<LPR, J> make_stream(const Args& p, int g, int r_lo, int r_hi,
                                                      int e0, int e_hi, uint32_t ring0) {
  Stream<LPR, J> s;
  const int lane = threadIdx.x % 32;
  s.w = threadIdx.x / 32;
  s.sub = lane / LPR;
  s.q = lane % LPR;
  s.bg = p.b + g * p.sbg;
  s.sbr = p.sbr;
  s.r_lo = r_lo;
  s.r_hi = r_hi;
  s.e0 = e0;
  s.e_hi = e_hi;
  const int all = r_hi > r_lo ? cdiv(r_hi - r_lo, Stream<LPR, J>::RPW) : 0;
  s.steps = all > s.w ? cdiv(all - s.w, WARPS) : 0;
  s.ring = ring0 + s.w * STAGES * STAGE_F4 * 16;
  return s;
}

// Slices past the first: publish this CTA's partials (already in p.ws), and
// if it is the last of its (group, tile) to arrive, sum every slice's in
// slice order over columns [lo, hi) of the group's M rows, apply the
// epilogue and store.  Returns after resetting the counter.
template <int M>
__device__ __forceinline__ void reduce_slices(const Args& p, int g, int lo, int hi) {
  __shared__ int last;
  const int S = gridDim.y;
  __threadfence();
  __syncthreads();
  int* counter = p.counters + (int64_t)g * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int w = hi - lo;
  for (int i = threadIdx.x; i < M * w; i += THREADS) {
    const int m = i / w, n = lo + i % w;
    float v = 0.f;
    for (int sl = 0; sl < S; ++sl)
      v += __ldcg(&p.ws[(((int64_t)sl * p.G + g) * M + m) * p.N + n]);
    p.c[((int64_t)g * M + m) * p.N + n] = apply_epi<float>(v, p.epi, g, m, n, p.N);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// "nt": C[g](m, r) = sum_k A(m, k) B_r(k) over the strip of cache rows r of
// CTA blockIdx.x and the K slice [WIDTH * blockIdx.y, + WIDTH).
template <int M, int LPR, int J>
__global__ void __launch_bounds__(THREADS) ftimm_gemm_grouped_rows_nt_kernel(Args p) {
  extern __shared__ float4 ring_f4[];
  constexpr int WIDTH = 4 * LPR * J;
  const int g = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int r_lo = blockIdx.x * p.span, r_hi = min(p.N, r_lo + p.span);
  const int k_lo = s * WIDTH, k_hi = min(p.K, k_lo + WIDTH);
  Stream<LPR, J> st = make_stream<LPR, J>(p, g, r_lo, r_hi, k_lo, k_hi,
                                          static_cast<uint32_t>(__cvta_generic_to_shared(ring_f4)));
  // A stays in registers: this lane's float4 slices of every row.
  const float* ga = p.a + g * p.sag;
  float a[M][J][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k_lo + 4 * (st.q + LPR * j) + e;
        a[m][j][e] = k < k_hi ? ga[m * p.sam + k * p.sak] : 0.f;
      }

  const int T = st.stages();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) st.issue(t);
  for (int t = 0; t < T; ++t) {
    cp_wait<STAGES - 2>();
    float4 v[Stream<LPR, J>::U][J];
#pragma unroll
    for (int u = 0; u < Stream<LPR, J>::U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) v[u][j] = st.read(t, u, j);
    st.issue(t + STAGES - 1);  // refills the slot stage t - 1 emptied
#pragma unroll
    for (int u = 0; u < Stream<LPR, J>::U; ++u) {
      float part[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          x = fmaf(a[m][j][0], v[u][j].x, x);
          x = fmaf(a[m][j][1], v[u][j].y, x);
          x = fmaf(a[m][j][2], v[u][j].z, x);
          x = fmaf(a[m][j][3], v[u][j].w, x);
        }
        part[m] = x;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int m = 0; m < M; ++m) part[m] += __shfl_xor_sync(0xffffffffu, part[m], off);
      // Lane q of the row stores row m = q of the M sums.
      float mine = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) mine = st.q == m ? part[m] : mine;
      const int r = st.row(t, u);
      if (st.q < M && st.live(t, u)) {
        if (S == 1)
          p.c[((int64_t)g * M + st.q) * p.N + r] = apply_epi<float>(mine, p.epi, g, st.q, r, p.N);
        else
          p.ws[(((int64_t)s * p.G + g) * M + st.q) * p.N + r] = mine;
      }
    }
  }
  cp_wait<0>();
  if (S > 1) reduce_slices<M>(p, g, r_lo, r_hi);
}

// "nn": C[g](m, n) = sum_r A(m, r) B_r(n) over the WIDTH-wide column strip
// of CTA blockIdx.x and the K slice of `span` cache rows blockIdx.y.
template <int M, int LPR, int J>
__global__ void __launch_bounds__(THREADS) ftimm_gemm_grouped_rows_nn_kernel(Args p) {
  extern __shared__ float4 ring_f4[];
  constexpr int WIDTH = 4 * LPR * J;
  constexpr int RPW = 32 / LPR;
  static_assert(WARPS * RPW * M * WIDTH * 4 <= RING_BYTES, "the warps' partials fit the ring");
  const int g = blockIdx.z, s = blockIdx.y, S = gridDim.y;
  const int n0 = blockIdx.x * WIDTH;
  const int k_lo = s * p.span, k_hi = min(p.K, k_lo + p.span);
  float* ring = reinterpret_cast<float*>(ring_f4);
  float* sa = ring + RING_BYTES / 4;  // (M, span): A over this K slice
  Stream<LPR, J> st = make_stream<LPR, J>(p, g, k_lo, k_hi, n0, p.N,
                                          static_cast<uint32_t>(__cvta_generic_to_shared(ring_f4)));
  const float* ga = p.a + g * p.sag;
  for (int i = threadIdx.x; i < M * p.span; i += THREADS) {
    const int m = i / p.span, r = k_lo + i % p.span;
    sa[i] = r < k_hi ? ga[m * p.sam + r * p.sak] : 0.f;
  }
  const int T = st.stages();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) st.issue(t);
  __syncthreads();  // A is staged

  float acc[M][J][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int t = 0; t < T; ++t) {
    cp_wait<STAGES - 2>();
    float4 v[Stream<LPR, J>::U][J];
#pragma unroll
    for (int u = 0; u < Stream<LPR, J>::U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) v[u][j] = st.read(t, u, j);
    st.issue(t + STAGES - 1);
#pragma unroll
    for (int u = 0; u < Stream<LPR, J>::U; ++u) {
      if (!st.live(t, u)) continue;
      const int rr = st.row(t, u) - k_lo;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float am = sa[m * p.span + rr];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          acc[m][j][0] = fmaf(am, v[u][j].x, acc[m][j][0]);
          acc[m][j][1] = fmaf(am, v[u][j].y, acc[m][j][1]);
          acc[m][j][2] = fmaf(am, v[u][j].z, acc[m][j][2]);
          acc[m][j][3] = fmaf(am, v[u][j].w, acc[m][j][3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it
  // Partials (WARPS x RPW, M, WIDTH), summed in warp order.
  const int part = st.w * RPW + st.sub;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ring[(part * M + m) * WIDTH + 4 * (st.q + LPR * j) + e] = acc[m][j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < M * WIDTH; i += THREADS) {
    const int m = i / WIDTH, n = n0 + i % WIDTH;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS * RPW; ++w) v += ring[(w * M + m) * WIDTH + i % WIDTH];
    if (n >= p.N) continue;
    if (S == 1)
      p.c[((int64_t)g * M + m) * p.N + n] = apply_epi<float>(v, p.epi, g, m, n, p.N);
    else
      p.ws[(((int64_t)s * p.G + g) * M + m) * p.N + n] = v;
  }
  if (S > 1) reduce_slices<M>(p, g, n0, min(p.N, n0 + WIDTH));
}

// The largest dynamic shared memory a kernel may take is set once per
// device and kernel (RING_BYTES and "nn"'s A at SPAN_MAX rows): the
// attribute call is host time that every decode step would pay again.
constexpr int SMEM_MAX = RING_BYTES + MAX_M * SPAN_MAX * 4;
constexpr int DEVICES = 64;

template <int M, int LPR, int J>
static int launch_one(bool nt, const Args& p, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = nt ? ftimm_gemm_grouped_rows_nt_kernel<M, LPR, J>
                   : ftimm_gemm_grouped_rows_nn_kernel<M, LPR, J>;
  static bool allowed[DEVICES][2];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= DEVICES || !allowed[device][nt]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (device < DEVICES) allowed[device][nt] = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int M>
static int launch_width(int width, bool nt, const Args& p, dim3 grid, int smem, cudaStream_t s) {
  if (width == 64) return launch_one<M, 16, 1>(nt, p, grid, smem, s);
  if (width == 128) return launch_one<M, 32, 1>(nt, p, grid, smem, s);
  return launch_one<M, 32, 2>(nt, p, grid, smem, s);
}

// Check what the body takes (kernel.py's grouped_bodies / rows_operand rule)
// and launch: "nt" (nt = 1) on a grid of (strips of `span` cache rows,
// K slices of `width`, G); "nn" on (strips of `width` columns, K slices of
// `span` rows, G).  B: op(B)(k, n) = b[g * sbg + k * sbk + n * sbn]; its rows
// (n for "nt", k for "nn") must have a unit stride along them, and b, the
// row stride and the group stride must be 16-byte aligned.  Returns
// cudaErrorInvalidValue for what the body does not take.
static inline int launch(int types, const void* a, const void* b, void* c, int G, int M, int N,
                         int K, int64_t sag, int64_t sam, int64_t sak, int64_t sbg, int64_t sbk,
                         int64_t sbn, int nt, int width, int span, float* ws, int* counters,
                         EpiArgs epi, cudaStream_t stream) {
  const int64_t unit = nt ? sbk : sbn, sbr = nt ? sbn : sbk;
  const int length = nt ? K : N, rows = nt ? N : K;
  const int64_t tiles = cdiv(N, nt ? span : width);
  const int64_t slices = nt ? max(cdiv(K, width), 1) : max(cdiv(K, span), 1);
  if (types != 2 || M < 1 || M > MAX_M || G < 1 || G > 65535 || N < 1 || K < 0 || span < 1 ||
      (width != 64 && width != 128 && width != 256) || (!nt && span > SPAN_MAX) ||
      (length > 1 && unit != 1) || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      (rows > 1 && sbr % 4 != 0) || (G > 1 && sbg % 4 != 0) || tiles > 0x7fffffff ||
      slices > 65535 || (slices > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(c), ws, counters, G, M, N, K, sag, sam, sak, sbg, sbr, span,
               epi};
  const dim3 grid((unsigned)tiles, (unsigned)slices, G);
  const int smem = RING_BYTES + (nt ? 0 : M * span * 4);
  switch (M) {
    case 1: return launch_width<1>(width, nt, p, grid, smem, stream);
    case 2: return launch_width<2>(width, nt, p, grid, smem, stream);
    case 3: return launch_width<3>(width, nt, p, grid, smem, stream);
    case 4: return launch_width<4>(width, nt, p, grid, smem, stream);
    case 5: return launch_width<5>(width, nt, p, grid, smem, stream);
    case 6: return launch_width<6>(width, nt, p, grid, smem, stream);
    case 7: return launch_width<7>(width, nt, p, grid, smem, stream);
    default: return launch_width<8>(width, nt, p, grid, smem, stream);
  }
}

}  // namespace rows
}  // namespace ftimm
