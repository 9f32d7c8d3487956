// Grouped expert GEMMs for NVIDIA Hopper (sm_90a): the forward (gmm), also
// run for the backward's dX, and the backward's dW (tgmm, at the end of this
// file).
//
// gmm replaces mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py::
// _gmm_pallas (body _gmm_kernel). Computes, for x [T, K], w [E, K, N] and
// group_sizes [E] (each a multiple of block_t, the dispatcher's contract):
//
//     out[r, :] = x[r, :] @ w[e(r)]     for r < sum(group_sizes)
//     out[r, :] = 0                     for r >= sum(group_sizes)
//
// With w_trans set, w is read as the transpose of an [E, N, K] tensor
// (element (k, n) of expert e at w[e, n, k]): the backward's
// dX = dy @ w[e]^T reads the forward's weights in place, with no transposed
// copy. The kernels pick the order of their weight loads at compile time so
// that neighbouring threads read neighbouring addresses in either layout.
//
// where e(r) is the expert whose row group holds r. The TPU kernel clamps tail
// tiles to the last expert and multiplies the zero rows the dispatcher puts
// there; writing zeros gives the same result and reads no weights for them.
// Accumulation is always fp32; the output has x's type (fp32 or bf16).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 FMA, 989 TFLOP/s
// bf16 tensor cores), at the serving path's shapes (moe-8x40m: K, N in
// {512, 1536}, 8 experts):
//   - Decode (8 slots, top-2: 16 selections, block_t 8, T = 72) is bound by
//     weight bytes: up to 8 x 512 x 1536 x 4 B = 25 MB per gate/up call for
//     ~25 MFLOP. Each row tile reads its expert's weights once (at decode
//     an expert mostly has one tile), tail tiles read none, and fp32 8-row tiles take a
//     variant built to keep many weight loads in flight: 32-column strips
//     with K split over 16 warps (gmm_f32_decode_kernel).
//   - A 256-token fp32 prefill chunk (block_t 32, T = 768) is bound by FMA
//     throughput (1.2 GFLOP per gate/up call). Each CTA stages a 32 x 16 slice
//     of x and a 16 x 64 slice of w in shared memory and every thread keeps a
//     2 x 4 register tile, so each shared-memory load feeds two FMAs.
//   - bf16 runs the same tiling on the tensor cores through WMMA 16x16x16
//     fragments with fp32 accumulators; row tiles of 8 are zero-padded to 16.
// Not done yet (later work): TMA/wgmma pipelines, one CTA reading an expert's
// weights once for all of its row tiles, persistent scheduling.
//
// A CTA's row tile (BM rows) divides block_t, so a CTA never straddles two
// experts. Hopper has no scalar prefetch: each CTA finds its expert with a
// linear search over the E cumulative group sizes it reads itself.
//
// Interface: plain C, loaded with ctypes. gmm_forward and tgmm_backward
// return cudaGetLastError() after the launch (0 on success); neither
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;  // output columns per CTA

// Expert owning row r0 (first e with cumsum(group_sizes)[e] > r0), or -1 when
// r0 lies past the last group (tail tile).
__device__ __forceinline__ int expert_of_row(const int* __restrict__ gs, int E,
                                             int r0) {
  int end = 0;
  for (int e = 0; e < E; ++e) {
    end += gs[e];
    if (r0 < end) return e;
  }
  return -1;
}

// Element (k, n) of one expert's K x N weight block: row-major [K, N], or
// with WT the transpose of a row-major [N, K] block.
template <bool WT>
__device__ __forceinline__ size_t w_at(int k, int n, int K, int N) {
  return WT ? (size_t)n * K + k : (size_t)k * N + n;
}

// ---------------------------------------------------------------- fp32 (FMA)
// Threads: (BM / TM) x 16, each owning TM rows x 4 columns (columns strided by
// 16 so neighbouring threads hit neighbouring shared-memory banks and global
// addresses).
template <int BM, int TM, bool WT>
__global__ void gmm_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const int* __restrict__ gs,
                               float* __restrict__ out, int K, int N, int E) {
  constexpr int BK = 16;
  constexpr int TN = 4;
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 1];  // +1: the transposing store is conflict-free
  __shared__ float Bs[BK][BN];
  __shared__ int s_expert;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  if (tid == 0) s_expert = expert_of_row(gs, E, r0);
  __syncthreads();
  const int e = s_expert;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  if (e < 0) {
    for (int i = 0; i < TM; ++i)
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + j * (BN / TN);
        if (c < N) out[(size_t)(r0 + ty * TM + i) * N + c] = 0.f;
      }
    return;
  }
  const float* we = w + (size_t)e * K * N;

  float acc[TM][TN];
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int i = idx / BK, kk = idx % BK;
      const int k = k0 + kk;
      As[kk][i] = k < K ? x[(size_t)(r0 + i) * K + k] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = WT ? idx % BK : idx / BN, j = WT ? idx / BK : idx % BN;
      const int k = k0 + kk, c = c0 + j;
      Bs[kk][j] = (k < K && c < N) ? we[w_at<WT>(k, c, K, N)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + j * (BN / TN);
      if (c < N) out[(size_t)(r0 + ty * TM + i) * N + c] = acc[i][j];
    }
}

// ------------------------------------------------- fp32, 8-row decode tiles
// At decode each expert's group is one 8-row tile against K x N weights, so
// the kernel streams weights: a CTA owns 8 rows x 32 columns (one column per
// lane, so a warp reads 128 contiguous bytes of a weight row), its 16 warps
// split K (warp q takes k = q, q + 16, ...) with 8 loads in flight per lane,
// and the warps' partial sums are added in warp order through shared memory
// (deterministic). x is staged in shared memory DK columns at a time.
constexpr int DM = 8;       // rows per CTA
constexpr int DWARPS = 16;  // warps per CTA, splitting K
constexpr int DK = 256;     // K columns of x staged per pass

template <bool WT>
__global__ void __launch_bounds__(DWARPS * 32)
gmm_f32_decode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ gs, float* __restrict__ out,
                      int K, int N, int E) {
  __shared__ float xs[DM][DK];
  __shared__ float red[DWARPS][DM][32];
  __shared__ int s_expert;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = blockIdx.y * DM;
  const int c = blockIdx.x * 32 + lane;
  if (tid == 0) s_expert = expert_of_row(gs, E, r0);
  __syncthreads();
  const int e = s_expert;
  if (e < 0) {
    if (warp < DM && c < N) out[(size_t)(r0 + warp) * N + c] = 0.f;
    return;
  }
  const float* we = w + (size_t)e * K * N;

  float acc[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += DK) {
    for (int idx = tid; idx < DM * DK; idx += DWARPS * 32) {
      const int i = idx / DK, kk = idx % DK;
      xs[i][kk] = k0 + kk < K ? x[(size_t)(r0 + i) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (c < N) {
#pragma unroll 8
      for (int kk = warp; kk < DK; kk += DWARPS) {
        const int k = k0 + kk;
        const float wv = k < K ? __ldg(we + w_at<WT>(k, c, K, N)) : 0.f;
#pragma unroll
        for (int i = 0; i < DM; ++i) acc[i] = fmaf(xs[i][kk], wv, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < DM; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp < DM && c < N) {  // thread (warp, lane) sums row warp, column c
    float s = 0.f;
    for (int q = 0; q < DWARPS; ++q) s += red[q][warp][lane];
    out[(size_t)(r0 + warp) * N + c] = s;
  }
}

// ------------------------------------------------------------ bf16 (WMMA)
// One warp per 16 x 16 output fragment: (max(BM, 16) / 16) x (BN / 16) warps.
template <int BM, bool WT>
__global__ void gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ w,
                                const int* __restrict__ gs,
                                __nv_bfloat16* __restrict__ out, int K, int N,
                                int E) {
  using namespace nvcuda;
  constexpr int BMP = BM < 16 ? 16 : BM;  // rows the fragments cover
  constexpr int BK = 32;
  constexpr int LDA = BK + 8;  // padded strides (multiples of 8 halves)
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;
  constexpr int WN = BN / 16;
  constexpr int NT = (BMP / 16) * WN * 32;
  __shared__ __align__(128) __nv_bfloat16 As[BMP][LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][LDB];
  __shared__ __align__(128) float Cs[BMP][LDC];
  __shared__ int s_expert;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  if (tid == 0) s_expert = expert_of_row(gs, E, r0);
  __syncthreads();
  const int e = s_expert;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  if (e < 0) {
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int i = idx / BN, j = idx % BN;
      if (c0 + j < N) out[(size_t)(r0 + i) * N + c0 + j] = zero;
    }
    return;
  }
  const __nv_bfloat16* we = w + (size_t)e * K * N;

  const int warp = tid / 32;
  const int wr = warp / WN, wc = warp % WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BMP * BK; idx += NT) {
      const int i = idx / BK, kk = idx % BK;
      const int k = k0 + kk;
      As[i][kk] = (i < BM && k < K) ? x[(size_t)(r0 + i) * K + k] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int kk = WT ? idx % BK : idx / BN, j = WT ? idx / BK : idx % BN;
      const int k = k0 + kk, c = c0 + j;
      Bs[kk][j] = (k < K && c < N) ? we[w_at<WT>(k, c, K, N)] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, &As[wr * 16][kk], LDA);
      wmma::load_matrix_sync(fb, &Bs[kk][wc * 16], LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&Cs[wr * 16][wc * 16], acc, LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int i = idx / BN, j = idx % BN;
    if (c0 + j < N)
      out[(size_t)(r0 + i) * N + c0 + j] = __float2bfloat16(Cs[i][j]);
  }
}

template <int BM, int TM, bool WT>
void launch_f32(const void* x, const void* w, const int* gs, void* out, int T,
                int K, int N, int E, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, T / BM);
  dim3 block((BM / TM) * (BN / 4));
  gmm_f32_kernel<BM, TM, WT><<<grid, block, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gs,
      static_cast<float*>(out), K, N, E);
}

template <bool WT>
void launch_f32_decode(const void* x, const void* w, const int* gs, void* out,
                       int T, int K, int N, int E, cudaStream_t stream) {
  dim3 grid((N + 31) / 32, T / DM);
  gmm_f32_decode_kernel<WT><<<grid, DWARPS * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gs,
      static_cast<float*>(out), K, N, E);
}

template <int BM, bool WT>
void launch_bf16(const void* x, const void* w, const int* gs, void* out, int T,
                 int K, int N, int E, cudaStream_t stream) {
  constexpr int BMP = BM < 16 ? 16 : BM;
  dim3 grid((N + BN - 1) / BN, T / BM);
  dim3 block((BMP / 16) * (BN / 16) * 32);
  gmm_bf16_kernel<BM, WT><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      gs, static_cast<__nv_bfloat16*>(out), K, N, E);
}

template <bool WT>
int launch_gmm(const void* x, const void* w, const int* gs, void* out, int T,
               int K, int N, int E, int bm, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (bm) {
      case 8: launch_f32_decode<WT>(x, w, gs, out, T, K, N, E, s); break;
      case 16: launch_f32<16, 1, WT>(x, w, gs, out, T, K, N, E, s); break;
      case 32: launch_f32<32, 2, WT>(x, w, gs, out, T, K, N, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 1) {
    switch (bm) {
      case 8: launch_bf16<8, WT>(x, w, gs, out, T, K, N, E, s); break;
      case 16: launch_bf16<16, WT>(x, w, gs, out, T, K, N, E, s); break;
      case 32: launch_bf16<32, WT>(x, w, gs, out, T, K, N, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ======================================================================== tgmm
// Replaces mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py::
// _tgmm_pallas (body _tgmm_kernel), the dW half of the grouped GEMM's
// backward. For x [T, K], dy [T, N] and group_sizes [E] (multiples of
// block_t):
//
//     dw[e] = sum over e's block_t row tiles t, in order, of
//             round_out(x[t]^T @ dy[t])        (each product in fp32)
//
// with the running sum kept in the output type, as the Pallas kernel keeps
// it in its output block: the first tile initialises, each later tile adds
// its rounded partial, and the sum rounds after every add. In bf16 these
// rounding points are part of the result (accumulating a whole group in fp32
// and rounding once differs by 1-2 bf16 ulps), so block_t is the rounding
// granularity and is passed in; it is not the CTA's row step. Experts with no
// rows come out as exact zeros; rows past sum(group_sizes) are never read.
//
// Design: one CTA owns one 64 x 64 block of one expert's [K, N] output, grid
// (N/64, K/64, E); it finds its expert's first row with a prefix sum over
// group_sizes (no host sync, no scalar prefetch) and walks that expert's
// tiles in order, so there are no atomics and the result is bitwise
// reproducible. bf16 runs WMMA 16x16x16 with fp32 fragments, x read as the
// column-major A operand straight from its row-major staging; fp32 runs SIMT
// FMA tiles (TF32 would change the sums).
//
// What bounds it on an H100 SXM at the MoE training path's shapes
// (moe-8x40m, 65,536 selections in a 66,560-row buffer, K x N 512 x 1536 or
// 1536 x 512, bf16): 2 x 65,536 x 512 x 1536 = 103 GFLOP (0.104 ms at
// 989 TFLOP/s) against ~285 MB of compulsory traffic (0.085 ms at 3.35 TB/s):
// operations. Each CTA re-reads its expert's x and dy column slices, so the
// grid reads 24-8 times the compulsory bytes, mostly from L2 (a CTA's
// neighbours in launch order share its expert). Not done yet (later work):
// wgmma/TMA pipelines, larger output blocks, and splitting a hot expert's
// rows across CTAs, which would need a second pass to keep the tile order
// of the bf16 sum: a hot expert now serialises its column of CTAs.
constexpr int TB = 64;    // output block: K rows x N columns per CTA
constexpr int TBR = 32;   // bf16: rows staged per pass (two WMMA k-steps)
constexpr int TLD = TB + 8;
constexpr int TNT = 128;  // bf16: 4 warps, each a 32 x 32 quarter

// First row and row count of expert e's group.
__device__ __forceinline__ void expert_range(const int* __restrict__ gs, int e,
                                             int* start, int* rows) {
  int s = 0;
  for (int i = 0; i < e; ++i) s += gs[i];
  *start = s;
  *rows = gs[e];
}

// Stage rows [row0, row0 + live) x columns [c0, c0 + TB) of a row-major
// matrix with ld columns into dst; other rows and columns stage zeros.
// VEC: 16-byte loads (ld % 8 == 0 and a 16-byte aligned base).
template <bool VEC>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16 (*dst)[TLD],
                                           const __nv_bfloat16* __restrict__ src,
                                           int ld, size_t row0, int live, int c0,
                                           int tid) {
  if (VEC) {
    for (int idx = tid; idx < TBR * TB / 8; idx += TNT) {
      const int r = idx / (TB / 8), c = (idx % (TB / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < live && c0 + c < ld)
        v = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c0 + c);
      *reinterpret_cast<uint4*>(&dst[r][c]) = v;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < TBR * TB; idx += TNT) {
      const int r = idx / TB, c = idx % TB;
      dst[r][c] = (r < live && c0 + c < ld) ? src[(row0 + r) * ld + c0 + c]
                                            : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TNT)
tgmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ dy,
                 const int* __restrict__ gs, __nv_bfloat16* __restrict__ dw,
                 int K, int N, int block_t) {
  using namespace nvcuda;
  constexpr int LDC = TB + 4;
  constexpr int PER = TB * TB / TNT;  // output elements each thread sums
  __shared__ __align__(128) __nv_bfloat16 Xs[TBR][TLD];
  __shared__ __align__(128) __nv_bfloat16 Ds[TBR][TLD];
  __shared__ __align__(128) float Cs[TB][LDC];
  __shared__ int s_start, s_rows;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TB, k0 = blockIdx.y * TB, e = blockIdx.z;
  if (tid == 0) expert_range(gs, e, &s_start, &s_rows);
  __syncthreads();
  const int start = s_start, rows = s_rows;
  const int warp = tid / 32, wr = warp / 2, wc = warp % 2;

  __nv_bfloat16 run[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) run[p] = __float2bfloat16(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  for (int t0 = 0; t0 < rows; t0 += block_t) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int r0 = t0; r0 < t0 + block_t; r0 += TBR) {
      const int live = min(TBR, t0 + block_t - r0);
      stage_bf16<VEC>(Xs, x, K, (size_t)start + r0, live, k0, tid);
      stage_bf16<VEC>(Ds, dy, N, (size_t)start + r0, live, n0, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TBR; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &Xs[kk][wr * 32 + i * 16], TLD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Ds[kk][wc * 32 + j * 16], TLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * TNT;
      const __nv_bfloat16 part = __float2bfloat16(Cs[idx / TB][idx % TB]);
      run[p] = t0 == 0 ? part
                       : __float2bfloat16(__bfloat162float(run[p]) +
                                          __bfloat162float(part));
    }
    __syncthreads();  // Cs is rewritten by the next tile
  }
  __nv_bfloat16* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = tid + p * TNT;
    const int k = k0 + idx / TB, n = n0 + idx % TB;
    if (k < K && n < N) out[(size_t)k * N + n] = run[p];
  }
}

// fp32: 256 threads, each a 4 x 4 register tile (rows strided by 16 over K,
// columns by 16 over N), 8 rows staged per pass (block_t is a multiple of 8).
constexpr int FR = 8;

__global__ void __launch_bounds__(256)
tgmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                const int* __restrict__ gs, float* __restrict__ dw, int K,
                int N, int block_t) {
  __shared__ float Xs[FR][TB];
  __shared__ float Ds[FR][TB];
  __shared__ int s_start, s_rows;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * TB, k0 = blockIdx.y * TB, e = blockIdx.z;
  if (tid == 0) expert_range(gs, e, &s_start, &s_rows);
  __syncthreads();
  const int start = s_start, rows = s_rows;

  float run[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) run[i][j] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += block_t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int r0 = t0; r0 < t0 + block_t; r0 += FR) {
      for (int idx = tid; idx < FR * TB; idx += 256) {
        const int r = idx / TB, c = idx % TB;
        const size_t row = (size_t)start + r0 + r;
        Xs[r][c] = k0 + c < K ? x[row * K + k0 + c] : 0.f;
        Ds[r][c] = n0 + c < N ? dy[row * N + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[r][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ds[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        run[i][j] = t0 == 0 ? part[i][j] : run[i][j] + part[i][j];
  }
  float* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < K && n < N) out[(size_t)k * N + n] = run[i][j];
    }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. bm: CTA row tile, one of 8, 16, 32 (the wrapper
// picks min(block_t, 32), which divides block_t). w_trans: w is [E, N, K]
// and is read transposed (the backward's dX). Returns a cudaError_t.
extern "C" int gmm_forward(const void* x, const void* w, const int* group_sizes,
                           void* out, int T, int K, int N, int E, int bm,
                           int dtype, int w_trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || T % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return w_trans ? launch_gmm<true>(x, w, group_sizes, out, T, K, N, E, bm, dtype, s)
                 : launch_gmm<false>(x, w, group_sizes, out, T, K, N, E, bm, dtype, s);
}

// dw [E, K, N] from x [T, K] and dy [T, N] (one type: 0 = fp32, 1 = bf16).
// block_t: a multiple of 8 dividing T and every group size. Returns a
// cudaError_t.
extern "C" int tgmm_backward(const void* x, const void* dy,
                             const int* group_sizes, void* dw, int T, int K,
                             int N, int E, int block_t, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || block_t <= 0 || block_t % 8 != 0
      || T % block_t != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + TB - 1) / TB, (K + TB - 1) / TB, E);
  if (dtype == 0) {
    tgmm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        group_sizes, static_cast<float*>(dw), K, N, block_t);
  } else if (dtype == 1) {
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* db = static_cast<const __nv_bfloat16*>(dy);
    auto* out = static_cast<__nv_bfloat16*>(dw);
    if (vec)
      tgmm_bf16_kernel<true><<<grid, TNT, 0, s>>>(xb, db, group_sizes, out, K, N, block_t);
    else
      tgmm_bf16_kernel<false><<<grid, TNT, 0, s>>>(xb, db, group_sizes, out, K, N, block_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
