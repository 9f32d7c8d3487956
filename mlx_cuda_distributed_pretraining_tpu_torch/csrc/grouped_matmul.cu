// Grouped expert GEMM (gmm) forward for NVIDIA Hopper (sm_90a).
//
// Replaces mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py::_gmm_pallas
// (body _gmm_kernel). Computes, for x [T, K], w [E, K, N] and group_sizes [E]
// (each a multiple of block_t, the dispatcher's contract):
//
//     out[r, :] = x[r, :] @ w[e(r)]     for r < sum(group_sizes)
//     out[r, :] = 0                     for r >= sum(group_sizes)
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
// Interface: plain C, loaded with ctypes. gmm_forward returns
// cudaGetLastError() after the launch (0 on success); it never synchronises.

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

// ---------------------------------------------------------------- fp32 (FMA)
// Threads: (BM / TM) x 16, each owning TM rows x 4 columns (columns strided by
// 16 so neighbouring threads hit neighbouring shared-memory banks and global
// addresses).
template <int BM, int TM>
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
      const int kk = idx / BN, j = idx % BN;
      const int k = k0 + kk, c = c0 + j;
      Bs[kk][j] = (k < K && c < N) ? we[(size_t)k * N + c] : 0.f;
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
        const float wv = k < K ? __ldg(we + (size_t)k * N + c) : 0.f;
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
template <int BM>
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
      const int kk = idx / BN, j = idx % BN;
      const int k = k0 + kk, c = c0 + j;
      Bs[kk][j] = (k < K && c < N) ? we[(size_t)k * N + c] : zero;
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

template <int BM, int TM>
void launch_f32(const void* x, const void* w, const int* gs, void* out, int T,
                int K, int N, int E, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, T / BM);
  dim3 block((BM / TM) * (BN / 4));
  gmm_f32_kernel<BM, TM><<<grid, block, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gs,
      static_cast<float*>(out), K, N, E);
}

void launch_f32_decode(const void* x, const void* w, const int* gs, void* out,
                       int T, int K, int N, int E, cudaStream_t stream) {
  dim3 grid((N + 31) / 32, T / DM);
  gmm_f32_decode_kernel<<<grid, DWARPS * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), gs,
      static_cast<float*>(out), K, N, E);
}

template <int BM>
void launch_bf16(const void* x, const void* w, const int* gs, void* out, int T,
                 int K, int N, int E, cudaStream_t stream) {
  constexpr int BMP = BM < 16 ? 16 : BM;
  dim3 grid((N + BN - 1) / BN, T / BM);
  dim3 block((BMP / 16) * (BN / 16) * 32);
  gmm_bf16_kernel<BM><<<grid, block, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      gs, static_cast<__nv_bfloat16*>(out), K, N, E);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. bm: CTA row tile, one of 8, 16, 32 (the wrapper
// picks min(block_t, 32), which divides block_t). Returns a cudaError_t.
extern "C" int gmm_forward(const void* x, const void* w, const int* group_sizes,
                           void* out, int T, int K, int N, int E, int bm,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || T % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (bm) {
      case 8: launch_f32_decode(x, w, group_sizes, out, T, K, N, E, s); break;
      case 16: launch_f32<16, 1>(x, w, group_sizes, out, T, K, N, E, s); break;
      case 32: launch_f32<32, 2>(x, w, group_sizes, out, T, K, N, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 1) {
    switch (bm) {
      case 8: launch_bf16<8>(x, w, group_sizes, out, T, K, N, E, s); break;
      case 16: launch_bf16<16>(x, w, group_sizes, out, T, K, N, E, s); break;
      case 32: launch_bf16<32>(x, w, group_sizes, out, T, K, N, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
