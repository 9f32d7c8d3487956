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
//   - bf16 with block_t < 64 (or shapes outside TMA's rules) runs the same
//     tiling on the tensor cores through WMMA 16x16x16 fragments with fp32
//     accumulators; row tiles of 8 are zero-padded to 16.
//   - bf16 at the training path's shapes (block_t a multiple of 64) runs
//     gmm_bf16_wgmma_kernel: a TMA ring feeding wgmma (its own note below).
//
// Variants, chosen by the wrapper before launch (ops/grouped_matmul.py::
// gmm_variant; the bm argument of gmm_forward carries the choice):
//   "f32_decode" fp32, bm 8         gmm_f32_decode_kernel
//   "f32"        fp32, bm 16 / 32   gmm_f32_kernel
//   "wmma"       bf16, bm 8-32      gmm_bf16_kernel
//   "wgmma"      bf16, bm 64 / 128  gmm_bf16_wgmma_kernel
//
// A CTA's row tile (BM rows) divides block_t, so a CTA never straddles two
// experts. Hopper has no scalar prefetch: each CTA finds its expert with a
// linear search over the E cumulative group sizes it reads itself.
//
// Interface: plain C, loaded with ctypes. gmm_forward and tgmm_backward
// return cudaGetLastError() after the launch (0 on success); neither
// synchronises. The TMA descriptors are encoded on the host inside them,
// through cuTensorMapEncodeTiled fetched with cudaGetDriverEntryPoint (no
// -lcuda). The TMA, mbarrier and wgmma machinery (namespace wg) lives in
// hopper.cuh, shared with csrc/flash_attention.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"  // namespace wg: TMA, mbarriers, wgmma; tensor maps

namespace {

// Tile choices of the wgmma kernels, picked by measurement on an H100 at the
// MoE training path's shapes (PERF.md): gmm 128 x 256 CTA tiles with a
// 4-stage ring (one CTA per SM) beat 128 x 128 with 3 stages (two CTAs per
// SM) at K 1536 and tie at K 512; tgmm 128 x 128 blocks beat 128 x 64 with
// two CTAs per SM. A tgmm ring stage costs about the same whatever its
// bytes, so it holds 128 token rows (3 stages) where block_t allows, else
// 64 (6 stages).
constexpr int GMM_WG_BN = 256, GMM_WG_STAGES = 4;
constexpr int TGMM_WG_BN = 128;
constexpr int TGMM_STAGES_R128 = 3, TGMM_STAGES_R64 = 6;

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

// gmm_bf16_wgmma_kernel ("wgmma"): the training path's bf16 gmm, forward and
// (with WT) dX. Taken when block_t % 64 == 0, K % 8 == 0, N % 8 == 0 and x,
// w and out are 16-byte aligned (TMA's stride and address rules); other bf16
// calls take gmm_bf16_kernel.
//
// What bounds it (moe-8x40m gate/up: x [66560, 512], w [8, 512, 1536],
// 65,536 live rows): 2 x 65,536 x 512 x 1536 = 103 GFLOP against ~285 MB of
// compulsory traffic, so operations: 0.104 ms at 989 TFLOP/s (bytes: 0.085
// ms at 3.35 TB/s). The WMMA kernel ran at 3% of that: each 32-row CTA
// re-staged its expert's K x 64 weight strip with 2-byte loads and nothing
// overlapped loads with math.
//
// Design:
//  - CTA tile BM x BN: BM = 64 NWG rows (128 when block_t allows, else 64),
//    so a CTA never straddles two experts; BN = GMM_WG_BN. NWG consumer
//    warpgroups each own 64 rows and issue wgmma.m64nBNk16 (fp32
//    accumulators in registers); one producer warp (the last) keeps TMA
//    loads in flight.
//  - A ring of GMM_WG_STAGES stages of (x tile BM x 64, w tile 64 x BN) with
//    full/empty mbarriers. A warpgroup releases a stage once the wgmma group
//    that read it has retired: at most one group in flight.
//  - x [T, K] is K-major, wgmma's native A layout (one box of BM rows x 64).
//    The weights are read in place, no transposed copy: the forward's
//    w [E, K, N] is N-major (wgmma's transpose-B bit, one 64 x 64 box per 64
//    columns); dX's w [E, N, K] is K-major (one box of BN rows x 64). A 3D
//    tensor map over the weights zero-fills a box at a ragged K or N edge and
//    never reads the next expert's rows.
//  - The grid is 1D with column tiles fastest: the CTAs in flight cover a
//    few consecutive row tiles of one expert, so its 1.5 MB weight bank stays
//    in the 50 MB L2 and each x tile comes from HBM once.
//  - Tail tiles (rows >= sum(group_sizes)) load nothing and write zeros.
//  - Epilogue: fp32 -> bf16 once, staged through the (then idle) ring,
//    written with 16-byte coalesced stores.
// Later work: persistent CTAs (one tile's epilogue under the next one's
// loads), clusters with TMA multicast of the weight tile, setmaxnreg.
template <int NWG, int BN, int STAGES>
constexpr int gmm_wg_smem() {
  return STAGES * (NWG * 64 + BN) * wg::BK * 2 + wg::ATOM;
}

template <int NWG, int BN, int STAGES, bool WT>
__global__ void __launch_bounds__(NWG * 128 + 32,
                                  gmm_wg_smem<NWG, BN, STAGES>() <= 110 * 1024 ? 2 : 1)
gmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const int* __restrict__ gs, __nv_bfloat16* __restrict__ out,
                      int K, int N, int E, int col_tiles) {
  using namespace wg;
  constexpr int BM = NWG * 64;
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  static_assert(NWG * 64 * (BN * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int s_expert;
  uint8_t* ring = ring_base(dyn_smem);

  const int tid = threadIdx.x;
  const size_t r0 = static_cast<size_t>(blockIdx.x / col_tiles) * BM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  if (tid == 0) {
    s_expert = expert_of_row(gs, E, static_cast<int>(r0));
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int e = s_expert;
  const int cols = min(BN, N - n0);
  if (e < 0) {  // tail tile: zeros
    for (int i = tid; i < BM * (cols / 8); i += blockDim.x) {
      const int rr = i / (cols / 8), cc = (i % (cols / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (r0 + rr) * N + n0 + cc) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int nk = (K + BK - 1) / BK;

  if (tid / 32 == NWG * 4) {  // producer warp
    if (tid % 32 == 0) {
      const int nb = (cols + BOX - 1) / BOX;  // forward: boxes with a live column
      const uint32_t bytes = A_BYTES + (WT ? B_BYTES : nb * BOX_BYTES);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        const uint32_t a = smem_addr(ring + s * STAGE), b = a + A_BYTES;
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, bytes);
        tma_2d(a, &map_x, bar, kb * BK, static_cast<int>(r0));
        if (WT) {
          tma_3d(b, &map_w, bar, kb * BK, n0, e);
        } else {
          for (int j = 0; j < nb; ++j)
            tma_3d(b + j * BOX_BYTES, &map_w, bar, n0 + j * BOX, kb * BK, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup g: rows [r0 + 64 g, r0 + 64 g + 64)
  const int g = tid / 128, t = tid % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    const uint32_t a = smem_addr(ring + s * STAGE) + g * (64 * BK * 2);
    const uint32_t b = smem_addr(ring + s * STAGE) + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = desc(a + ks * 32, 16, ATOM);
      const uint64_t db = WT ? desc(b + ks * 32, 16, ATOM)
                             : desc(b + ks * 16 * 128, BOX_BYTES, ATOM);
      Wgmma<BN, 0, WT ? 0 : 1>::run(acc, da, db, 1);
    }
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's group has retired
    fence_acc(acc);
    if (kb > 0 && t == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  uint32_t v[BN / 4];
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) v[j] = pack_bf16(acc[2 * j], acc[2 * j + 1]);
  bar_sync(1, NWG * 128);  // every warpgroup is past its last wgmma: the ring is idle
  store_tile<BN>(v, ring + g * 64 * (BN * 2 + 16), out, N, r0 + g * 64, 64, n0, cols, t,
                 2 + g);
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
// neighbours in launch order share its expert). bf16 at block_t % 64 == 0
// runs tgmm_bf16_wgmma_kernel (noted below); this WMMA kernel ("wmma") keeps
// the other bf16 shapes, "f32" the fp32 ones.
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


// tgmm_bf16_wgmma_kernel ("wgmma"): tgmm in bf16 when block_t % 64 == 0,
// K % 8 == 0, N % 8 == 0 and x, dy and dw are 16-byte aligned; other bf16
// shapes take tgmm_bf16_kernel. The same function and rounding points as
// the kernels above, bit for bit in structure: one CTA owns one
// 128 x TGMM_WG_BN block of one expert's dW [K, N] and walks that expert's
// block_t tiles in order; each tile's fp32 partial rounds to bf16 and the
// running sum (bf16, two per register, in registers) rounds after every
// add; no atomics, so the result is bitwise reproducible. Experts with no
// rows write exact zeros; rows past sum(group_sizes) are never read.
//
// What bounds it: 103 GFLOP per gate/up call, as gmm: operations, 0.104 ms
// at 989 TFLOP/s. Measured on an H100 (PERF.md), the first wgmma design ran
// at a third of that, and neither L2 nor its bytes were the reason: loading
// half the bytes per stage changed nothing, and sharing x and dy across a
// 2 x 2 cluster by TMA multicast made it slower. Two things were: ptxas
// serialized every wgmma (advisory C7518: the tile's last wait_group sat
// in one branch, the other stages' in another), and every ring stage costs
// about the same fixed time whatever its bytes, so 64-row stages paid it
// twice per 128-row tile.
//
// Design: the reduction runs over token rows. Two consumer warpgroups each
// own 64 K-rows of the block; the producer warp streams the expert's rows in
// stages of SR = 128 rows where block_t allows, else 64 (from the prefix
// sum over group_sizes the CTA computes itself): per stage two SR x 64
// boxes of x (rows x K-columns) and TGMM_WG_BN / 64 boxes of dy, into a ring
// of 3 (or 6) stages. A = x^T is M-major in shared memory (wgmma's
// transpose-A bit), B = dy is N-major (transpose-B). A block_t tile is
// block_t / 16 k-steps into fp32 accumulators (the first with scale_d 0): a
// loop over the tiles around a loop over their stages, as gmm's main loop,
// each stage's batch issued while the previous one runs (wgmma.wait_group
// 1, releasing its stage); after the inner loop, outside any branch, the
// tile's last batch retires (wait_group 0) before the round and the add. A
// box wholly past K or N is not loaded (its rows or columns are never
// stored). The grid is 1D in expert order, an expert's CTAs consecutive, so
// those in flight share its rows in L2.
// Later work: a hot expert serialises its column of CTAs (splitting its
// rows would reorder the rounding chain: it needs a second pass that adds
// the rounded tile partials in order); double-buffered accumulators so the
// tensor cores run through each tile's round-and-add; persistent CTAs.
template <int BN, int SR, int STAGES>
constexpr int tgmm_wg_smem() {
  return STAGES * (2 + BN / wg::BOX) * SR * 128 + wg::ATOM;
}

template <int BN, int SR, int STAGES>
__global__ void __launch_bounds__(288, 1)
tgmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_dy,
                       const int* __restrict__ gs, __nv_bfloat16* __restrict__ dw,
                       int K, int N, int block_t, int k_tiles, int n_tiles) {
  using namespace wg;
  constexpr int SBOX = SR * 128;     // one box: SR rows x 64 columns
  constexpr int A_BYTES = 2 * SBOX;  // SR rows x 128 K-columns
  constexpr int STAGE = A_BYTES + (BN / BOX) * SBOX;
  static_assert(2 * 64 * (BN * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int s_start, s_rows;
  uint8_t* ring = ring_base(dyn_smem);

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k0 = (blockIdx.x / n_tiles % k_tiles) * 128;
  const int e = blockIdx.x / (n_tiles * k_tiles);
  if (tid == 0) {
    expert_range(gs, e, &s_start, &s_rows);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int start = s_start, steps = s_rows / SR;

  if (tid / 32 == 8) {  // producer warp
    if (tid % 32 == 0) {
      const int na = min(2, (K - k0 + BOX - 1) / BOX);
      const int nb = min(BN / BOX, (N - n0 + BOX - 1) / BOX);
      const uint32_t bytes = (na + nb) * SBOX;
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const uint32_t a = smem_addr(ring + s * STAGE), b = a + A_BYTES;
        const uint32_t bar = smem_addr(&full[s]);
        const int row = start + it * SR;
        mbar_expect_tx(bar, bytes);
        for (int i = 0; i < na; ++i) tma_2d(a + i * SBOX, &map_x, bar, k0 + i * BOX, row);
        for (int j = 0; j < nb; ++j) tma_2d(b + j * SBOX, &map_dy, bar, n0 + j * BOX, row);
      }
    }
    return;
  }

  // consumer warpgroup g: dW rows [k0 + 64 g, k0 + 64 g + 64)
  const int g = tid / 128, t = tid % 128;
  const int per = block_t / SR;  // stages per block_t tile
  const int tiles = steps / per;
  float acc[BN / 2];
  uint32_t run[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) run[j] = 0u;
  int it = 0;  // the stage counter over the expert's rows
  for (int tile = 0; tile < tiles; ++tile) {
    for (int p = 0; p < per; ++p, ++it) {
      const int s = it % STAGES;
      const uint32_t a = smem_addr(ring + s * STAGE) + g * SBOX;
      const uint32_t b = smem_addr(ring + s * STAGE) + A_BYTES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < SR / 16; ++ks)
        Wgmma<BN, 1, 1>::run(acc, desc(a + ks * 16 * 128, SBOX, ATOM),
                             desc(b + ks * 16 * 128, SBOX, ATOM),
                             p == 0 && ks == 0 ? 0 : 1);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous stage's batch has retired
      fence_acc(acc);
      if (p > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();  // the tile's last batch, outside any branch
    fence_acc(acc);
    if (t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    const bool first_tile = tile == 0;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const uint32_t part = pack_bf16(acc[2 * j], acc[2 * j + 1]);
      run[j] = first_tile ? part : add_bf16(run[j], part);
    }
  }
  bar_sync(1, 256);  // both warpgroups are past their last wgmma: the ring is idle
  store_tile<BN>(run, ring + g * 64 * (BN * 2 + 16), dw + static_cast<size_t>(e) * K * N, N,
                 k0 + g * 64, K - (k0 + g * 64), n0, N - n0, t, 2 + g);
}

// ------------------------------------------------ host side of the wgmma path
using wg::allow_smem;
using wg::bf16_map;

// The wgmma kernels' preconditions: TMA needs 16-byte aligned bases and
// row strides (K, N multiples of 8 bf16), the epilogue's 16-byte stores too.
bool wgmma_shapes_ok(int K, int N, const void* a, const void* b, const void* c) {
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return K % 8 == 0 && N % 8 == 0 && al(a) && al(b) && al(c);
}


template <int NWG, bool WT>
int launch_gmm_wgmma(const void* x, const void* w, const int* gs, void* out, int T,
                     int K, int N, int E, cudaStream_t stream) {
  constexpr int BN = GMM_WG_BN, STAGES = GMM_WG_STAGES, BM = NWG * 64;
  CUtensorMap mx, mw;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint32_t xb[2] = {wg::BK, BM};
  int err = bf16_map(&mx, x, 2, xd, xb);
  if (err != 0) return err;
  if (WT) {  // w [E, N, K]: boxes of BN rows x 64
    const cuuint64_t wd[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(E)};
    const cuuint32_t wb[3] = {wg::BK, BN, 1};
    err = bf16_map(&mw, w, 3, wd, wb);
  } else {   // w [E, K, N]: boxes of 64 K-rows x 64 columns
    const cuuint64_t wd[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
    const cuuint32_t wb[3] = {wg::BOX, wg::BK, 1};
    err = bf16_map(&mw, w, 3, wd, wb);
  }
  if (err != 0) return err;
  const auto kernel = gmm_bf16_wgmma_kernel<NWG, BN, STAGES, WT>;
  constexpr int smem = gmm_wg_smem<NWG, BN, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  const int col_tiles = (N + BN - 1) / BN;
  kernel<<<col_tiles * (T / BM), NWG * 128 + 32, smem, stream>>>(
      mx, mw, gs, static_cast<__nv_bfloat16*>(out), K, N, E, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int SR>
int launch_tgmm_wgmma(const void* x, const void* dy, const int* gs, void* dw, int T,
                      int K, int N, int E, int block_t, cudaStream_t stream) {
  constexpr int BN = TGMM_WG_BN, STAGES = SR == 128 ? TGMM_STAGES_R128 : TGMM_STAGES_R64;
  CUtensorMap mx, md;
  const cuuint32_t box[2] = {wg::BOX, SR};
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint64_t dd[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(T)};
  int err = bf16_map(&mx, x, 2, xd, box);
  if (err == 0) err = bf16_map(&md, dy, 2, dd, box);
  if (err != 0) return err;
  const auto kernel = tgmm_bf16_wgmma_kernel<BN, SR, STAGES>;
  constexpr int smem = tgmm_wg_smem<BN, SR, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  const int k_tiles = (K + 127) / 128, n_tiles = (N + BN - 1) / BN;
  kernel<<<E * k_tiles * n_tiles, 288, smem, stream>>>(
      mx, md, gs, static_cast<__nv_bfloat16*>(dw), K, N, block_t, k_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. bm: CTA row tile, dividing block_t: 8, 16 or
// 32 (fp32 and bf16 WMMA: the wrapper picks min(block_t, 32)), or 64 or 128
// (bf16 only: the TMA/wgmma kernel, whose preconditions are checked here).
// w_trans: w is [E, N, K] and is read transposed (the backward's dX).
// Returns a cudaError_t.
extern "C" int gmm_forward(const void* x, const void* w, const int* group_sizes,
                           void* out, int T, int K, int N, int E, int bm,
                           int dtype, int w_trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || bm <= 0 || T % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64 || bm == 128) {
    if (dtype != 1 || !wgmma_shapes_ok(K, N, x, w, out))
      return static_cast<int>(cudaErrorInvalidValue);
    if (bm == 128)
      return w_trans ? launch_gmm_wgmma<2, true>(x, w, group_sizes, out, T, K, N, E, s)
                     : launch_gmm_wgmma<2, false>(x, w, group_sizes, out, T, K, N, E, s);
    return w_trans ? launch_gmm_wgmma<1, true>(x, w, group_sizes, out, T, K, N, E, s)
                   : launch_gmm_wgmma<1, false>(x, w, group_sizes, out, T, K, N, E, s);
  }
  return w_trans ? launch_gmm<true>(x, w, group_sizes, out, T, K, N, E, bm, dtype, s)
                 : launch_gmm<false>(x, w, group_sizes, out, T, K, N, E, bm, dtype, s);
}

// dw [E, K, N] from x [T, K] and dy [T, N] (one type). kernel: 0 = fp32,
// 1 = bf16 on WMMA, 2 = bf16 on the TMA/wgmma kernel (block_t % 64 == 0,
// K, N multiples of 8, 16-byte aligned pointers: checked here). block_t: a
// multiple of 8 dividing T and every group size. Returns a cudaError_t.
extern "C" int tgmm_backward(const void* x, const void* dy,
                             const int* group_sizes, void* dw, int T, int K,
                             int N, int E, int block_t, int kernel,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || block_t <= 0 || block_t % 8 != 0
      || T % block_t != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == 2) {
    if (block_t % 64 != 0 || !wgmma_shapes_ok(K, N, x, dy, dw))
      return static_cast<int>(cudaErrorInvalidValue);
    return block_t % 128 == 0
               ? launch_tgmm_wgmma<128>(x, dy, group_sizes, dw, T, K, N, E, block_t, s)
               : launch_tgmm_wgmma<64>(x, dy, group_sizes, dw, T, K, N, E, block_t, s);
  }
  dim3 grid((N + TB - 1) / TB, (K + TB - 1) / TB, E);
  if (kernel == 0) {
    tgmm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        group_sizes, static_cast<float*>(dw), K, N, block_t);
  } else if (kernel == 1) {
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
