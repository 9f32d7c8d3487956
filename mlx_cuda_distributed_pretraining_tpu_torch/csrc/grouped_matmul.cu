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
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 and 495 TF32
// on the tensor cores), by variant; each kernel's own note says more:
//   - Decode (fp32, 8 slots, top-2: 16 selections, block_t 8, T = 72) is
//     bound by weight bytes: up to 8 x 512 x 1536 x 4 B = 25 MB per call for
//     ~25 MFLOP. gmm_f32_decode_kernel streams each live tile's weights
//     once, split over ~4 x 132 CTAs, with 16-byte loads.
//   - A 256-token fp32 prefill chunk (block_t 32, T = 768) moves ~31 MB for
//     0.8 GFLOP: bytes again once the products run on the tensor cores.
//     gmm_f32_tf32x3_kernel runs them in 3xTF32 (fp32 accuracy) on
//     mma.sync with a cp.async ring.
//   - bf16 with block_t < 64 (or shapes outside TMA's rules) runs WMMA
//     16x16x16 fragments with fp32 accumulators; row tiles of 8 are
//     zero-padded to 16 (no path runs it at a size that matters).
//   - bf16 at the training path's shapes (block_t a multiple of 64) runs
//     gmm_bf16_wgmma_kernel: a TMA ring feeding wgmma (its own note below).
//
// Variants, chosen by the wrapper before launch (ops/grouped_matmul.py::
// gmm_variant; gmm_forward's bm argument carries the choice, the decode
// kernel has its own entry):
//   "f32_decode" fp32, bm 8         gmm_f32_decode_kernel (gmm_f32_decode)
//   "f32"        fp32, bm 16 / 32   gmm_f32_tf32x3_kernel
//   "wmma"       bf16, bm 8-32      gmm_bf16_kernel
//   "wgmma"      bf16, bm 64 / 128  gmm_bf16_wgmma_kernel
//
// A CTA's row tile (BM rows) divides block_t, so a CTA never straddles two
// experts. Hopper has no scalar prefetch: each CTA finds its expert with a
// linear search over the E cumulative group sizes it reads itself.
//
// Interface: plain C, loaded with ctypes. gmm_forward, gmm_f32_decode and
// tgmm_backward return cudaGetLastError() after the launch (0 on success);
// none synchronises. The TMA descriptors are encoded on the host inside them,
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

// Expert owning row r0, or -1 (tail tile), as expert_of_row, found by one
// warp with its loads of group_sizes all in flight at once (one memory round
// trip per 32 experts instead of one per expert). Every lane returns it.
__device__ __forceinline__ int expert_of_row_warp(const int* __restrict__ gs, int E,
                                                  int r0, int lane) {
  int base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    int v = e0 + lane < E ? gs[e0 + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive prefix sum over the lanes
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, e0 + lane < E && r0 < base + v);
    if (hit) return e0 + __ffs(hit) - 1;
    base += __shfl_sync(0xffffffffu, v, 31);
  }
  return -1;
}

// cp.async and the 3xTF32 pieces (hopper.cuh), shared with the fp32 flash
// forward.
using wg::cp_async;
using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::mma_tf32;
using wg::split_tf32;

// ------------------------------------------- fp32 prefill: 3xTF32 mma.sync
// gmm_f32_tf32x3_kernel ("f32"), replacing mlx_cuda_distributed_pretraining_tpu/
// ops/grouped_matmul.py::_gmm_pallas for every fp32 call at block_t >= 16
// (the serving path's prefill chunks, block_t 32, and a short last chunk
// at 16), forward and, with WT, dX.
//
// What bounds it (moe-8x40m prefill chunk, 256 tokens x top-2 in a 768-row
// buffer, block_t 32): 2 x 512 x 512 x 1536 = 0.8 GFLOP against ~31 MB of
// compulsory traffic (the touched experts' 25 MB of weights dominate). At the
// FMA units' 67 TFLOP/s that is 12 us of arithmetic; on the tensor cores, at
// three TF32 passes per product (below), 5 us at 495 TFLOP/s, so the bytes
// bound it: ~9 us at 3.35 TB/s. Each 32-row tile re-reads its expert's
// weights (from L2 after the first), and each column strip re-reads x, so
// L2 carries 3-5x the compulsory bytes.
//
// Accuracy: fp32 in, fp32 out, as the plain version computes it. TF32 keeps
// 10 mantissa bits, so each operand element is split once as it leaves
// shared memory, hi = rna(v), lo = rna(v - hi) (cvt.rna.tf32's rounding,
// computed with integer operations: rna_tf32), and each product is
// lo.hi + hi.lo + hi.hi (3xTF32; the dropped lo.lo is ~2^-22 of it). The
// tensor cores add into their fp32 accumulator with truncation, which
// biases a long sum; so the mma accumulator (part) only ever holds
// F32_FLUSH stages' worth of products and is then added into an fp32 total
// with ordinary rounded adds. Measured against a float64 product on an
// H100 (tests/test_torch_kernels_cuda.py): normwise 2.5e-7 at K 512 and
// 1536, where the plain fp32 version (cuBLAS, no TF32) reads 2.1e-7-7.0e-7.
//
// Design:
//  - CTA tile BM x F32_BN (BM = 32 or 16, dividing block_t: a CTA never
//    straddles two experts), F32_NWARPS x F32_KWARPS warps. Warp (n, k)
//    owns the BM x 32 column block n of the tile and takes F32_KSTEPS of
//    each F32_BK-deep stage's k8 steps (split K inside the CTA); the K
//    warps' blocks are added in warp order through shared memory at the
//    end. Narrow tiles and the split keep hundreds of CTAs in flight at the
//    serving shapes (384 at prefill-down, 1152 at gate/up) instead of 192
//    walking 96 serial k-steps.
//  - mma.sync.m16n8k8 (tf32, fp32 accumulators), not wgmma: wgmma needs
//    64-row tiles (which would straddle experts at block_t 16 and 32) and
//    takes tf32 B only K-major, while the forward's w [E, K, N] is N-major.
//    mma.sync's fragments are read from shared memory by the threads, so
//    one kernel reads either layout (WT).
//  - x and w tiles arrive through an F32_STAGES-deep ring of 16-byte
//    cp.async copies (4-byte ones where K or N is not a multiple of 4 or an
//    operand is not 16-byte aligned), so the loads of later stages are in
//    flight while a stage's mmas run. Padded shared-memory rows make every
//    fragment read conflict-free. Copies past K or N zero-fill.
//  - Row tiles are the grid's fastest dimension, so the CTAs in flight read
//    the same expert's weight strip (L2 hits after the first).
//  - Tail tiles (rows >= sum(group_sizes)) read nothing and write zeros;
//    each CTA finds its expert itself; no atomics: bitwise reproducible.
// The constants below were picked by timing edited copies on an H100 at
// the serving shapes (PERF.md): 64-column tiles (F32_NWARPS 2) are
// faster at gate/up and slower at down, deeper rings and 8 K warps no
// better; the split's integer rounding beat cvt.rna by ~10%. No one cost
// sets the time at these shapes: dropping two of the three mma passes
// saves 8-12%, leaving out the weight or the x copies 18-20%, weights hot
// in L2 instead of HBM ~1% (timing-only copies); ROADMAP queue 2 keeps the
// levers.
constexpr int F32_NWARPS = 1;   // warps along N, each a 32-column block
constexpr int F32_KWARPS = 4;   // warps along K
constexpr int F32_KSTEPS = 2;   // k8 steps of each warp per stage
constexpr int F32_STAGES = 3;   // cp.async ring depth
constexpr int F32_FLUSH = 2;    // stages summed in the mma accumulator per flush
constexpr int F32_BN = 32 * F32_NWARPS;             // output columns per CTA
constexpr int F32_BK = 8 * F32_KWARPS * F32_KSTEPS;  // K per ring stage

template <int BM, bool WT>
struct F32Tile {
  static constexpr int LDA = F32_BK + 4;                    // x stage [BM][LDA]
  static constexpr int LDB = WT ? F32_BK + 4 : F32_BN + 8;  // w [BN][LDB] or [BK][LDB]
  static constexpr int A_EL = BM * LDA;
  static constexpr int B_EL = WT ? F32_BN * LDB : F32_BK * LDB;
  static constexpr int STAGE = A_EL + B_EL;
  static constexpr int LDR = F32_BN + 8;                    // the K warps' partial tiles
  static constexpr int RING = F32_STAGES * STAGE;
  static constexpr int BYTES = RING * 4;                    // dynamic shared memory
  static_assert(F32_KWARPS * BM * LDR <= RING, "partials reuse the ring");
};

// VEC: 16-byte copies (K and N multiples of 4, x and w 16-byte aligned).
template <int BM, bool WT, bool VEC>
__global__ void __launch_bounds__(F32_NWARPS * F32_KWARPS * 32)
gmm_f32_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ gs, float* __restrict__ out, int K,
                      int N, int E) {
  using L = F32Tile<BM, WT>;
  constexpr int BK = F32_BK, BN = F32_BN, NTH = F32_NWARPS * F32_KWARPS * 32;
  constexpr int MT = BM / 16, NT = 4;  // a warp's m16 and n8 tiles
  constexpr int V = VEC ? 4 : 1;       // floats per copy
  extern __shared__ __align__(16) float ring[];
  __shared__ int s_expert;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % F32_NWARPS, wk = warp / F32_NWARPS;
  const int r0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  if (warp == 0) {
    const int e = expert_of_row_warp(gs, E, r0, lane);
    if (lane == 0) s_expert = e;
  }
  __syncthreads();
  const int e = s_expert;
  if (e < 0) {
    for (int i = tid; i < BM * BN; i += NTH) {
      const int c = c0 + i % BN;
      if (c < N) out[(size_t)(r0 + i / BN) * N + c] = 0.f;
    }
    return;
  }
  const float* we = w + (size_t)e * K * N;
  const int KT = (K + BK - 1) / BK;

  auto load_stage = [&](int slot, int kt) {
    float* As = ring + slot * L::STAGE;
    float* Bs = As + L::A_EL;
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK / V; i += NTH) {
      const int r = i / (BK / V), kk = i % (BK / V) * V;
      const bool in = k0 + kk < K;
      cp_async<4 * V>(As + r * L::LDA + kk, in ? x + (size_t)(r0 + r) * K + k0 + kk : x, in);
    }
    for (int i = tid; i < BK * BN / V; i += NTH) {
      if constexpr (WT) {  // [BN][BK]: element (k, n) at we[n * K + k]
        const int n = i / (BK / V), kk = i % (BK / V) * V;
        const bool in = c0 + n < N && k0 + kk < K;
        cp_async<4 * V>(Bs + n * L::LDB + kk, in ? we + (size_t)(c0 + n) * K + k0 + kk : w, in);
      } else {  // [BK][BN]: element (k, n) at we[k * N + n]
        const int kk = i / (BN / V), n = i % (BN / V) * V;
        const bool in = k0 + kk < K && c0 + n < N;
        cp_async<4 * V>(Bs + kk * L::LDB + n, in ? we + (size_t)(k0 + kk) * N + c0 + n : w, in);
      }
    }
  };

  float total[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[m][n][j] = part[m][n][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<F32_STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; stage kt - 1 is free
    if (kt + F32_STAGES - 1 < KT)
      load_stage((kt + F32_STAGES - 1) % F32_STAGES, kt + F32_STAGES - 1);
    cp_async_commit();

    const float* As = ring + (kt % F32_STAGES) * L::STAGE;
    const float* Bs = As + L::A_EL;
#pragma unroll
    for (int ks = 0; ks < F32_KSTEPS; ++ks) {
      const int kk = (ks * F32_KWARPS + wk) * 8;
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(As[(m * 16 + g + (j & 1) * 8) * L::LDA + kk + t + (j >> 1) * 4],
                     ah[m][j], al[m][j]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = kk + t + j * 4, c = wn * 32 + n * 8 + g;
          split_tf32(WT ? Bs[c * L::LDB + k] : Bs[k * L::LDB + c], bh[n][j], bl[n][j]);
        }
      // the small terms first, the large one last; independent tiles
      // between two mmas on one accumulator
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], al[m], bh[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], ah[m], bl[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(part[m][n], ah[m], bh[n]);
    }
    if ((kt + 1) % F32_FLUSH == 0 || kt + 1 == KT) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            total[m][n][j] += part[m][n][j];
            part[m][n][j] = 0.f;
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last stage: the ring is idle

  float* red = ring;  // [F32_KWARPS][BM][LDR]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (wk * BM + m * 16 + g + h * 8) * L::LDR + wn * 32 +
                                   n * 8 + 2 * t) =
            make_float2(total[m][n][2 * h], total[m][n][2 * h + 1]);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NTH) {
    const int r = i / BN, c = i % BN;
    float s = red[r * L::LDR + c];
#pragma unroll
    for (int q = 1; q < F32_KWARPS; ++q) s += red[(q * BM + r) * L::LDR + c];
    if (c0 + c < N) out[(size_t)(r0 + r) * N + c0 + c] = s;
  }
}

// -------------------------------------------- fp32 decode: a weight stream
// gmm_f32_decode_kernel ("f32_decode"), replacing _gmm_pallas for fp32 at
// block_t 8: the serving path's decode steps (8 slots x top-2 = 16
// selections in a 72-row buffer: nine 8-row tiles, one or two per touched
// expert, the rest tail tiles).
//
// What bounds it: bytes. Each live tile multiplies 8 rows by its expert's
// K x N block (3.1 MB at moe-8x40m), so a call streams up to 8 x 3.1 = 25 MB
// of weights for ~25 MFLOP: ~7 us at 3.35 TB/s. Keeping HBM busy takes
// ~3.3 MB in flight across the card (Little's law at ~1 us), ~25 KB per SM,
// and an equal share of the stream on every SM.
//
// Design:
//  - Work item (grid x, y, z) = (row tile, K chunk, strip of DEC_COLS
//    columns): `kc` rows of K (ops/grouped_matmul.py::decode_plan picks kc
//    so that a call makes ~4 x 132 items; 432 at both serving shapes, 64 KB
//    of weights each).
//  - A CTA issues its whole kc x DEC_COLS weight block and x's 8 x kc slice
//    as 16-byte cp.async copies into shared memory at once, so its 64 KB
//    are in flight together without holding registers (three CTAs per SM:
//    ~190 KB in flight per SM), then waits once. Its warp for the expert
//    lookup reads all group sizes in one round trip. The DEC_WARPS warps
//    then split the chunk's rows (warp q: rows q, q + 8, ...), each lane
//    4 columns, x read as two broadcast float4s per weight row.
//  - The warps' partial tiles are added in warp order through shared
//    memory. With more than one chunk, each CTA writes its 8 x DEC_COLS
//    partial to an fp32 scratch [chunks, T, N], and the last CTA of a
//    (tile, strip) to arrive, found by a counter, adds the chunks' partials
//    in chunk order and writes the output, then sets the counter back to 0
//    (the wrapper zeroes the counters once). The counter orders nothing
//    that is summed: the result is bitwise the same from run to run.
//  - Tail tiles read no weights: chunk 0 writes their zeros.
//  - WT (dX) and shapes without 16-byte copies copy 4 bytes at a time; no
//    path runs them at a size where it matters.
// On an H100 a serving call (25.2 MB of weights, cold) takes about what
// torch.sum takes to read the same bytes cold (PERF.md): a one-shot
// read of this size does not reach the card's sustained rate. Chunks of
// 64 or 256 rows and column strips as the grid's fastest dimension
// measured no faster; the last CTA's chunk sum costs ~3 us of it.
constexpr int DEC_ROWS = 8;      // rows per CTA: one block_t 8 tile
constexpr int DEC_WARPS = 8;     // warps per CTA, splitting the chunk's rows
constexpr int DEC_COLS = 128;    // columns per CTA: 4 per lane
constexpr int DEC_KC_MAX = 256;  // largest K chunk (its weights in shared memory)

// Dynamic shared memory of a CTA at chunk kc: the weight block and x's slice,
// and at least the warps' partial tiles that reuse them.
constexpr int dec_smem(int kc) {
  return (kc * (DEC_COLS + DEC_ROWS) > DEC_WARPS * DEC_ROWS * DEC_COLS
              ? kc * (DEC_COLS + DEC_ROWS)
              : DEC_WARPS * DEC_ROWS * DEC_COLS) * 4;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int c, int N) {
  if constexpr (VEC) {
    if (c < N) *reinterpret_cast<float4*>(p) = v;
  } else {
    if (c < N) p[0] = v.x;
    if (c + 1 < N) p[1] = v.y;
    if (c + 2 < N) p[2] = v.z;
    if (c + 3 < N) p[3] = v.w;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// VEC: 16-byte weight copies and stores (!WT, N a multiple of 4, w, out
// and the scratch 16-byte aligned).
template <bool WT, bool VEC>
__global__ void __launch_bounds__(DEC_WARPS * 32)
gmm_f32_decode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ gs, float* __restrict__ out,
                      float* __restrict__ partial, int* __restrict__ counters, int T,
                      int K, int N, int E, int kc) {
  constexpr int NTH = DEC_WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                  // [kc][DEC_COLS]; then the K warps' partials
  float* xs = smem + kc * DEC_COLS;   // [kc][DEC_ROWS]
  __shared__ int s_expert, s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int r0 = tile * DEC_ROWS;
  const int c0 = blockIdx.z * DEC_COLS;
  const int c = c0 + lane * 4;  // this lane's 4 columns
  if (warp == 0) {
    const int e = expert_of_row_warp(gs, E, r0, lane);
    if (lane == 0) s_expert = e;
  }
  __syncthreads();
  const int e = s_expert;
  if (e < 0) {
    if (chunk == 0)
      for (int i = tid; i < DEC_ROWS * DEC_COLS; i += NTH) {
        const int col = c0 + i % DEC_COLS;
        if (col < N) out[(size_t)(r0 + i / DEC_COLS) * N + col] = 0.f;
      }
    return;
  }
  const int k0 = chunk * kc;
  const int klen = min(kc, K - k0);
  const float* we = w + (size_t)e * K * N;
  if constexpr (VEC) {
    for (int i = tid; i < klen * (DEC_COLS / 4); i += NTH) {
      const int k = i / (DEC_COLS / 4), j = i % (DEC_COLS / 4) * 4;
      const bool in = c0 + j < N;
      cp_async<16>(wsm + k * DEC_COLS + j, in ? we + (size_t)(k0 + k) * N + c0 + j : w, in);
    }
  } else {
    for (int i = tid; i < klen * DEC_COLS; i += NTH) {
      const int k = i / DEC_COLS, j = i % DEC_COLS;
      const bool in = c0 + j < N;
      cp_async<4>(wsm + k * DEC_COLS + j, in ? we + w_at<WT>(k0 + k, c0 + j, K, N) : w, in);
    }
  }
  for (int i = tid; i < DEC_ROWS * klen; i += NTH) {
    const int r = i / klen, k = i % klen;
    cp_async<4>(xs + k * DEC_ROWS + r, x + (size_t)(r0 + r) * K + k0 + k, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float4 acc[DEC_ROWS];
#pragma unroll
  for (int i = 0; i < DEC_ROWS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int kk = warp; kk < klen; kk += DEC_WARPS) {
    const float4 wv = *reinterpret_cast<const float4*>(wsm + kk * DEC_COLS + lane * 4);
    const float4 xa = *reinterpret_cast<const float4*>(xs + kk * DEC_ROWS);
    const float4 xb = *reinterpret_cast<const float4*>(xs + kk * DEC_ROWS + 4);
    const float xr[DEC_ROWS] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < DEC_ROWS; ++i) {
      acc[i].x = fmaf(xr[i], wv.x, acc[i].x);
      acc[i].y = fmaf(xr[i], wv.y, acc[i].y);
      acc[i].z = fmaf(xr[i], wv.z, acc[i].z);
      acc[i].w = fmaf(xr[i], wv.w, acc[i].w);
    }
  }
  __syncthreads();  // done with the weight block: its space takes the partials
  float* red = wsm;  // [DEC_WARPS][DEC_ROWS][DEC_COLS]
#pragma unroll
  for (int i = 0; i < DEC_ROWS; ++i)
    *reinterpret_cast<float4*>(red + (warp * DEC_ROWS + i) * DEC_COLS + lane * 4) = acc[i];
  __syncthreads();
  // thread (warp r, lane): row r, columns c .. c + 3, summed in warp order
  float4 s = *reinterpret_cast<const float4*>(red + warp * DEC_COLS + lane * 4);
#pragma unroll
  for (int q = 1; q < DEC_WARPS; ++q)
    s = add4(s, *reinterpret_cast<const float4*>(red + (q * DEC_ROWS + warp) * DEC_COLS +
                                                 lane * 4));
  const size_t o = (size_t)(r0 + warp) * N + c;
  if (chunks == 1) {
    store4<VEC>(out + o, s, c, N);
    return;
  }
  store4<VEC>(partial + (size_t)chunk * T * N + o, s, c, N);
  __threadfence();  // this CTA's partial is visible before its arrival counts
  __syncthreads();
  const int slot = tile * gridDim.z + blockIdx.z;
  if (tid == 0) s_last = atomicAdd(counters + slot, 1) == chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int q = 0; q < chunks; ++q) {  // chunk order, whichever CTA came last
    const float* p = partial + (size_t)q * T * N + o;
    float4 v;
    if constexpr (VEC) {
      v = c < N ? __ldcg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v.x = c < N ? __ldcg(p) : 0.f;
      v.y = c + 1 < N ? __ldcg(p + 1) : 0.f;
      v.z = c + 2 < N ? __ldcg(p + 2) : 0.f;
      v.w = c + 3 < N ? __ldcg(p + 3) : 0.f;
    }
    s = q == 0 ? v : add4(s, v);
  }
  store4<VEC>(out + o, s, c, N);
  if (tid == 0) counters[slot] = 0;  // ready for the next call
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

template <int BM, bool WT, bool VEC>
int launch_f32_tile(const float* x, const float* w, const int* gs, float* out, int T, int K,
                    int N, int E, cudaStream_t stream) {
  const auto kernel = gmm_f32_tf32x3_kernel<BM, WT, VEC>;
  constexpr int smem = F32Tile<BM, WT>::BYTES;
  static std::atomic<unsigned long long> ready{0};
  const int err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  const dim3 grid(T / BM, (N + F32_BN - 1) / F32_BN);
  kernel<<<grid, F32_NWARPS * F32_KWARPS * 32, smem, stream>>>(x, w, gs, out, K, N, E);
  return 0;
}

template <int BM, bool WT>
int launch_f32(const void* x, const void* w, const int* gs, void* out, int T,
               int K, int N, int E, cudaStream_t stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  const bool vec = K % 4 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_f32_tile<BM, WT, true>(xf, wf, gs, of, T, K, N, E, stream)
             : launch_f32_tile<BM, WT, false>(xf, wf, gs, of, T, K, N, E, stream);
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
    int err;
    switch (bm) {  // bm 8 is the decode kernel's, through gmm_f32_decode
      case 16: err = launch_f32<16, WT>(x, w, gs, out, T, K, N, E, s); break;
      case 32: err = launch_f32<32, WT>(x, w, gs, out, T, K, N, E, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
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
// column-major A operand straight from its row-major staging; fp32 runs
// tgmm_f32_wgmma_kernel (3xTF32 on wgmma, its own note below).
//
// What bounds it on an H100 SXM at the MoE training path's shapes
// (moe-8x40m, 65,536 selections in a 66,560-row buffer, K x N 512 x 1536 or
// 1536 x 512, bf16): 2 x 65,536 x 512 x 1536 = 103 GFLOP (0.104 ms at
// 989 TFLOP/s) against ~285 MB of compulsory traffic (0.085 ms at 3.35 TB/s):
// operations. Each CTA re-reads its expert's x and dy column slices, so the
// grid reads 24-8 times the compulsory bytes, mostly from L2 (a CTA's
// neighbours in launch order share its expert). bf16 at block_t % 64 == 0
// runs tgmm_bf16_wgmma_kernel (noted below); this WMMA kernel ("wmma") keeps
// the other bf16 shapes.
constexpr int TB = 64;    // output block: K rows x N columns per CTA
constexpr int TBR = 32;   // rows staged per pass (two WMMA k-steps)
constexpr int TLD = TB + 8;
constexpr int TNT = 128;  // 4 warps, each a 32 x 32 quarter

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

// ------------------------------------------------ fp32 tgmm: 3xTF32 wgmma
// tgmm_f32_wgmma_kernel ("f32"): tgmm in fp32, the dW of
// matmul_precision "int8" (ops/grouped_matmul.py::_GroupedMatmulInt8 runs
// it on fp32 copies of x and dy) and any fp32 tgmm call. The function is
// the one above: per expert, each block_t row tile's fp32 partial
// x_tile^T @ dy_tile, the partials added in fp32 in tile order (the first
// initialises), empty experts exact zeros, rows past sum(group_sizes)
// never read; block_t % 8 == 0 is the only row precondition.
//
// What bounds it (moe-8x40m int8 training: 65,536 selections in a 66,560-row
// buffer, block_t 128, K x N 512 x 1536 or 1536 x 512): 2 x 65,536 x 512 x
// 1536 = 103 GFLOP of fp32 products against ~0.56 GB of compulsory traffic
// (x and dy read once, dW written once: 0.17 ms at 3.35 TB/s); at three
// TF32 passes a product (below) on the tensor cores, 495 / 3 = 165 TFLOP/s,
// the operations: 0.63 ms. The SIMT kernel it replaces (64 x 64 blocks of
// FMA tiles) took 5.75 ms a call.
//
// Accuracy: fp32 in, fp32 out. Each operand element is split once, hi =
// rna(v), lo = rna(v - hi), and each product is lo.hi + hi.lo + hi.hi
// (3xTF32, as gmm_f32_tf32x3_kernel; a bf16 value has lo = 0, so on the
// int8 path every product is exact). The wgmma accumulator holds one
// block_t tile's partial at most; at the tile's end it is added into the
// fp32 total (registers) with ordinary rounded adds, in tile order: the
// Pallas kernel's revisit order, and no truncation bias in the long sum
// over an expert's tiles.
//
// Design:
//  - tf32 wgmma takes only K-major operands, and the contraction runs over
//    token rows, which neither x [T, K] nor dy [T, N] keeps contiguous. So
//    each thread loads its share of a 32-row stage straight from global
//    memory a stage ahead (into registers: the loads fly under the running
//    wgmmas), splits each value into hi and lo, and stores both transposed,
//    token-contiguous, in the 128-byte-swizzled K-major layout that the
//    wgmma descriptors read (x's as A [TG_BM dW rows][32 tokens], dy's as
//    B [TG_BN dW columns][32 tokens]; a warp's 32 stores hit 32 banks), in
//    one of three shared buffers. Timed in turns on an H100 at the int8
//    path's shapes (PERF.md): this kernel 1.36-1.39 ms a call; 3xTF32 on
//    mma.sync, whose fragments can be read transposed from a padded
//    staging tile, 1.98-2.01; the stores done by a third, producer
//    warpgroup 1.44-1.46; four tokens a 16-byte store 1.51-1.55; A from
//    registers (wgmma's RS form, half the stores; 184 bytes of spills)
//    1.43-1.44. A timing-only copy without the stores takes 0.69 ms (one
//    wgmma pass instead of three, with them: 1.04-1.07; without the proxy
//    fence: 1% less): the split operands' 64 KB of stores a stage, not the
//    products, hold it above its bound.
//  - Two consumer warpgroups own 64 dW rows each of a TG_BM x TG_BN CTA
//    tile and issue, per k8 step, lo.hi, hi.lo and hi.hi as m64n128k8
//    wgmmas (the small terms first; the first of a tile with scale_d 0).
//    A buffer is rewritten two stages after the wgmmas that read it, which
//    both warpgroups have retired by then (wait_group 1 every stage, one
//    barrier a stage). WHOLE (block_t % 32 == 0, the training path): a
//    tile's stages form the inner loop and its last batch retires outside
//    any branch (a wait_group in a branch makes ptxas serialize every
//    wgmma); else every k8 step retires before the next (a tile may end
//    inside a stage; no path runs it at a size that matters). Rows past
//    the expert's group and columns past K or N load as zeros.
//  - The grid is 1D: the experts in order of their row counts, largest
//    first (ties by index), each CTA ranking the group sizes itself (no
//    host sync), an expert's CTAs consecutive with column tiles fastest,
//    so a hot expert's CTAs start in the first wave and the CTAs in flight
//    share its x and dy rows in L2. No atomics: bitwise reproducible.
constexpr int TG_BM = 128, TG_BN = 128, TG_SR = 32;
constexpr int TG_PART = TG_BM * TG_SR * 4;       // one hi or lo operand: 16 KB
constexpr int TG_BUF = 4 * TG_PART;              // A hi, A lo, B hi, B lo
constexpr int TG_SMEM = 3 * TG_BUF + wg::ATOM;   // three buffers, 1 KB aligned
static_assert(TG_BM == TG_BN, "one layout for both operands");

template <bool WHOLE>
__global__ void __launch_bounds__(256, 1)
tgmm_f32_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const int* __restrict__ gs, float* __restrict__ dw, int K, int N,
                      int E, int block_t, int k_tiles, int n_tiles) {
  using namespace wg;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ int s_expert, s_start, s_rows;
  uint8_t* sm = ring_base(dyn_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_expert = k_tiles * n_tiles;
  const int rank = blockIdx.x / per_expert;
  const int n0 = (blockIdx.x % n_tiles) * TG_BN;
  const int k0 = (blockIdx.x % per_expert / n_tiles) * TG_BM;
  if (warp == 0) {  // the expert of this rank: most rows first, ties by index
    int mine = -1;
    for (int e = lane; e < E; e += 32) {
      const int n = gs[e];
      int r = 0;
      for (int j = 0; j < E; ++j) {
        const int m = gs[j];
        r += m > n || (m == n && j < e);
      }
      if (r == rank) mine = e;
    }
    const int e = __shfl_sync(0xffffffffu, mine,
                              __ffs(__ballot_sync(0xffffffffu, mine >= 0)) - 1);
    int before = 0;
    for (int i = lane; i < e; i += 32) before += gs[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    if (lane == 0) {
      s_expert = e;
      s_start = before;
      s_rows = gs[e];
    }
  }
  __syncthreads();
  const int start = s_start, rows = s_rows;
  float* out = dw + static_cast<size_t>(s_expert) * K * N;
  const int stages = (rows + TG_SR - 1) / TG_SR;

  // this thread's 16 elements of each operand in a stage: token 4 warp + kk,
  // columns 8 q + c8 (q < 16), stored at q x 1 KB + c8 x 128 B + the
  // swizzled 16-byte chunk (warp ^ c8) + kk x 4 B: 32 banks a warp
  const int c8 = lane & 7, kk = lane >> 3, tok = 4 * warp + kk;
  const uint32_t st_off = c8 * 128 + ((warp ^ c8) << 4) + kk * 4;
  float xr[16], dr[16];
  auto fetch = [&](int it) {
    const int r = it * TG_SR + tok;
    const bool live = r < rows;
    const float* xs = x + static_cast<size_t>(start + (live ? r : 0)) * K;
    const float* ds = dy + static_cast<size_t>(start + (live ? r : 0)) * N;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int m = k0 + 8 * q + c8, n = n0 + 8 * q + c8;
      xr[q] = live && m < K ? xs[m] : 0.f;
      dr[q] = live && n < N ? ds[n] : 0.f;
    }
  };
  auto stash = [&](int buf) {
    uint8_t* base = sm + buf * TG_BUF + st_off;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      uint32_t hi, lo;
      split_tf32(xr[q], hi, lo);
      *reinterpret_cast<uint32_t*>(base + q * 1024) = hi;
      *reinterpret_cast<uint32_t*>(base + TG_PART + q * 1024) = lo;
      split_tf32(dr[q], hi, lo);
      *reinterpret_cast<uint32_t*>(base + 2 * TG_PART + q * 1024) = hi;
      *reinterpret_cast<uint32_t*>(base + 3 * TG_PART + q * 1024) = lo;
    }
    fence_proxy_async();
  };

  const int g = tid / 128, t = tid % 128;
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
  // stage it's operands into its buffer, the next stage's loads in flight
  auto stage = [&](int it) {
    stash(it % 3);
    if (it + 1 < stages) fetch(it + 1);
    __syncthreads();  // the stage's operands are in place
  };
  // k8 step ks of stage it: lo.hi, hi.lo, hi.hi (scale_d 0 starts a tile)
  auto products = [&](int it, int ks, int scale_d) {
    const uint32_t a = smem_addr(sm + (it % 3) * TG_BUF) + g * (64 * 128) + ks * 32;
    const uint32_t b = smem_addr(sm + (it % 3) * TG_BUF) + 2 * TG_PART + ks * 32;
    WgmmaTF32::run(acc, desc(a + TG_PART, 16, ATOM), desc(b, 16, ATOM), scale_d);
    WgmmaTF32::run(acc, desc(a, 16, ATOM), desc(b + TG_PART, 16, ATOM), 1);
    WgmmaTF32::run(acc, desc(a, 16, ATOM), desc(b, 16, ATOM), 1);
  };
  if (stages > 0) fetch(0);
  int it = 0;
  if constexpr (WHOLE) {
    const int per = block_t / TG_SR;
    const int tiles = rows / block_t;
    for (int tile = 0; tile < tiles; ++tile) {
      for (int p = 0; p < per; ++p, ++it) {
        stage(it);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TG_SR / 8; ++ks) products(it, ks, p == 0 && ks == 0 ? 0 : 1);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous stage's batch has retired
        fence_acc(acc);
      }
      wgmma_wait<0>();  // the tile's last batch, outside any branch
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
    }
  } else {
    const int tile_steps = block_t / 8;
    int left = tile_steps, fresh = 1;
    for (; it < stages; ++it) {
      stage(it);
#pragma unroll
      for (int ks = 0; ks < TG_SR / 8; ++ks) {
        fence_acc(acc);
        wgmma_fence();
        products(it, ks, fresh ? 0 : 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        fresh = --left == 0;
        if (fresh) {  // a block_t tile ends: its partial joins the total
          left = tile_steps;
#pragma unroll
          for (int i = 0; i < 64; ++i) total[i] += acc[i];
        }
      }
    }
  }

  // thread t: dW rows kr, kr + 8 and columns 8 j + 2 (t % 4) (+ 1) of its 64 x 128 block
  const int kr = k0 + g * 64 + 16 * (t / 32) + (t % 32) / 4;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = kr + 8 * h;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TG_BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (t % 4);
      float* o = out + static_cast<size_t>(k) * N + c;
      const float v0 = total[4 * j + 2 * h], v1 = total[4 * j + 2 * h + 1];
      if (pairs && c + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (c < N) o[0] = v0;
        if (c + 1 < N) o[1] = v1;
      }
    }
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
using wg::dense_map;

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
  int err = dense_map(&mx, x, 2, xd, xb);
  if (err != 0) return err;
  if (WT) {  // w [E, N, K]: boxes of BN rows x 64
    const cuuint64_t wd[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(E)};
    const cuuint32_t wb[3] = {wg::BK, BN, 1};
    err = dense_map(&mw, w, 3, wd, wb);
  } else {   // w [E, K, N]: boxes of 64 K-rows x 64 columns
    const cuuint64_t wd[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
    const cuuint32_t wb[3] = {wg::BOX, wg::BK, 1};
    err = dense_map(&mw, w, 3, wd, wb);
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

int launch_tgmm_f32(const void* x, const void* dy, const int* gs, void* dw, int K, int N,
                    int E, int block_t, cudaStream_t stream) {
  const bool whole = block_t % TG_SR == 0;
  const auto kernel = whole ? tgmm_f32_wgmma_kernel<true> : tgmm_f32_wgmma_kernel<false>;
  static std::atomic<unsigned long long> ready[2];
  const int err = allow_smem(ready[whole ? 1 : 0], kernel, TG_SMEM);
  if (err != 0) return err;
  const int k_tiles = (K + TG_BM - 1) / TG_BM, n_tiles = (N + TG_BN - 1) / TG_BN;
  kernel<<<E * k_tiles * n_tiles, 256, TG_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), gs,
      static_cast<float*>(dw), K, N, E, block_t, k_tiles, n_tiles);
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
  int err = dense_map(&mx, x, 2, xd, box);
  if (err == 0) err = dense_map(&md, dy, 2, dd, box);
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


// ---------------------------------------------------------------------------
// gmm_int8: the grouped GEMM of matmul_precision "int8" (model training).
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py::
// _gmm_int8_impl), a real int8 x int8 -> int32 contraction, and PyTorch has
// no grouped int8 product on CUDA (torch._grouped_mm takes no int8,
// torch._int_mm is one 2-D product). For xq int8 [T, K] with row scales
// sx fp32 [T], and the expert banks quantized per output column, given here
// transposed, wqt int8 [E, N, K], with column scales sw fp32 [E, N]:
//
//     acc[r, n] = sum_k xq[r, k] * wqt[e(r), n, k]          (exact, int32)
//     out[r, n] = float(acc[r, n]) * sx[r] * sw[e(r), n]    in out's type
//     out[r, :] = 0                                         for tail rows
//
// the epilogue in JAX's order, ((float(acc) * sx) * sw), then one rounding
// to out's type (bf16 or fp32). With acc32 not null the int32 sums are also
// written there, so a check can hold them bitwise.
//
// What bounds it on an H100 SXM: at the MoE training path's gate/up
// (T ~ 66K, K 512, N 1536) the bytes (int8 operands read once, a bf16
// output written once: ~0.24 GB, 0.072 ms at 3.35 TB/s) against 0.10 TOP
// at 1,979 int8 TOP/s (0.052 ms): bytes, barely.
//
// Two variants, chosen by the wrapper before launch from the shapes
// (ops/grouped_matmul.py::gmm_int8_variant):
//  - "wgmma" (block_t % 64 == 0, N % 8 == 0, 16-byte aligned operands; the
//    training path's block_t 128): gmm_int8_wgmma_kernel, an s8 wgmma fed by
//    a TMA ring (its note below).
//  - "mma_sync" (block_t 16 or 32, or shapes outside the wgmma kernel's
//    rules): gmm_int8_kernel, mma.sync.m16n8k32 s8 with an s32 accumulator,
//    both operands K-major (the B operand's "col" layout is wqt's rows),
//    16-byte cp.async copies into a 3-stage ring of 64-byte K slices whose
//    shared rows are padded to 80 bytes (the fragment loads, 4 bytes a
//    thread, then hit 32 banks). A CTA is 4 warps over BM (16, 32 or 64)
//    rows x 128 columns; warp w owns columns 32w..32w+31 over all BM rows.
//    wgmma has no row tile below 64, which would straddle two experts at
//    block_t 16 or 32.
constexpr int I8_BN = 128, I8_BK = 64, I8_LD = 80, I8_STAGES = 3, I8_WARPS = 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void i8_store2(float* out, size_t at, float v0, float v1, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  } else {
    out[at] = v0;
  }
}

__device__ __forceinline__ void i8_store2(__nv_bfloat16* out, size_t at, float v0, float v1,
                                          bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
  } else {
    out[at] = __float2bfloat16(v0);
  }
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(I8_WARPS * 32)
gmm_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
                const int* __restrict__ gs, const float* __restrict__ sx,
                const float* __restrict__ sw, OutT* __restrict__ out,
                int* __restrict__ acc32, int T, int K, int N, int E) {
  constexpr int MT = BM / 16;  // m16 tiles a warp runs
  __shared__ __align__(16) int8_t As[I8_STAGES][BM * I8_LD];
  __shared__ __align__(16) int8_t Bs[I8_STAGES][I8_BN * I8_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * I8_BN;
  const int e = expert_of_row_warp(gs, E, r0, lane);
  const int g = lane >> 2, t = lane & 3;
  if (e < 0) {  // tail tile: zeros
    for (int i = tid; i < BM * I8_BN; i += I8_WARPS * 32) {
      const int r = r0 + i / I8_BN, c = c0 + i % I8_BN;
      if (c < N) {
        out[(size_t)r * N + c] = OutT(0.0f);
        if (acc32 != nullptr) acc32[(size_t)r * N + c] = 0;
      }
    }
    return;
  }
  const int8_t* we = wqt + (size_t)e * N * K;
  const int k_tiles = K / I8_BK;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * I8_BK;
    for (int i = tid; i < BM * (I8_BK / 16); i += I8_WARPS * 32) {
      const int r = i / (I8_BK / 16), kk = (i % (I8_BK / 16)) * 16;
      wg::cp_async<16>(reinterpret_cast<float*>(&As[stage][r * I8_LD + kk]),
                       reinterpret_cast<const float*>(xq + (size_t)(r0 + r) * K + k0 + kk),
                       true);
    }
    for (int i = tid; i < I8_BN * (I8_BK / 16); i += I8_WARPS * 32) {
      const int n = i / (I8_BK / 16), kk = (i % (I8_BK / 16)) * 16;
      const bool in = c0 + n < N;
      wg::cp_async<16>(reinterpret_cast<float*>(&Bs[stage][n * I8_LD + kk]),
                       reinterpret_cast<const float*>(in ? we + (size_t)(c0 + n) * K + k0 + kk
                                                         : wqt),
                       in);
    }
  };
  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int st = 0; st < I8_STAGES - 1; ++st) {
    if (st < k_tiles) load(st, st);
    wg::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    wg::cp_async_wait<I8_STAGES - 2>();  // this thread's copies of stage kt landed
    __syncthreads();                     // everyone's; and stage kt - 1 is free
    if (kt + I8_STAGES - 1 < k_tiles) load((kt + I8_STAGES - 1) % I8_STAGES, kt + I8_STAGES - 1);
    wg::cp_async_commit();
    const int8_t* a_s = As[kt % I8_STAGES];
    const int8_t* b_s = Bs[kt % I8_STAGES];
#pragma unroll
    for (int ks = 0; ks < I8_BK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = a_s + (i * 16 + g) * I8_LD + ks + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * I8_LD);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * I8_LD + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b_s + (warp * 32 + j * 8 + g) * I8_LD + ks + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
  }
  wg::cp_async_wait<0>();

  const float* swe = sw + (size_t)e * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const int r = r0 + i * 16 + g + 8 * h;
      const float sr = sx[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + warp * 32 + j * 8 + 2 * t;
        if (c >= N) continue;
        const bool pair = c + 1 < N && (N % 2 == 0);
        const int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const float y0 = (static_cast<float>(v0) * sr) * swe[c];
        const float y1 = c + 1 < N ? (static_cast<float>(v1) * sr) * swe[c + 1] : 0.0f;
        const size_t at = (size_t)r * N + c;
        i8_store2(out, at, y0, y1, pair);
        if (!pair && c + 1 < N) i8_store2(out, at + 1, y1, 0.0f, false);
        if (acc32 != nullptr) {
          acc32[at] = v0;
          if (c + 1 < N) acc32[at + 1] = v1;
        }
      }
    }
  }
}

template <int BM>
int launch_gmm_int8(const void* xq, const void* wqt, const int* gs, const float* sx,
                    const float* sw, void* out, int* acc32, int T, int K, int N, int E,
                    int dtype, cudaStream_t s) {
  const dim3 grid(T / BM, (N + I8_BN - 1) / I8_BN);
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* w8 = static_cast<const int8_t*>(wqt);
  if (dtype == 1)
    gmm_int8_kernel<BM, __nv_bfloat16><<<grid, I8_WARPS * 32, 0, s>>>(
        x8, w8, gs, sx, sw, static_cast<__nv_bfloat16*>(out), acc32, T, K, N, E);
  else
    gmm_int8_kernel<BM, float><<<grid, I8_WARPS * 32, 0, s>>>(
        x8, w8, gs, sx, sw, static_cast<float*>(out), acc32, T, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

// gmm_int8_wgmma_kernel ("wgmma"): gmm_int8 at block_t % 64 == 0. The same
// function as gmm_int8_kernel, the int32 sums bit for bit (integer sums are
// exact in any order).
//
// Design: gmm_bf16_wgmma_kernel's, in bytes. CTA tile BM x I8W_BN with
// BM = 64 NWG rows (128 where block_t allows, else 64: a CTA never
// straddles two experts); NWG consumer warpgroups each own 64 rows and
// issue wgmma.m64nI8W_BNk32 .s32.s8.s8 (s32 accumulators in registers);
// one producer warp (the last) keeps TMA loads in flight. An 8-bit wgmma
// takes only K-major operands, and both are: xq [T, K] (one box of BM rows
// x 128 bytes of K) and wqt [E, N, K] (one box of I8W_BN rows x 128 bytes,
// a 3D tensor map, so a ragged N edge zero-fills and never reads the next
// expert's rows). A ring of I8W_STAGES stages, 128-byte swizzle, full/empty
// mbarriers; a warpgroup releases a stage once the wgmma group that read it
// has retired (at most one group in flight), and no wgmma sits under a
// branch. The grid is 1D with column tiles fastest (a row tile's CTAs run
// together and read its x rows from HBM once). Tail tiles load nothing and
// write zeros. Epilogue: (float(acc) * sx[r]) * sw[e, c] in fp32, then bf16
// output staged through the idle ring and written with 16-byte stores
// (fp32 output and the int32 sums, off the training path, straight from
// registers).
constexpr int I8W_BN = 256, I8W_STAGES = 4;
constexpr int I8W_BK = 128;  // K bytes per stage: four k32 steps

template <int NWG>
constexpr int i8_wg_smem() {
  return I8W_STAGES * (NWG * 64 + I8W_BN) * I8W_BK + wg::ATOM;
}

template <int NWG, typename OutT>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
gmm_int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const int* __restrict__ gs, const float* __restrict__ sx,
                      const float* __restrict__ sw, OutT* __restrict__ out,
                      int* __restrict__ acc32, int K, int N, int E, int col_tiles) {
  using namespace wg;
  constexpr int BN = I8W_BN, STAGES = I8W_STAGES, BM = NWG * 64;
  constexpr int A_BYTES = BM * I8W_BK;
  constexpr int B_BYTES = BN * I8W_BK;
  constexpr int STAGE = A_BYTES + B_BYTES;
  static_assert(NWG * 64 * (BN * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ int s_expert;
  __shared__ float s_sw[BN];  // the tile's column scales, for the epilogue
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
    for (int i = tid; i < BM * cols; i += blockDim.x) {
      const size_t at = (r0 + i / cols) * N + n0 + i % cols;
      out[at] = OutT(0.0f);
      if (acc32 != nullptr) acc32[at] = 0;
    }
    return;
  }
  for (int i = tid; i < BN; i += blockDim.x)
    s_sw[i] = i < cols ? sw[static_cast<size_t>(e) * N + n0 + i] : 0.f;
  __syncthreads();
  const int nk = (K + I8W_BK - 1) / I8W_BK;

  if (tid / 32 == NWG * 4) {  // producer warp
    if (tid % 32 == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        const uint32_t a = smem_addr(ring + s * STAGE), b = a + A_BYTES;
        const uint32_t bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, STAGE);
        tma_2d(a, &map_x, bar, kb * I8W_BK, static_cast<int>(r0));
        tma_3d(b, &map_w, bar, kb * I8W_BK, n0, e);
      }
    }
    return;
  }

  // consumer warpgroup g: rows [r0 + 64 g, r0 + 64 g + 64)
  const int g = tid / 128, t = tid % 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    const uint32_t a = smem_addr(ring + s * STAGE) + g * (64 * I8W_BK);
    const uint32_t b = smem_addr(ring + s * STAGE) + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < I8W_BK / 32; ++ks)
      WgmmaS8<BN>::run(acc, desc(a + ks * 32, 16, ATOM), desc(b + ks * 32, 16, ATOM), 1);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's group has retired
    fence_acc(acc);
    if (kb > 0 && t == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // thread t: rows rr, rr + 8 and columns 8 j + 2 (t % 4) (+ 1) of its 64 x BN block
  const size_t rr = r0 + g * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int cc = n0 + 2 * (t % 4);
  if (acc32 != nullptr) {  // the sums, for a check (N is even: pairs)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = cc + 8 * j;
      if (c < N) {
        *reinterpret_cast<int2*>(acc32 + rr * N + c) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(acc32 + (rr + 8) * N + c) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  const float s_lo = sx[rr], s_hi = sx[rr + 8];
  // (float(acc) * sx) * sw, JAX's order; columns past N give zeros, never
  // stored. In groups of 8 columns' worth, each fenced from the next, so
  // the compiler does not hoist every scale load at once (registers).
  const auto scaled = [&](int j, float (&y)[4]) {
    if (j % 4 == 0) asm volatile("" ::: "memory");
    const int c = 8 * j + 2 * (t % 4);
    const float w0 = s_sw[c], w1 = s_sw[c + 1];
    y[0] = (static_cast<float>(acc[4 * j]) * s_lo) * w0;
    y[1] = (static_cast<float>(acc[4 * j + 1]) * s_lo) * w1;
    y[2] = (static_cast<float>(acc[4 * j + 2]) * s_hi) * w0;
    y[3] = (static_cast<float>(acc[4 * j + 3]) * s_hi) * w1;
  };
  if constexpr (sizeof(OutT) == 4) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float y[4];
      scaled(j, y);
      const int c = cc + 8 * j;
      if (c < N) {
        *reinterpret_cast<float2*>(out + rr * N + c) = make_float2(y[0], y[1]);
        *reinterpret_cast<float2*>(out + (rr + 8) * N + c) = make_float2(y[2], y[3]);
      }
    }
  } else {
    uint32_t v[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float y[4];
      scaled(j, y);
      v[2 * j] = pack_bf16(y[0], y[1]);
      v[2 * j + 1] = pack_bf16(y[2], y[3]);
    }
    bar_sync(1, NWG * 128);  // every warpgroup is past its last wgmma: the ring is idle
    store_tile<BN>(v, ring + g * 64 * (BN * 2 + 16), reinterpret_cast<__nv_bfloat16*>(out),
                   N, r0 + g * 64, 64, n0, cols, t, 2 + g);
  }
}

template <int NWG>
int launch_gmm_int8_wgmma(const void* xq, const void* wqt, const int* gs, const float* sx,
                          const float* sw, void* out, int* acc32, int T, int K, int N, int E,
                          int dtype, cudaStream_t stream) {
  constexpr int BM = NWG * 64;
  CUtensorMap mx, mw;
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(T)};
  const cuuint32_t xb[2] = {I8W_BK, BM};
  int err = dense_map(&mx, xq, 2, xd, xb, 1);
  if (err != 0) return err;
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(E)};
  const cuuint32_t wb[3] = {I8W_BK, I8W_BN, 1};
  err = dense_map(&mw, wqt, 3, wd, wb, 1);
  if (err != 0) return err;
  constexpr int smem = i8_wg_smem<NWG>();
  const int col_tiles = (N + I8W_BN - 1) / I8W_BN;
  const int blocks = col_tiles * (T / BM);
  if (dtype == 1) {
    const auto kernel = gmm_int8_wgmma_kernel<NWG, __nv_bfloat16>;
    static std::atomic<unsigned long long> ready{0};
    err = allow_smem(ready, kernel, smem);
    if (err != 0) return err;
    kernel<<<blocks, NWG * 128 + 32, smem, stream>>>(
        mx, mw, gs, sx, sw, static_cast<__nv_bfloat16*>(out), acc32, K, N, E, col_tiles);
  } else {
    const auto kernel = gmm_int8_wgmma_kernel<NWG, float>;
    static std::atomic<unsigned long long> ready{0};
    err = allow_smem(ready, kernel, smem);
    if (err != 0) return err;
    kernel<<<blocks, NWG * 128 + 32, smem, stream>>>(
        mx, mw, gs, sx, sw, static_cast<float*>(out), acc32, K, N, E, col_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. bm: CTA row tile, dividing block_t: 16 or 32
// (fp32: the wrapper picks min(block_t, 32); fp32 at block_t 8 goes to
// gmm_f32_decode), 8, 16 or 32 (bf16 WMMA), or 64 or 128
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

// fp32 at block_t 8: gmm_f32_decode_kernel ("f32_decode"). kc: rows of K
// per work item (ops/grouped_matmul.py::decode_plan), at most DEC_KC_MAX;
// partial: fp32 scratch of ceil(K / kc) x T x N (unread with one chunk);
// counters: (T / 8) x ceil(N / DEC_COLS) ints, zero on entry and left zero.
// w_trans as for gmm_forward. Returns a cudaError_t.
extern "C" int gmm_f32_decode(const void* x, const void* w, const int* group_sizes,
                              void* out, void* partial, int* counters, int T, int K,
                              int N, int E, int kc, int w_trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = kc > 0 ? (K + kc - 1) / kc : 0;
  const int strips = (N + DEC_COLS - 1) / DEC_COLS;
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || T % DEC_ROWS != 0 || kc <= 0 ||
      kc > DEC_KC_MAX || chunks > 65535 || strips > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T / DEC_ROWS, chunks, strips);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = !w_trans && N % 4 == 0 && aligned(w) && aligned(out) && aligned(partial);
  const auto kernel = w_trans ? gmm_f32_decode_kernel<true, false>
                      : vec   ? gmm_f32_decode_kernel<false, true>
                              : gmm_f32_decode_kernel<false, false>;
  static std::atomic<unsigned long long> ready[3];
  const int err = wg::allow_smem(ready[w_trans ? 0 : vec ? 1 : 2], kernel,
                                 dec_smem(DEC_KC_MAX));
  if (err != 0) return err;
  kernel<<<grid, DEC_WARPS * 32, dec_smem(kc), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), group_sizes,
      static_cast<float*>(out), static_cast<float*>(partial), counters, T, K, N, E, kc);
  return static_cast<int>(cudaGetLastError());
}

// dw [E, K, N] from x [T, K] and dy [T, N] (one type). kernel: 0 = fp32
// (3xTF32 on wgmma), 1 = bf16 on WMMA, 2 = bf16 on the TMA/wgmma kernel (block_t % 64 == 0,
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
  if (kernel == 0) return launch_tgmm_f32(x, dy, group_sizes, dw, K, N, E, block_t, s);
  dim3 grid((N + TB - 1) / TB, (K + TB - 1) / TB, E);
  if (kernel == 1) {
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

// matmul_precision "int8": xq int8 [T, K], wqt int8 [E, N, K] (each expert's
// quantized bank transposed, K-major), sx fp32 [T], sw fp32 [E, N]; out
// [T, N] in dtype (0 = fp32, 1 = bf16); acc32 int32 [T, N] or null. K a
// multiple of 64 (the wrapper pads with zeros); 16-byte aligned xq and wqt.
// variant 1 ("wgmma"): bm 64 or 128, dividing block_t; N a multiple of 8;
// out and acc32 16-byte aligned (checked here). variant 0 ("mma_sync"): bm
// 16, 32 or 64, dividing block_t. Returns a cudaError_t.
extern "C" int gmm_int8(const void* xq, const void* wqt, const int* group_sizes,
                        const float* sx, const float* sw, void* out, int* acc32, int T,
                        int K, int N, int E, int bm, int variant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || K % I8_BK != 0 || (dtype != 0 && dtype != 1) ||
      bm <= 0 || T % bm != 0 || !aligned(xq) || !aligned(wqt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    if (!(bm == 64 || bm == 128) || N % 8 != 0 || !aligned(out) ||
        (acc32 != nullptr && !aligned(acc32)))
      return static_cast<int>(cudaErrorInvalidValue);
    return bm == 128
               ? launch_gmm_int8_wgmma<2>(xq, wqt, group_sizes, sx, sw, out, acc32, T, K, N, E,
                                          dtype, s)
               : launch_gmm_int8_wgmma<1>(xq, wqt, group_sizes, sx, sw, out, acc32, T, K, N, E,
                                          dtype, s);
  }
  if (variant != 0 || !(bm == 16 || bm == 32 || bm == 64) || (N + I8_BN - 1) / I8_BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64) return launch_gmm_int8<64>(xq, wqt, group_sizes, sx, sw, out, acc32, T, K, N, E, dtype, s);
  if (bm == 32) return launch_gmm_int8<32>(xq, wqt, group_sizes, sx, sw, out, acc32, T, K, N, E, dtype, s);
  return launch_gmm_int8<16>(xq, wqt, group_sizes, sx, sw, out, acc32, T, K, N, E, dtype, s);
}
