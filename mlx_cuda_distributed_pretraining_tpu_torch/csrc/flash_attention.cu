// Flash attention forward, dQ and dK/dV for NVIDIA Hopper (sm_90a).
//
// Replaces, in mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:
//   flash_fwd_bf16_wgmma_kernel, flash_fwd_f32_kernel
//                                                   <- flash_fwd (Pallas body
//                                                      _fwd_kernel)
//   flash_bwd_dq_bf16_wgmma_kernel, flash_bwd_dq_kernel
//                                                   <- flash_bwd_dq (_bwd_dq_kernel)
//   flash_bwd_dkv_bf16_wgmma_kernel, flash_bwd_dkv_kernel
//                                                   <- flash_bwd_dkv (_bwd_dkv_kernel)
//
// Variants (the wrapper's flash_variant picks one before launch; the C
// entries take its code):
//   "wgmma"  bf16 at head dims 16, 32, 64 and 128, all three functions: a
//            TMA ring feeding wgmma, the scores, P and dS kept in registers
//            (their own note below);
//   "f32"    fp32 at head dims 16, 32, 64 and 128: the forward on 3xTF32
//            mma.sync with a cp.async ring (its own note below); dQ and
//            dK/dV on SIMT FMA tiles.
//
// Each computes what its Pallas body computes (not block by block):
//   fwd:  s = (q . k^T) * scale in fp32, through the score mod (below),
//         masked to NEG_INF = -1e30; online
//         softmax with running max m, denominator l and an fp32 accumulator,
//         p cast to v's type before p . v; o = acc / max(l, 1e-30) in q's
//         type and lse = m + log(max(l, 1e-30)) in fp32.
//   dQ:   p = exp(s - lse), ds = p * (dO . v^T - delta) [* the mod's
//         Jacobian] * scale, dq += ds.to(k type) . k in fp32; output in
//         q's type.
//   dK/dV (per query head): dv += p.to(dO type)^T . dO and
//         dk += ds.to(q type)^T . q. A CTA owns one KV tile and walks the
//         live Q tiles, so neither output needs atomics: bitwise
//         reproducible.
//
// Layout: every operand is read through (batch, head, seq) element strides
// with a contiguous head dim, so the [B, S, H, D] activations of the model
// are read in place (no transpose copies). lse and delta are [B, Hq, S]
// fp32. Query head h reads KV head h / (Hq / Hkv) (GQA).
//
// Block sparsity: the host plans, per Q tile, the live KV tile range (and per
// KV tile the live Q tile range) with the JAX package's _kv_range/_q_range
// semantics, plus a per-tile "full" flag (_full_tile_fn, and the tile lies
// inside S). Dead tiles are never loaded; full tiles skip the mask; the rest
// evaluate the mask predicate and the bounds of a ragged S.
//
// Masks: full, causal, sliding_window (causal and row - col < window),
// prefix_lm, band (row - col < window with no causal bound: ring
// attention's off-diagonal chunk).
//
// Score mods (the flex path; JAX ops/flex_attention.py): a code and one
// number, on s_raw = scale q . k^T in natural units, before the mask:
//   alibi    s_raw - 2^(-8 (h + 1) / H) |row - col|, h the query head and H
//            the number (the model's head count);
//   soft_cap cap tanh(s_raw / cap), cap the number; its Jacobian
//            1 - tanh^2(s_raw / cap) multiplies dS before the scale.
// A masked score is NEG_INF whatever the mod gave; a tile flagged full
// still takes the mod. The wgmma kernels take the mod as a template
// parameter (a runtime branch around a wgmma makes ptxas serialize them
// all) and compute tanh branch-free from ex2.approx (tanh_exp2 below:
// tanh.approx.f32, 2^-11 relative, failed the bf16 gate at cap 50); the
// fp32 kernels switch on it at run time and use tanhf.
//
// Types: bf16 runs the wgmma kernels at all four head dims; fp32 runs the
// 3xTF32 forward and the SIMT dQ and dK/dV (32-row tiles) at all four. Head
// dims are template instances.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// training path's shape B 32, H 8, S 1024, D 64, bf16, causal:
//   fwd   34.4 GFLOP, ~135 MB  -> 0.040 ms (bytes; operations 0.035 ms)
//   dQ    51.5 GFLOP, ~170 MB  -> 0.052 ms (operations)
//   dK/dV 68.7 GFLOP, ~203 MB  -> 0.070 ms (operations)
// All three are operation-bound in principle, and beside the tensor cores
// each pays an exp per score on the SFU (16 a clock per SM: the exps of a
// 128 x 128 tile take as long as its two 64-deep products at peak). The
// fp32 dQ and dK/dV stage tiles through shared memory and round-trip the
// scores through it, one 4-warp CTA per tile. The wgmma kernels and the
// fp32 forward keep the scores in registers (notes below); the wgmma ones
// let one warpgroup's softmax run under the other's products.
//
// Interface: plain C, loaded with ctypes. Each *_launch returns
// cudaGetLastError() after the launch (0 on success); nothing synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"  // namespace wg: TMA, mbarriers, wgmma; tensor maps

namespace {

constexpr float NEG_INF = -1e30f;  // large-but-finite, as ops/masks.py
constexpr int NTHREADS = 128;      // 4 warps per CTA (the SIMT kernels)

// Mask codes (the wrapper's _MASK_CODES).
constexpr int MASK_FULL = 0;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_SLIDING = 2;
constexpr int MASK_PREFIX = 3;
constexpr int MASK_BAND = 4;

// Score-mod codes (the wrapper's _MOD_CODES).
constexpr int MOD_NONE = 0;
constexpr int MOD_ALIBI = 1;
constexpr int MOD_SOFTCAP = 2;

}  // namespace

// Every field is 8 bytes wide, so the ctypes mirror has no padding to match.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // fwd: o; dQ: dq; dK/dV: dk
  void* out1;  // dK/dV: dv
  float* lse_out;
  const int32_t* ranges;  // [n_tiles, 2] live [lo, hi) of the other axis
  const uint8_t* full;    // [nq, nk]: 1 = tile needs no mask
  int64_t B, Hq, Hkv, S, nq, nk;
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], s0[3], s1[3];  // (b, h, s)
  int64_t mask_type, window, prefix;
  double scale;
  int64_t score_mod;  // MOD_*
  double score_arg;   // alibi: the head count H; soft_cap: the cap
};

namespace {

// ALiBi's slope of query head h, 2^(-8 (h + 1) / H), in fp32 as JAX's
// alibi_score_fn computes it.
__device__ __forceinline__ float alibi_slope(int h, double heads) {
  return exp2f(-8.f * (static_cast<float>(h) + 1.f) / static_cast<float>(heads));
}

// The fp32 kernels' score mod of s = scale q . k (natural units): the
// modded score, and the mod's Jacobian in *dmod (1 unless soft_cap).
__device__ __forceinline__ float f32_mod(int mod, float s, int64_t row, int64_t col,
                                         float slope, float cap, float* dmod) {
  if (mod == MOD_ALIBI) return s - slope * static_cast<float>(row > col ? row - col : col - row);
  if (mod == MOD_SOFTCAP) {
    const float t = tanhf(s / cap);
    *dmod = 1.f - t * t;
    return cap * t;
  }
  return s;
}

__device__ __forceinline__ bool allowed(int mask, int64_t row, int64_t col,
                                        int64_t window, int64_t prefix) {
  switch (mask) {
    case MASK_CAUSAL: return row >= col;
    case MASK_SLIDING: return row >= col && row - col < window;
    case MASK_PREFIX: return row >= col || col < prefix;
    case MASK_BAND: return row - col < window;
    default: return true;
  }
}

// Shared-memory leading dim of the SIMT tiles: fp32 rows padded by 4
// floats (spreads banks).
template <int N>
struct LdF {
  static constexpr int value = N + 4;
};

// Copy rows [row0, row0 + ROWS) of a [S, D] fp32 slab (row stride `stride`
// elements, contiguous D) into shared memory; rows past S are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t stride,
                                          int64_t row0, int64_t S) {
  constexpr int CPR = D / 4;
  constexpr int LD = LdF<D>::value;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// C[M, N] (row-major, ldc) (+)= A[M, K] . B[K, N], fp32 operands in shared
// memory, SIMT FMA. A_COL: A is stored transposed (element (m, k) at
// A[k * lda + m]); B_COL: element (k, n) at B[n * ldb + k].
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACCUM>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += NTHREADS) {
    const int m = i / N, n = i % N;
    float s = ACCUM ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
      const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// Bump allocator over dynamic shared memory (128-byte aligned pieces).
struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ __forceinline__ U* take(int count) {
    U* out = reinterpret_cast<U*>(p);
    p += ((size_t)count * sizeof(U) + 127) / 128 * 128;
    return out;
  }
};

__host__ __device__ constexpr size_t rup(size_t b) { return (b + 127) / 128 * 128; }

// ------------------------------------------------------------------- fp32 dQ
template <int D, int BM>
constexpr size_t dq_smem() {
  constexpr int BN = BM;
  return 5 * rup(sizeof(float) * BM * LdF<D>::value) +
         3 * rup(sizeof(float) * BM * LdF<BN>::value) + 2 * rup(sizeof(float) * BM);
}

template <int D, int BM>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int BN = BM;
  constexpr int LDT = LdF<D>::value, LDS = LdF<BN>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(BM * LDT);
  float* dOs = cv.take<float>(BM * LDT);
  float* Ks = cv.take<float>(BN * LDT);
  float* Vs = cv.take<float>(BN * LDT);
  float* Ss = cv.take<float>(BM * LDS);
  float* dPs = cv.take<float>(BM * LDS);
  float* dSs = cv.take<float>(BM * LDS);
  float* Acc = cv.take<float>(BM * LDT);
  float* lse_s = cv.take<float>(BM);
  float* delta_s = cv.take<float>(BM);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (int)(a.Hq / a.Hkv);
  const int64_t S = a.S, q0 = (int64_t)qt * BM;
  const float scale = (float)a.scale;
  const int mask = (int)a.mask_type;
  const int mod = (int)a.score_mod;
  const float slope = mod == MOD_ALIBI ? alibi_slope(h, a.score_arg) : 0.f;
  const float cap = (float)a.score_arg;

  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  load_tile<D, BM>(Qs, qg, a.sq[2], q0, S);
  load_tile<D, BM>(dOs, dog, a.sdo[2], q0, S);
  const int64_t stat0 = ((int64_t)b * a.Hq + h) * S;
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? a.lse_in[stat0 + q0 + r] : 0.f;
    delta_s[r] = in ? a.delta[stat0 + q0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < BM * LDT; i += NTHREADS) Acc[i] = 0.f;
  const int lo = a.ranges[2 * qt], hi = a.ranges[2 * qt + 1];
  for (int j = lo; j < hi; ++j) {
    const int64_t k0 = (int64_t)j * BN;
    __syncthreads();
    load_tile<D, BN>(Ks, kg, a.sk[2], k0, S);
    load_tile<D, BN>(Vs, vg, a.sv[2], k0, S);
    __syncthreads();
    mm<BM, BN, D, false, true, false>(Ss, LDS, Qs, LDT, Ks, LDT);    // q k^T
    mm<BM, BN, D, false, true, false>(dPs, LDS, dOs, LDT, Vs, LDT);  // dO v^T
    __syncthreads();
    const bool full = a.full[(int64_t)qt * a.nk + j] != 0;
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int64_t row = q0 + r, col = k0 + c;
      float s = Ss[r * LDS + c] * scale;
      float p, dmod = 1.f;
      if (!full && (row >= S || col >= S)) {
        p = 0.f;
      } else {
        s = f32_mod(mod, s, row, col, slope, cap, &dmod);
        if (!full && !allowed(mask, row, col, a.window, a.prefix)) s = NEG_INF;
        p = expf(s - lse_s[r]);
      }
      float ds = p * (dPs[r * LDS + c] - delta_s[r]);
      if (mod == MOD_SOFTCAP) ds *= dmod;
      dSs[r * LDS + c] = ds * scale;
    }
    __syncthreads();
    mm<BM, D, BN, false, false, true>(Acc, LDT, dSs, LDS, Ks, LDT);  // += ds k
  }
  __syncthreads();
  float* dqg = static_cast<float*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  for (int i = threadIdx.x; i < BM * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < S) dqg[(q0 + r) * a.s0[2] + d] = Acc[r * LDT + d];
  }
}

// ---------------------------------------------------------------- fp32 dK/dV
template <int D, int BM>
constexpr size_t dkv_smem() {
  constexpr int BN = BM;
  return 6 * rup(sizeof(float) * BM * LdF<D>::value) +
         4 * rup(sizeof(float) * BM * LdF<BN>::value) + 2 * rup(sizeof(float) * BM);
}

template <int D, int BM>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int BN = BM;
  constexpr int LDT = LdF<D>::value, LDS = LdF<BN>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Ks = cv.take<float>(BN * LDT);
  float* Vs = cv.take<float>(BN * LDT);
  float* Qs = cv.take<float>(BM * LDT);
  float* dOs = cv.take<float>(BM * LDT);
  float* Ss = cv.take<float>(BM * LDS);
  float* dPs = cv.take<float>(BM * LDS);
  float* Ps = cv.take<float>(BM * LDS);
  float* dSs = cv.take<float>(BM * LDS);
  float* dK = cv.take<float>(BN * LDT);
  float* dV = cv.take<float>(BN * LDT);
  float* lse_s = cv.take<float>(BM);
  float* delta_s = cv.take<float>(BM);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (int)(a.Hq / a.Hkv);
  const int64_t S = a.S, k0 = (int64_t)kt * BN;
  const float scale = (float)a.scale;
  const int mask = (int)a.mask_type;
  const int mod = (int)a.score_mod;
  const float slope = mod == MOD_ALIBI ? alibi_slope(h, a.score_arg) : 0.f;
  const float cap = (float)a.score_arg;

  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  load_tile<D, BN>(Ks, kg, a.sk[2], k0, S);
  load_tile<D, BN>(Vs, vg, a.sv[2], k0, S);
  for (int i = threadIdx.x; i < BN * LDT; i += NTHREADS) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  const int64_t stat0 = ((int64_t)b * a.Hq + h) * S;
  const int lo = a.ranges[2 * kt], hi = a.ranges[2 * kt + 1];
  for (int j = lo; j < hi; ++j) {
    const int64_t q0 = (int64_t)j * BM;
    __syncthreads();
    load_tile<D, BM>(Qs, qg, a.sq[2], q0, S);
    load_tile<D, BM>(dOs, dog, a.sdo[2], q0, S);
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse_in[stat0 + q0 + r] : 0.f;
      delta_s[r] = in ? a.delta[stat0 + q0 + r] : 0.f;
    }
    __syncthreads();
    mm<BM, BN, D, false, true, false>(Ss, LDS, Qs, LDT, Ks, LDT);    // q k^T
    mm<BM, BN, D, false, true, false>(dPs, LDS, dOs, LDT, Vs, LDT);  // dO v^T
    __syncthreads();
    const bool full = a.full[(int64_t)j * a.nk + kt] != 0;
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int64_t row = q0 + r, col = k0 + c;
      float s = Ss[r * LDS + c] * scale;
      float p, dmod = 1.f;
      if (!full && (row >= S || col >= S)) {
        p = 0.f;
      } else {
        s = f32_mod(mod, s, row, col, slope, cap, &dmod);
        if (!full && !allowed(mask, row, col, a.window, a.prefix)) s = NEG_INF;
        p = expf(s - lse_s[r]);
      }
      float ds = p * (dPs[r * LDS + c] - delta_s[r]);
      if (mod == MOD_SOFTCAP) ds *= dmod;
      Ps[r * LDS + c] = p;
      dSs[r * LDS + c] = ds * scale;
    }
    __syncthreads();
    mm<BN, D, BM, true, false, true>(dV, LDT, Ps, LDS, dOs, LDT);  // += p^T dO
    mm<BN, D, BM, true, false, true>(dK, LDT, dSs, LDS, Qs, LDT);  // += ds^T q
  }
  __syncthreads();
  float* dkg = static_cast<float*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  float* dvg = static_cast<float*>(a.out1) + b * a.s1[0] + h * a.s1[1];
  for (int i = threadIdx.x; i < BN * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    if (k0 + r < S) {
      dkg[(k0 + r) * a.s0[2] + d] = dK[r * LDT + d];
      dvg[(k0 + r) * a.s1[2] + d] = dV[r * LDT + d];
    }
  }
}

// ============================================ bf16 on a TMA ring with wgmma
// flash_fwd_bf16_wgmma_kernel, flash_bwd_dq_bf16_wgmma_kernel and
// flash_bwd_dkv_bf16_wgmma_kernel ("wgmma"): the bf16 forward, dQ and
// dK/dV. All run 256 threads, two consumer
// warpgroups of 64 rows each, and one elected thread or warp of them issues
// the loads (no producer warp: a 9th warp puts 3 warps on one SM
// sub-partition and caps every thread at 168 registers). Every operand
// comes in through a 4-D tensor map over its strided [B, H, S, D] view
// (dims D, S, H, B; boxes min(D, 64) columns wide, one swizzle span a row:
// 128 bytes at D 64 and 128, 64 at D 32, 32 at D 16; Geo below), so the model's
// [B, S, H, D] activations are read in place and rows past S arrive as
// zeros; K/V (forward, dQ) or Q/dO (dK/dV) tiles flow through a ring of
// full/empty mbarriers (namespace wg, hopper.cuh). The score tile, P and
// dS never leave registers: an SS wgmma writes the fp32 scores into the
// accumulator layout, the softmax (or the backward's elementwise pass) runs
// there, and the same registers, rounded to bf16 pair by pair, are the A
// operand of an RS wgmma (wg::WgmmaRS), whose B (V, K, dO or Q, stored
// row-major [rows x D]) is read MN-major (the transpose-B flag). The two
// warpgroups take turns at the tensor cores (named barriers BAR_TURN + g),
// so one's exps and elementwise work run under the other's products.
// Scores are scaled by scale * log2(e) and exponentiated with ex2.approx:
// exp(s - m) = 2^(s log2 e - m log2 e), so m and lse are kept in base 2
// inside and lse is written as m ln 2 + log(l); the forward's o is
// acc * (1 / max(l, 1e-30)) (one rounding more than the division).
// What ptxas needs to keep the wgmmas asynchronous (it serializes every
// wgmma of a kernel, advisory C7513/C7520, when a wgmma input is defined
// inside a batch): no wgmma in a branch; no accumulator or A-fragment
// register touched between issue and wait, and fences (fence_acc,
// fence_regs) that pin them before the batch opens; score accumulators
// fresh per tile; and every shared-memory descriptor in uniform registers,
// so the warpgroup index and the stage index reach them through shuffles.
// Head dims 16 and 32: the same kernels on boxes one row of D wide, a row
// one swizzle span (64 or 32 bytes), so a K-major operand takes D / 16 k16
// steps of 32 bytes within its row and an MN-major one 16 rows a step; the
// score products stay m64n128k16 on 128-row tiles, and O, dQ, dK and dV
// are m64n32k16 / m64n16k16 (wg::WgmmaRS<D, 1>).
// There each CTA's loop is short (at most 4 KV tiles at S 512) and its
// accumulators 8-16 floats a thread, so the prologue and epilogue weigh:
// the ring holds 4 stages, which at S 512 takes every tile in the prologue,
// and the forward is built for two CTAs an SM (fwd_ctas): one CTA's
// prologue and epilogue run under the other's loop, and each tile's
// products run in turn (its note) to fit 128 registers a thread.
constexpr int FWD_BQ = 128;      // forward: query rows per CTA
constexpr int FWD_BKV = 128;     // forward: KV rows per ring stage
constexpr int DKV_BKV = 128;     // dK/dV: KV rows per CTA
constexpr int DQ_BQ = 128;       // dQ: query rows per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Ring depths and dK/dV's query rows per stage, by head dim, as swept on
// an H100 at D 64 and 128 (PERF.md): at D 128 dK and dV alone hold 128
// registers a thread, so dK/dV takes 64 query rows per stage there. At D
// 16 and 32 the 4 stages hold every tile of S 512.
constexpr int FWD_STAGES_D16 = 4;
constexpr int FWD_STAGES_D32 = 4;
constexpr int FWD_STAGES_D64 = 3;
constexpr int FWD_STAGES_D128 = 3;
constexpr int DKV_BQ_D16 = 128;
constexpr int DKV_BQ_D32 = 128;
constexpr int DKV_BQ_D64 = 128;
constexpr int DKV_BQ_D128 = 64;
constexpr int DKV_STAGES_D16 = 4;
constexpr int DKV_STAGES_D32 = 4;
constexpr int DKV_STAGES_D64 = 2;
constexpr int DKV_STAGES_D128 = 2;
// dQ's KV rows per stage, ring depths and CTAs an SM: at D 128 dQ alone
// holds 64 registers a thread, so its KV tile is 64 rows there; at D 16
// and 32, 64-row KV tiles at two CTAs an SM (S and dP of a tile in 128
// registers) ran 2-5% under 128-row ones at one (PERF.md: the two-CTA
// trial).
constexpr int DQ_BKV_D16 = 64;
constexpr int DQ_BKV_D32 = 64;
constexpr int DQ_BKV_D64 = 128;
constexpr int DQ_BKV_D128 = 64;
constexpr int DQ_STAGES_D16 = 4;
constexpr int DQ_STAGES_D32 = 4;
constexpr int DQ_STAGES_D64 = 3;
constexpr int DQ_STAGES_D128 = 3;
constexpr int GROUP_HEADS = 16;  // (batch, head) pairs per group of the CTA order

template <int D>
constexpr int by_d(int d16, int d32, int d64, int d128) {
  return D == 16 ? d16 : D == 32 ? d32 : D == 64 ? d64 : d128;
}
template <int D>
constexpr int fwd_stages() {
  return by_d<D>(FWD_STAGES_D16, FWD_STAGES_D32, FWD_STAGES_D64, FWD_STAGES_D128);
}
// CTAs an SM the forward is built for (__launch_bounds__): two at D 16
// and 32, whose in-turn loop fits the 128 registers a thread that two
// allow; one elsewhere, and for soft_cap, whose tanh spilled at two
// (PERF.md: the two-CTA trial). dK/dV holds S^T and dP^T (128 floats) at
// once and is built for one CTA at every head dim (it spilled at two).
template <int D, int MOD>
constexpr int fwd_ctas() { return D < 64 && MOD != MOD_SOFTCAP ? 2 : 1; }
template <int D>
constexpr int dkv_bq() { return by_d<D>(DKV_BQ_D16, DKV_BQ_D32, DKV_BQ_D64, DKV_BQ_D128); }
template <int D>
constexpr int dkv_stages() {
  return by_d<D>(DKV_STAGES_D16, DKV_STAGES_D32, DKV_STAGES_D64, DKV_STAGES_D128);
}
template <int D>
constexpr int dq_bkv() { return by_d<D>(DQ_BKV_D16, DQ_BKV_D32, DQ_BKV_D64, DQ_BKV_D128); }
template <int D>
constexpr int dq_stages() {
  return by_d<D>(DQ_STAGES_D16, DQ_STAGES_D32, DQ_STAGES_D64, DQ_STAGES_D128);
}
// CTAs an SM dQ is built for: two at D 16 and 32 (S and dP of a 64-row KV
// tile fit the 128 registers two allow: 100-114, no spill), one at D 64
// and 128, and for soft_cap, whose Jacobian spilled the two-CTA forward.
template <int D, int MOD>
constexpr int dq_ctas() { return D < 64 && MOD != MOD_SOFTCAP ? 2 : 1; }

// How a [rows x D] bf16 operand lies in shared memory: boxes of COLS =
// min(D, 64) columns, each box row one swizzle span of RB bytes (128, 64
// or 32), boxes NB = D / COLS; K-major k16 steps per box row KPR; the
// swizzle atom (8 rows) SBO; the descriptors' layout. At D 64 and 128 these
// are the 128-byte constants the kernels were written with.
template <int D>
struct Geo {
  static constexpr int COLS = D < 64 ? D : 64;
  static constexpr int RB = COLS * 2;
  static constexpr int NB = D / COLS;
  static constexpr int KPR = RB / 32;
  static constexpr uint32_t SBO = 8 * RB;
  static constexpr uint32_t LAYOUT =
      RB == 128 ? wg::LAYOUT_B128 : RB == 64 ? wg::LAYOUT_B64 : wg::LAYOUT_B32;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the 4 threads of a quad: one row of an m64 accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Named barriers of the wgmma kernels: 1 both consumer warpgroups,
// 2 + g warpgroup g's epilogue staging, BAR_TURN + g warpgroup g's turn
// at the tensor cores.
constexpr int BAR_TURN = 4;

// The five masks as one branch-free predicate over 32-bit positions (the
// launchers check S < 2^31): allowed(row, col) = (lo <= row - col < win) ||
// col < pre, with (lo, win, pre) = (0, INT_MAX, 0) causal, (0, window, 0)
// sliding_window, (0, INT_MAX, prefix) prefix_lm, (INT_MIN, window, 0)
// band, (INT_MIN, INT_MAX, INT_MAX) full.
struct Mask32 {
  int lo, win, pre;
  __device__ __forceinline__ bool allowed(int row, int col) const {
    const int d = row - col;
    return ((d >= lo) & (d < win)) | (col < pre);
  }
};

__device__ __forceinline__ Mask32 mask32(const FlashArgs& a) {
  const auto sat = [](int64_t x) {
    return static_cast<int>(x > INT32_MAX ? INT32_MAX : x < INT32_MIN ? INT32_MIN : x);
  };
  switch (a.mask_type) {
    case MASK_CAUSAL: return {0, INT32_MAX, 0};
    case MASK_SLIDING: return {0, sat(a.window), 0};
    case MASK_PREFIX: return {0, INT32_MAX, sat(a.prefix)};
    case MASK_BAND: return {INT32_MIN, sat(a.window), 0};
    default: return {INT32_MIN, INT32_MAX, INT32_MAX};
  }
}

// tanh(x) = sign(x) (1 - e) / (1 + e) with e = 2^(-2 log2(e) |x|) from
// ex2.approx (2^-22 relative) and a fast division: within ~5e-7 of tanh in
// absolute terms, branch-free (no branch may sit between a wgmma's issue
// and its wait).
__device__ __forceinline__ float tanh_exp2(float x) {
  const float e = exp2_approx(-2.f * LOG2E * fabsf(x));
  return copysignf(__fdividef(1.f - e, 1.f + e), x);
}

// The wgmma kernels' score mod, a template parameter: the base-2 logit
// x = s log2 e of the modded s, from the product acc = q . k of one score.
//   none:     acc * (scale log2 e), the arithmetic of the kernels before mods;
//   alibi:    fma(acc, scale log2 e, -(slope log2 e) |row - col|);
//   soft_cap: (cap log2 e) t with t = tanh_exp2(acc (scale / cap)), and
//             the Jacobian 1 - t^2 into dmod.
// The lse stays natural: the kernels keep m in base 2 and write m ln 2 + log l.
template <int MOD>
struct ModW {
  float sl2;   // scale log2 e
  float c0;    // alibi: slope log2 e; soft_cap: scale / cap
  float c1;    // soft_cap: cap log2 e
  __device__ __forceinline__ float logit(float acc, int row, int col, float& dmod) const {
    if constexpr (MOD == MOD_ALIBI) {
      const int d = row - col;
      return fmaf(acc, sl2, -c0 * static_cast<float>(d < 0 ? -d : d));
    } else if constexpr (MOD == MOD_SOFTCAP) {
      const float t = tanh_exp2(acc * c0);
      dmod = 1.f - t * t;
      return c1 * t;
    } else {
      return acc * sl2;
    }
  }
};

template <int MOD>
__device__ __forceinline__ ModW<MOD> mod_w(const FlashArgs& a, int h) {
  const float scale = static_cast<float>(a.scale);
  ModW<MOD> m{scale * LOG2E, 0.f, 0.f};
  if constexpr (MOD == MOD_ALIBI) m.c0 = alibi_slope(h, a.score_arg) * LOG2E;
  if constexpr (MOD == MOD_SOFTCAP) {
    m.c0 = scale / static_cast<float>(a.score_arg);
    m.c1 = static_cast<float>(a.score_arg) * LOG2E;
  }
  return m;
}

// The CTA order of the wgmma kernels' 1-D grid: groups of
// GROUP_HEADS (batch, head) pairs, one group after another, so the
// CTAs in flight share their heads' K and V (forward) or Q and dO (dK/dV)
// in L2; inside a group every pair's heaviest tile first (rank 0), so the
// light tiles fill the tail.
__device__ __forceinline__ void cta_tile(int64_t id, int64_t n_bh, int n_tiles, int& bh,
                                         int& rank) {
  const int64_t per = GROUP_HEADS;
  const int64_t first = id / (per * n_tiles) * per;
  const int64_t heads = per < n_bh - first ? per : n_bh - first;
  const int64_t r = id - first * n_tiles;
  rank = static_cast<int>(r / heads);
  bh = static_cast<int>(first + r % heads);
}

// Accumulator element i of a thread's m64 x N tile (wg::Wgmma's layout):
// row 8 * ((i >> 1) & 1) past the thread's first row, column
// 8 * (i >> 2) + (i & 1) past its first column 2 (t % 4).
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + (i & 1); }

// ---------------------------------------------------------------- forward
// A CTA owns FWD_BQ = 128 query rows of one (batch, query head): Q comes in
// once; K and V tiles of FWD_BKV rows flow through the ring. Warpgroup g
// owns rows 64 g .. 64 g + 63. Per KV tile j it issues S_j = Q K_j^T (SS,
// both K-major) and, in the same batch, O += bf16(P_{j-1}) V_{j-1} (RS, V
// MN-major), then runs the softmax of S_j in registers while that product
// is still in flight: mask on tiles not flagged full, row max over the
// quad that holds a row, P_j = 2^(S_j - m) into a second register set (the
// row sum is kept per thread and reduced once at the end); when the
// product has retired, O is rescaled in registers. The two warpgroups take
// turns at the tensor cores (named barriers BAR_TURN + g): one issues its
// products while the other runs its softmax. No producer warp: the ring's
// 9th warp would put 3 warps on one SM sub-partition and cap every thread
// at 168 registers, and the pipeline needs two score tiles' worth. Thread 0
// issues Q and the first STAGES tiles; warpgroup 1, which runs second,
// refills each stage once both warpgroups have released it. The grid is
// 1-D (cta_tile): heads in groups, and in a group the heaviest Q tile
// first (the last Q tile has the most live KV tiles under a causal mask).
template <int D, int STAGES>
constexpr int fwd_wg_smem() {
  return (FWD_BQ + STAGES * 2 * FWD_BKV) * D * 2 + wg::ATOM;
}

template <int D, int STAGES, int CTAS, int MOD>
__global__ void __launch_bounds__(256, CTAS)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const FlashArgs a) {
  using namespace wg;
  using GD = Geo<D>;
  constexpr int NB = GD::NB;               // boxes per row
  constexpr int Q_BOX = FWD_BQ * GD::RB;   // one box of the Q tile
  constexpr int KV_BOX = FWD_BKV * GD::RB; // one box of a K or V tile
  constexpr int KV_BYTES = NB * KV_BOX;
  constexpr int STAGE = 2 * KV_BYTES;    // K, then V
  constexpr int NP = FWD_BKV / 4;        // packed bf16 pairs of a P tile
  static_assert(2 * 64 * (D * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* qs = ring_base(dyn_smem);
  uint8_t* ring = qs + NB * Q_BOX;

  int bh, rank;
  cta_tile(blockIdx.x, a.B * a.Hq, static_cast<int>(a.nq), bh, rank);
  const int qt = static_cast<int>(a.nq) - 1 - rank;
  const int h = bh % static_cast<int>(a.Hq), b = bh / static_cast<int>(a.Hq);
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int lo = a.ranges[2 * qt], n = a.ranges[2 * qt + 1] - lo;
  const int tid = threadIdx.x;
  const auto load = [&](int it) {  // K and V of the iteration-it tile into its stage
    const int s = it % STAGES;
    const uint32_t kb = smem_addr(ring + s * STAGE), vb = kb + KV_BYTES;
    const uint32_t bar = smem_addr(&full[s]);
    const int row = (lo + it) * FWD_BKV;
    mbar_expect_tx(bar, STAGE);
    for (int c = 0; c < NB; ++c)
      tma_4d(kb + c * KV_BOX, &map_k, bar, GD::COLS * c, row, hk, b);
    for (int c = 0; c < NB; ++c)
      tma_4d(vb + c * KV_BOX, &map_v, bar, GD::COLS * c, row, hk, b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(&q_full, 1);
    mbar_init_fence();
    const uint32_t qbar = smem_addr(&q_full);
    mbar_expect_tx(qbar, NB * Q_BOX);
    for (int c = 0; c < NB; ++c)
      tma_4d(smem_addr(qs + c * Q_BOX), &map_q, qbar, GD::COLS * c, qt * FWD_BQ, h, b);
    for (int it = 0; it < n && it < STAGES; ++it) load(it);
  }
  __syncthreads();

  // g through a shuffle: warp-uniform to the compiler, so the descriptors
  // derived from it stay in uniform registers (see the wgmma note)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), t = tid % 128;
  const int S = static_cast<int>(a.S);
  const int row0 = qt * FWD_BQ + 64 * g + 16 * (t / 32) + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
  const ModW<MOD> mw = mod_w<MOD>(a, h);
  const Mask32 mask = mask32(a);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, base 2
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  uint32_t pa[NP];                  // bf16(P) of the previous tile: A of its P V
#pragma unroll
  for (int i = 0; i < NP; ++i) pa[i] = 0u;
  if (g == 1 && n > 0) bar_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  mbar_wait(&q_full, 0);
  const uint32_t qa = smem_addr(qs) + g * 64 * GD::RB;
  // S_j = Q K_j^T for the tile in stage s into sc (one commit group). sc is
  // a fresh array per tile: scores kept across tiles would be live inputs
  // of the next product, moved into place inside the wgmma batch, and ptxas
  // then serializes every wgmma.
  const auto issue_s = [&](float (&sc)[FWD_BKV / 2], int s) {
    const uint32_t kb = smem_addr(ring + s * STAGE);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<FWD_BKV, 0, 0>::run(
          sc, desc(qa + (ks / GD::KPR) * Q_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          desc(kb + (ks / GD::KPR) * KV_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          ks > 0 ? 1 : 0);
    wgmma_commit();
  };
  // O += bf16(P) V for the tile in stage s (one commit group)
  const auto issue_pv = [&](int s) {
    const uint32_t vb = smem_addr(ring + s * STAGE) + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < FWD_BKV / 16; ++kk)
      WgmmaRS<D, 1>::run(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         desc(vb + kk * 16 * GD::RB, KV_BOX, GD::SBO, GD::LAYOUT), 1);
    wgmma_commit();
  };
  // The online softmax of S_j (in sc): mask, new running max, P into pn,
  // the row sums, and alpha = 2^(m_old - m_new) for O.
  const auto softmax = [&](float (&sc)[FWD_BKV / 2], int j, bool full_tile, uint32_t (&pn)[NP],
                           float (&alpha)[2]) {
    const int k0 = j * FWD_BKV + c0;
    float dm;  // the mod's Jacobian: the backward's, unused here
    if (full_tile) {
#pragma unroll
      for (int i = 0; i < FWD_BKV / 2; ++i)
        sc[i] = mw.logit(sc[i], row0 + acc_row(i), k0 + acc_col(i), dm);
    } else {
#pragma unroll
      for (int i = 0; i < FWD_BKV / 2; ++i) {
        const int row = row0 + acc_row(i), col = k0 + acc_col(i);
        const float x = mask.allowed(row, col) ? mw.logit(sc[i], row, col, dm) : NEG_INF;
        sc[i] = (row < S) & (col < S) ? x : -INFINITY;  // past S: never contributes
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < FWD_BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r = i & 1;
      const float p0 = exp2_approx(sc[2 * i] - m[r]);
      const float p1 = exp2_approx(sc[2 * i + 1] - m[r]);
      l[r] += p0 + p1;
      pn[i] = pack_bf16(p0, p1);
    }
  };
  const auto full_flag = [&](int j) {
    return a.full[static_cast<int64_t>(qt) * a.nk + j] != 0;
  };

  if constexpr (CTAS > 1) {
    // Two CTAs an SM cap a thread at 128 registers, which hold one score
    // tile but not the overlap's two (S_j beside P_{j-1}): each tile's S,
    // softmax and P V run in turn, and the SM's other CTA fills the gaps.
    // The turns at the tensor cores are dK/dV's: two a tile.
    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      const bool full_tile = full_flag(lo + it);
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int su = __shfl_sync(0xffffffffu, s, 0);
      bar_sync(BAR_TURN + g, 256);
      float sc[FWD_BKV / 2];
      wgmma_fence();
      issue_s(sc, su);
      bar_arrive(BAR_TURN + 1 - g, 256);
      wgmma_wait<0>();
      fence_acc(sc);
      float alpha[2];
      softmax(sc, lo + it, full_tile, pa, alpha);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      fence_acc(o);
      fence_regs(pa);  // P is in its registers before the wgmma batch opens
      bar_sync(BAR_TURN + g, 256);
      wgmma_fence();
      issue_pv(su);
      if (g == 0 || it + 1 < n) bar_arrive(BAR_TURN + 1 - g, 256);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(pa);  // P V read pa until here
      if (t == 0) mbar_arrive(&empty[s]);
      if (tid == 128 && it + STAGES < n) {  // warpgroup 1 runs second: refill
        mbar_wait(&empty[s], (it / STAGES) & 1);
        load(it + STAGES);
      }
    }
  } else {
    if (n > 0) {  // the first tile: S alone (O is still zero)
      const bool full_tile = full_flag(lo);
      mbar_wait(&full[0], 0);
      bar_sync(BAR_TURN + g, 256);  // this warpgroup's turn at the tensor cores
      float sc[FWD_BKV / 2];
      wgmma_fence();
      issue_s(sc, 0);
      if (g == 0 || n > 1) bar_arrive(BAR_TURN + 1 - g, 256);  // the other's turn
      wgmma_wait<0>();
      fence_acc(sc);
      float alpha[2];
      softmax(sc, lo, full_tile, pa, alpha);
    }
    int s = 0, ph = 0;  // the previous tile's stage and phase
    for (int it = 1; it < n; ++it) {
      // S of this tile and P V of the previous one go out together; the
      // softmax of this tile runs while P V is in flight.
      const int prev = s, prev_ph = ph;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
      const bool full_tile = full_flag(lo + it);
      mbar_wait(&full[s], ph);
      bar_sync(BAR_TURN + g, 256);
      fence_acc(o);
      fence_regs(pa);  // P is in its registers before the wgmma batch opens
      float sc[FWD_BKV / 2];
      // the stages through shuffles: warp-uniform, so the descriptors are
      // built in uniform registers before the batch opens (a descriptor moved
      // into place between wgmmas makes ptxas serialize them all)
      const int su = __shfl_sync(0xffffffffu, s, 0), pu = __shfl_sync(0xffffffffu, prev, 0);
      wgmma_fence();
      issue_s(sc, su);
      issue_pv(pu);
      if (g == 0 || it + 1 < n) bar_arrive(BAR_TURN + 1 - g, 256);
      wgmma_wait<1>();  // S has retired; P V may still run
      fence_acc(sc);
      uint32_t pn[NP];
      float alpha[2];
      softmax(sc, lo + it, full_tile, pn, alpha);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(pa);  // P V read pa until here
      if (t == 0) mbar_arrive(&empty[prev]);
      if (tid == 128 && it - 1 + STAGES < n) {  // warpgroup 1 runs second: refill
        mbar_wait(&empty[prev], prev_ph);
        load(it - 1 + STAGES);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < NP; ++i) pa[i] = pn[i];
    }
    if (n > 0) {  // P V of the last tile (stage s)
      fence_acc(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(s);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(pa);
    }
  }

  float den[2], inv[2];  // max(l, 1e-30) of the thread's two rows, and 1 / it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / den[r];
  }
  uint32_t ov[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i)
    ov[i] = pack_bf16(o[2 * i] * inv[i & 1], o[2 * i + 1] * inv[i & 1]);
  if (t % 4 == 0) {
    float* lse = a.lse_out + (static_cast<int64_t>(b) * a.Hq + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S) lse[row0 + 8 * r] = m[r] * LN2 + logf(den[r]);
  }
  bar_sync(1, 256);  // both warpgroups are past their last wgmma: the ring is idle
  const int tile0 = qt * FWD_BQ + 64 * g;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out0) + b * a.so[0] + h * a.so[1];
  store_tile<D>(ov, ring + g * 64 * (D * 2 + 16), og, a.so[2], tile0,
                S - tile0 < 64 ? S - tile0 : 64, 0, D, t, 2 + g);
}

// ------------------------------------------------------------------ dK/dV
// A CTA owns DKV_BKV = 128 KV rows of one (batch, query head): K and V come
// in once; Q and dO tiles of BQ rows (dkv_bq) flow through the ring by TMA,
// with their rows' lse and delta copied beside them by one warp's cp.async
// (4 bytes a lane: a row of [B, Hq, S] starts at any float, which TMA's
// 16-byte box rule refuses; zeros past S), each lane arriving on the
// stage's full barrier when its copies land. No producer warp: 9 warps put
// 3 on one SM sub-partition, whose 16K registers then cap every thread at
// 168, and dK + dV alone take 128 fp32 registers at D 128. Warp 0 issues
// the first STAGES stages; warp 4 (warpgroup 1, which runs second) refills
// each stage once both warpgroups have released it.
// Warpgroup g owns KV rows 64 g .. 64 g + 63 and works transposed, with the
// KV rows as M: S^T = K Q^T and dP^T = V dO^T (SS, both K-major) land in
// registers; P^T = 2^(S^T scale log2 e - lse log2 e) after the mask (row =
// query, col = key) on tiles not flagged full; dV += bf16(P^T) dO and
// dS^T = P^T (dP^T - delta) scale, dK += bf16(dS^T) Q (RS, dO and Q
// MN-major). dK and dV accumulate in fp32 registers over the live Q tiles
// and are written once: no atomics, bitwise reproducible. KV tile 0 (the
// most live Q tiles under a causal mask) comes first in each head group of
// the 1-D grid (cta_tile).
template <int D, int BQ, int STAGES>
constexpr int dkv_wg_smem() {
  return (2 * DKV_BKV + STAGES * 2 * BQ) * D * 2 + STAGES * 2 * BQ * 4 + wg::ATOM;
}

template <int D, int BQ, int STAGES, int MOD>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const FlashArgs a) {
  using namespace wg;
  using GD = Geo<D>;
  constexpr int NB = GD::NB;
  constexpr int KV_BOX = DKV_BKV * GD::RB;
  constexpr int KV_BYTES = NB * KV_BOX;
  constexpr int Q_BOX = BQ * GD::RB;
  constexpr int Q_BYTES = NB * Q_BOX;
  constexpr int STAGE = 2 * Q_BYTES;  // Q, then dO
  static_assert(2 * 64 * (D * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t kv_full;
  uint8_t* ks = ring_base(dyn_smem);
  uint8_t* vs = ks + KV_BYTES;
  uint8_t* ring = vs + KV_BYTES;
  float* stat = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [STAGES][lse, delta][BQ]

  int bh, kt;
  cta_tile(blockIdx.x, a.B * a.Hq, static_cast<int>(a.nk), bh, kt);
  const int h = bh % static_cast<int>(a.Hq), b = bh / static_cast<int>(a.Hq);
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int lo = a.ranges[2 * kt], n = a.ranges[2 * kt + 1] - lo;
  const int64_t S = a.S;
  const float* lse_g = a.lse_in + (static_cast<int64_t>(b) * a.Hq + h) * S;
  const float* delta_g = a.delta + (static_cast<int64_t>(b) * a.Hq + h) * S;
  const int tid = threadIdx.x, lane = tid % 32;
  // one warp: Q and dO (lane 0, TMA), lse and delta (every lane, cp.async)
  // of the iteration-it Q tile into its stage; 33 arrivals complete it
  const auto load = [&](int it) {
    const int s = it % STAGES, q0 = (lo + it) * BQ;
    for (int r = lane; r < BQ; r += 32) {
      const bool in = q0 + r < S;
      const int64_t src = in ? q0 + r : 0;
      cp_async_4(smem_addr(stat + (2 * s) * BQ + r), lse_g + src, in ? 4 : 0);
      cp_async_4(smem_addr(stat + (2 * s + 1) * BQ + r), delta_g + src, in ? 4 : 0);
    }
    cp_async_arrive(&full[s]);
    if (lane == 0) {
      const uint32_t qb = smem_addr(ring + s * STAGE), dob = qb + Q_BYTES;
      const uint32_t bar = smem_addr(&full[s]);
      mbar_expect_tx(bar, STAGE);
      for (int c = 0; c < NB; ++c)
        tma_4d(qb + c * Q_BOX, &map_q, bar, GD::COLS * c, q0, h, b);
      for (int c = 0; c < NB; ++c)
        tma_4d(dob + c * Q_BOX, &map_do, bar, GD::COLS * c, q0, h, b);
    }
  };
  if (tid < 32) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 33);
        mbar_init(&empty[s], 2);
      }
      mbar_init(&kv_full, 1);
      mbar_init_fence();
      const uint32_t bar = smem_addr(&kv_full);
      mbar_expect_tx(bar, 2 * KV_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_4d(smem_addr(ks + c * KV_BOX), &map_k, bar, GD::COLS * c, kt * DKV_BKV, hk, b);
      for (int c = 0; c < NB; ++c)
        tma_4d(smem_addr(vs + c * KV_BOX), &map_v, bar, GD::COLS * c, kt * DKV_BKV, hk, b);
    }
    __syncwarp();
    for (int it = 0; it < n && it < STAGES; ++it) load(it);
  }
  __syncthreads();

  // g through a shuffle: warp-uniform to the compiler, so the descriptors
  // derived from it stay in uniform registers (see the wgmma note)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), t = tid % 128;
  const int kv0 = kt * DKV_BKV + 64 * g + 16 * (t / 32) + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
  const float scale = static_cast<float>(a.scale);
  const ModW<MOD> mw = mod_w<MOD>(a, h);
  const Mask32 mask = mask32(a);
  const int S32 = static_cast<int>(S);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (g == 1 && n > 0) bar_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  mbar_wait(&kv_full, 0);
  const uint32_t ka = smem_addr(ks) + g * 64 * GD::RB, va = smem_addr(vs) + g * 64 * GD::RB;
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES, j = lo + it;
    const bool full_tile = a.full[static_cast<int64_t>(j) * a.nk + kt] != 0;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t qb = smem_addr(ring + s * STAGE), dob = qb + Q_BYTES;
    float st[BQ / 2], dpt[BQ / 2];
    bar_sync(BAR_TURN + g, 256);  // turns at the tensor cores: the two warpgroups
    wgmma_fence();                // alternate, one's elementwise under the other's products
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, 0, 0>::run(
          st, desc(ka + (kk / GD::KPR) * KV_BOX + (kk % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          desc(qb + (kk / GD::KPR) * Q_BOX + (kk % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          kk > 0 ? 1 : 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, 0, 0>::run(
          dpt, desc(va + (kk / GD::KPR) * KV_BOX + (kk % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          desc(dob + (kk / GD::KPR) * Q_BOX + (kk % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          kk > 0 ? 1 : 0);
    wgmma_commit();
    bar_arrive(BAR_TURN + 1 - g, 256);
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    const float* lse = stat + (2 * s) * BQ;
    const float* delta = stat + (2 * s + 1) * BQ;
    const int q0 = j * BQ + c0;
    uint32_t pa[BQ / 4], da[BQ / 4];  // bf16(P^T), bf16(dS^T): A operands
    if constexpr (MOD == MOD_SOFTCAP) {
      // In place, so no register holds a tanh or a Jacobian beside them:
      // S^T becomes the logit, dP^T becomes (dP^T - delta) (1 - t^2). (At
      // D 64 the Jacobians kept beside S^T and dP^T spilled.)
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        float dm;
        st[i] = mw.logit(st[i], 0, 0, dm);
        dpt[i] = (dpt[i] - delta[c0 + acc_col(i)]) * dm;
      }
    }
    // P^T and dS^T of element idx; masked: the mask and S's bounds apply
    const auto pds = [&](int idx, bool masked, float& p, float& ds) {
      const int col = c0 + acc_col(idx);
      const int q = q0 + acc_col(idx), kv = kv0 + acc_row(idx);
      float x = st[idx];  // soft_cap: the logit already
      if constexpr (MOD != MOD_SOFTCAP) {
        float dm;
        x = mw.logit(x, q, kv, dm);
      }
      bool live = true;
      if (masked) {
        x = mask.allowed(q, kv) ? x : NEG_INF;
        live = (q < S32) & (kv < S32);  // outside the sequence: p = 0
      }
      p = exp2_approx(x - lse[col] * LOG2E);  // finite: lse is 0 past S
      p = live ? p : 0.f;
      if constexpr (MOD == MOD_SOFTCAP)
        ds = p * dpt[idx] * scale;  // dP^T already holds (dP^T - delta) (1 - t^2)
      else
        ds = p * (dpt[idx] - delta[col]) * scale;
    };
    if (full_tile) {  // one test per tile, not per element
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) {
        float p0, p1, ds0, ds1;
        pds(2 * i, false, p0, ds0);
        pds(2 * i + 1, false, p1, ds1);
        pa[i] = pack_bf16(p0, p1);
        da[i] = pack_bf16(ds0, ds1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) {
        float p0, p1, ds0, ds1;
        pds(2 * i, true, p0, ds0);
        pds(2 * i + 1, true, p1, ds1);
        pa[i] = pack_bf16(p0, p1);
        da[i] = pack_bf16(ds0, ds1);
      }
    }

    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pa);  // P and dS are in their registers before the batch opens
    fence_regs(da);
    bar_sync(BAR_TURN + g, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::run(dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         desc(dob + kk * 16 * GD::RB, Q_BOX, GD::SBO, GD::LAYOUT), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::run(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                         desc(qb + kk * 16 * GD::RB, Q_BOX, GD::SBO, GD::LAYOUT), 1);
    wgmma_commit();
    if (g == 0 || it + 1 < n) bar_arrive(BAR_TURN + 1 - g, 256);
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pa);  // the products read pa and da until here
    fence_regs(da);
    if (t == 0) mbar_arrive(&empty[s]);
    if (tid / 32 == 4 && it + STAGES < n) {  // warpgroup 1 runs second: refill
      mbar_wait(&empty[s], (it / STAGES) & 1);
      load(it + STAGES);
    }
  }

  uint32_t kv_out[D / 4];
  bar_sync(1, 256);  // both warpgroups are past their last wgmma: the ring is idle
  const int64_t tile0 = static_cast<int64_t>(kt) * DKV_BKV + 64 * g;
  const int rows = static_cast<int>(S - tile0 < 64 ? S - tile0 : 64);
  uint8_t* stage = ring + g * 64 * (D * 2 + 16);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) kv_out[i] = pack_bf16(dk[2 * i], dk[2 * i + 1]);
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  store_tile<D>(kv_out, stage, dkg, a.s0[2], tile0, rows, 0, D, t, 2 + g);
  bar_sync(2 + g, 128);  // the warpgroup has read dK out of the staging
#pragma unroll
  for (int i = 0; i < D / 4; ++i) kv_out[i] = pack_bf16(dv[2 * i], dv[2 * i + 1]);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.out1) + b * a.s1[0] + h * a.s1[1];
  store_tile<D>(kv_out, stage, dvg, a.s1[2], tile0, rows, 0, D, t, 2 + g);
}

// --------------------------------------------------------------------- dQ
// A CTA owns DQ_BQ = 128 query rows of one (batch, query head), as the
// forward does: Q and dO come in once by TMA, and each thread reads its two
// rows' lse and delta from global memory into registers once (no per-tile
// box at an unaligned row start). K and V tiles of BKV rows (dq_bkv) flow
// through the ring. Warpgroup g owns rows 64 g .. 64 g + 63. Per KV tile j,
// in the accumulator layout and never leaving registers:
//   S = Q K_j^T and dP = dO V_j^T (SS, both K-major) in one batch;
//   P = 2^(S scale log2 e - lse log2 e), the mask a branch-free predicate
//   on tiles not flagged full (rows or columns past S give P = 0);
//   dS = P (dP - delta) scale, rounded to bf16 pair by pair: the A operand
//   of dQ += dS K_j (RS, K read MN-major, as the forward reads V).
// dQ accumulates in fp32 registers over the live KV tiles and is written
// once: no atomics, bitwise reproducible. The warpgroups take turns at the
// tensor cores and warpgroup 1 refills the ring, as in dK/dV; the CTA order
// is the forward's (cta_tile: heaviest Q tile first). At D 128, dQ alone
// holds 64 registers a thread, so the KV tile is 64 rows there. At D 16 and
// 32 (boxes one row of D wide, Geo) the accumulator is 8 or 16 floats and
// dQ += dS K an m64n16k16 / m64n32k16 RS product, as the forward's P V.
template <int D, int BKV, int STAGES>
constexpr int dq_wg_smem() {
  return (2 * DQ_BQ + STAGES * 2 * BKV) * D * 2 + wg::ATOM;
}

template <int D, int BKV, int STAGES, int CTAS, int MOD>
__global__ void __launch_bounds__(256, CTAS)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const FlashArgs a) {
  using namespace wg;
  using GD = Geo<D>;
  constexpr int NB = GD::NB;
  constexpr int Q_BOX = DQ_BQ * GD::RB;
  constexpr int Q_BYTES = NB * Q_BOX;
  constexpr int KV_BOX = BKV * GD::RB;
  constexpr int KV_BYTES = NB * KV_BOX;
  constexpr int STAGE = 2 * KV_BYTES;  // K, then V
  static_assert(2 * 64 * (D * 2 + 16) <= STAGES * STAGE, "epilogue staging fits the ring");
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* qs = ring_base(dyn_smem);
  uint8_t* dos = qs + Q_BYTES;
  uint8_t* ring = dos + Q_BYTES;

  int bh, rank;
  cta_tile(blockIdx.x, a.B * a.Hq, static_cast<int>(a.nq), bh, rank);
  const int qt = static_cast<int>(a.nq) - 1 - rank;
  const int h = bh % static_cast<int>(a.Hq), b = bh / static_cast<int>(a.Hq);
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int lo = a.ranges[2 * qt], n = a.ranges[2 * qt + 1] - lo;
  const int tid = threadIdx.x;
  const auto load = [&](int it) {  // K and V of the iteration-it tile into its stage
    const int s = it % STAGES;
    const uint32_t kb = smem_addr(ring + s * STAGE), vb = kb + KV_BYTES;
    const uint32_t bar = smem_addr(&full[s]);
    const int row = (lo + it) * BKV;
    mbar_expect_tx(bar, STAGE);
    for (int c = 0; c < NB; ++c)
      tma_4d(kb + c * KV_BOX, &map_k, bar, GD::COLS * c, row, hk, b);
    for (int c = 0; c < NB; ++c)
      tma_4d(vb + c * KV_BOX, &map_v, bar, GD::COLS * c, row, hk, b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(&q_full, 1);
    mbar_init_fence();
    const uint32_t qbar = smem_addr(&q_full);
    mbar_expect_tx(qbar, 2 * Q_BYTES);
    for (int c = 0; c < NB; ++c)
      tma_4d(smem_addr(qs + c * Q_BOX), &map_q, qbar, GD::COLS * c, qt * DQ_BQ, h, b);
    for (int c = 0; c < NB; ++c)
      tma_4d(smem_addr(dos + c * Q_BOX), &map_do, qbar, GD::COLS * c, qt * DQ_BQ, h, b);
    for (int it = 0; it < n && it < STAGES; ++it) load(it);
  }
  __syncthreads();

  // g through a shuffle: warp-uniform to the compiler, so the descriptors
  // derived from it stay in uniform registers (see the wgmma note)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), t = tid % 128;
  const int S = static_cast<int>(a.S);
  const int row0 = qt * DQ_BQ + 64 * g + 16 * (t / 32) + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
  const float scale = static_cast<float>(a.scale);
  const ModW<MOD> mw = mod_w<MOD>(a, h);
  const Mask32 mask = mask32(a);
  float lse2[2], dlt[2];  // the thread's two rows: lse log2 e and delta (0 past S)
  const int64_t stat0 = (static_cast<int64_t>(b) * a.Hq + h) * a.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < S ? a.lse_in[stat0 + row] * LOG2E : 0.f;
    dlt[r] = row < S ? a.delta[stat0 + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (g == 1 && n > 0) bar_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  mbar_wait(&q_full, 0);
  const uint32_t qa = smem_addr(qs) + g * 64 * GD::RB, doa = smem_addr(dos) + g * 64 * GD::RB;
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES, j = lo + it;
    const bool full_tile = a.full[static_cast<int64_t>(qt) * a.nk + j] != 0;
    mbar_wait(&full[s], (it / STAGES) & 1);
    // the stage through a shuffle: the descriptors stay in uniform registers
    const int su = __shfl_sync(0xffffffffu, s, 0);
    const uint32_t kb = smem_addr(ring + su * STAGE), vb = kb + KV_BYTES;
    float st[BKV / 2], dpt[BKV / 2];
    bar_sync(BAR_TURN + g, 256);  // turns at the tensor cores: the two warpgroups
    wgmma_fence();                // alternate, one's elementwise under the other's products
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<BKV, 0, 0>::run(
          st, desc(qa + (ks / GD::KPR) * Q_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          desc(kb + (ks / GD::KPR) * KV_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          ks > 0 ? 1 : 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<BKV, 0, 0>::run(
          dpt, desc(doa + (ks / GD::KPR) * Q_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          desc(vb + (ks / GD::KPR) * KV_BOX + (ks % GD::KPR) * 32, 16, GD::SBO, GD::LAYOUT),
          ks > 0 ? 1 : 0);
    wgmma_commit();
    bar_arrive(BAR_TURN + 1 - g, 256);
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);

    const int k0 = j * BKV + c0;
    uint32_t da[BKV / 4];  // bf16(dS): the A operand of dS K
    // dS of element idx; masked: the mask and S's bounds apply
    const auto ds = [&](int idx, bool masked) {
      const int r = (idx >> 1) & 1;
      const int row = row0 + acc_row(idx), col = k0 + acc_col(idx);
      float dm = 1.f;
      float x = mw.logit(st[idx], row, col, dm);
      bool live = true;
      if (masked) {
        x = mask.allowed(row, col) ? x : NEG_INF;
        live = (row < S) & (col < S);  // outside the sequence: p = 0
      }
      float p = exp2_approx(x - lse2[r]);
      p = live ? p : 0.f;
      float d = p * (dpt[idx] - dlt[r]);
      if constexpr (MOD == MOD_SOFTCAP) d *= dm;
      return d * scale;
    };
    if (full_tile) {  // one test per tile, not per element
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) da[i] = pack_bf16(ds(2 * i, false), ds(2 * i + 1, false));
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) da[i] = pack_bf16(ds(2 * i, true), ds(2 * i + 1, true));
    }

    fence_acc(dq);
    fence_regs(da);  // dS is in its registers before the batch opens
    bar_sync(BAR_TURN + g, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      WgmmaRS<D, 1>::run(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                         desc(kb + kk * 16 * GD::RB, KV_BOX, GD::SBO, GD::LAYOUT), 1);
    wgmma_commit();
    if (g == 0 || it + 1 < n) bar_arrive(BAR_TURN + 1 - g, 256);
    wgmma_wait<0>();
    fence_acc(dq);
    fence_regs(da);  // the product read da until here
    if (t == 0) mbar_arrive(&empty[s]);
    if (tid == 128 && it + STAGES < n) {  // warpgroup 1 runs second: refill
      mbar_wait(&empty[s], (it / STAGES) & 1);
      load(it + STAGES);
    }
  }

  uint32_t out[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) out[i] = pack_bf16(dq[2 * i], dq[2 * i + 1]);
  bar_sync(1, 256);  // both warpgroups are past their last wgmma: the ring is idle
  const int tile0 = qt * DQ_BQ + 64 * g;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  store_tile<D>(out, ring + g * 64 * (D * 2 + 16), dqg, a.s0[2], tile0,
                S - tile0 < 64 ? S - tile0 : 64, 0, D, t, 2 + g);
}

// ========================================= fp32 forward: 3xTF32 mma.sync
// flash_fwd_f32_kernel ("f32"): the fp32 forward. A CTA of F32_BQ / 16
// warps owns F32_BQ query rows of one (batch, query head), 16 a warp; Q
// comes in once and K and V tiles of BKV rows (F32_BKV_D*) flow through a
// double-buffered ring of 16-byte cp.async copies (zeros past S), so the
// next tile's loads are in flight while a tile's products run. Everything
// else stays in registers: per KV tile, in mma.sync's accumulator layout
// (lane g = lane / 4, t = lane % 4 holds rows g and g + 8 of its warp,
// columns 2t and 2t + 1 of every n8 tile):
//   S = Q K^T;
//   the score mod, the mask on tiles not flagged full, the row max over
//   the quad that holds a row, P = exp(S - m) and alpha = exp(m_old - m)
//   (expf and logf, not ex2.approx: fp32's limit is 1e-5 x RMS);
//   O = alpha O + P V.
// The row sums are kept per thread and reduced over the quad once, at the
// end: o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// Products: mma.sync.m16n8k8 in 3xTF32 (wg::split_tf32 / mma_tf32, as
// gmm_f32_tf32x3_kernel): each operand element is split into hi + lo tf32
// as it leaves shared memory, and each product is lo.hi + hi.lo + hi.hi
// with fp32 accumulators (the dropped lo.lo is ~2^-22 of it). The tensor
// cores truncate as they accumulate, so each k-step's three products are
// summed from zero and added into S or O with a rounded fp32 add (mma3):
// with S summed in the mma accumulator over D / 8 k-steps (48 mma adds at
// D 128) the output missed fp32's 1e-5 x RMS limit by 11%. wgmma is not
// the tool here: tf32 wgmma takes B only K-major, and V in P V is
// MN-major.
// P needs no data movement to become the A operand of P V: the k order
// inside an m16n8k8 step is free as long as A and B agree, so step kk
// pairs logical k t and t + 4 with keys kk 8 + 2t and kk 8 + 2t + 1, which
// is where the accumulator already holds them, and the V fragment reads
// those two rows. S = Q K^T takes the same pairing over D, so each lane
// reads its Q and K fragments as float2 (rows padded by 8 floats: every
// 8-byte read conflict-free); V is read as scalars at rows 2t and 2t + 1
// (rows padded by 4 floats: conflict-free).
// The score mod is a template parameter and a tile flagged full takes one
// test, not one per score, on 32-bit positions (Mask32): with a runtime
// switch and 64-bit per-score tests, a timing-only copy without the
// softmax ran 46% faster at D 64, and this form cut the kernel's time
// there by 45%.
// What bounds it on an H100 (fp32 accuracy at 495 / 3 TFLOP/s from the
// tensor cores; 3.35 TB/s): at B 2, H 8, S 1024, D 128, causal, 4.3 GFLOP
// (0.026 ms) against 34 MB (0.010 ms): operations. It runs at 8-9x that
// (PERF.md), latency-bound at 8 warps an SM: timing-only copies without
// two of the three TF32 passes ran 25-36% faster, without P V 10-22%; at D
// 128, O (64 floats a thread) and the hoisted fragments fill 255
// registers and spill. The grid runs the heaviest Q tile of a causal mask
// first.
constexpr int F32_BQ = 64;  // query rows per CTA (16 per warp: 4 warps)
// KV rows per ring stage, by head dim, as timed on an H100 (PERF.md): at D
// 128 a 64-row stage pair holds 132 KB and keeps one CTA on an SM (2x
// slower than 32 rows); 32 rows at D 64, with three or four CTAs an SM
// forced by __launch_bounds__, spilled and ran 5-30% slower than 64.
constexpr int F32_BKV_D16 = 64;
constexpr int F32_BKV_D32 = 64;
constexpr int F32_BKV_D64 = 64;
constexpr int F32_BKV_D128 = 32;

template <int D>
struct F32Fwd {
  static constexpr int BKV = by_d<D>(F32_BKV_D16, F32_BKV_D32, F32_BKV_D64, F32_BKV_D128);
  static constexpr int NTH = 2 * F32_BQ;  // a warp per 16 rows
  static constexpr int LDQ = D + 8;       // Q and K rows: float2 reads
  static constexpr int LDV = D + 4;       // V rows: scalar reads at rows 2t, 2t + 1
  static constexpr int Q_EL = F32_BQ * LDQ;
  static constexpr int K_EL = BKV * LDQ;
  static constexpr int STAGE = K_EL + BKV * LDV;
  static constexpr int BYTES = (Q_EL + 2 * STAGE) * 4;
};

// The fp32 forward's score mod, a template parameter (the softmax loop
// then holds no branch on it): s = scale q . k through the mod, in natural
// units, with f32_mod's arithmetic (tanhf for soft_cap).
template <int MOD>
struct ModF {
  float scale, slope, cap;
  __device__ __forceinline__ float operator()(float acc, int row, int col) const {
    const float s = acc * scale;
    if constexpr (MOD == MOD_ALIBI) {
      const int d = row - col;
      return s - slope * static_cast<float>(d < 0 ? -d : d);
    } else if constexpr (MOD == MOD_SOFTCAP) {
      return cap * tanhf(s / cap);
    } else {
      return s;
    }
  }
};

// acc += a . b for one m16n8k8 step in 3xTF32: the three products summed
// from zero in the mma accumulator, then added into acc rounded.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  wg::mma_tf32(d, al, bh);  // the small terms first
  wg::mma_tf32(d, ah, bl);
  wg::mma_tf32(d, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Built for one CTA an SM (__launch_bounds__ minimum 1): ptxas then keeps
// the fragments it hoists in up to 255 registers. Without the minimum it
// aimed at more CTAs an SM (105-184 registers) and ran 1.3x slower.
template <int D, int MOD>
__global__ void __launch_bounds__(F32Fwd<D>::NTH, 1)
flash_fwd_f32_kernel(const FlashArgs a) {
  using L = F32Fwd<D>;
  using wg::split_tf32;
  constexpr int BKV = L::BKV;
  constexpr int NT = BKV / 8;  // n8 tiles of a warp's scores
  constexpr int ON = D / 8;    // n8 tiles of O
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ring = qs + L::Q_EL;

  const int qt = static_cast<int>(a.nq) - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int S = static_cast<int>(a.S), q0 = qt * F32_BQ;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const ModF<MOD> mod{static_cast<float>(a.scale),
                      MOD == MOD_ALIBI ? alibi_slope(h, a.score_arg) : 0.f,
                      static_cast<float>(a.score_arg)};
  const Mask32 mask = mask32(a);

  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  // rows [row0, row0 + rows) of an [S, D] slab into shared memory, 16 bytes
  // a copy; rows past S are zero
  const auto load_rows = [&](float* dst, int ld, const float* src, int64_t stride,
                             int64_t row0, int rows) {
    for (int i = tid; i < rows * (D / 4); i += L::NTH) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool in = row0 + r < S;
      wg::cp_async<16>(dst + r * ld + c, in ? src + (row0 + r) * stride + c : src, in);
    }
  };
  const int lo = a.ranges[2 * qt], n = a.ranges[2 * qt + 1] - lo;
  const auto load_kv = [&](int it) {  // K and V of the iteration-it tile into its stage
    float* ks = ring + (it & 1) * L::STAGE;
    const int64_t k0 = static_cast<int64_t>(lo + it) * BKV;
    load_rows(ks, L::LDQ, kg, a.sk[2], k0, BKV);
    load_rows(ks + L::K_EL, L::LDV, vg, a.sv[2], k0, BKV);
  };
  load_rows(qs, L::LDQ, qg, a.sq[2], q0, F32_BQ);
  if (n > 0) load_kv(0);
  wg::cp_async_commit();

  const float* qw = qs + (16 * warp + g) * L::LDQ + 2 * t;  // rows g, g + 8 of the warp
  const int row_a = q0 + 16 * warp + g;                      // and their positions
  float o[ON][4];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of the running sums
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_kv(it + 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile's copies (this thread's) have landed
    __syncthreads();         // ... everyone's
    const float* ks = ring + (it & 1) * L::STAGE;
    const float* vs = ks + L::K_EL;
    const int j = lo + it;

    // S = Q K^T: step kk pairs logical k t, t + 4 with columns 8 kk + 2t,
    // 8 kk + 2t + 1 of Q and K alike (two steps unrolled at a time: fully
    // unrolled, the hoisted fragments spilled more and ran 2-4% slower)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qw + kk * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(qw + 8 * L::LDQ + kk * 8);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 y = *reinterpret_cast<const float2*>(ks + (nt * 8 + g) * L::LDQ + kk * 8 +
                                                          2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        mma3(s[nt], ah, al, bh, bl);
      }
    }

    // the online softmax of S, in place: P. A tile flagged full takes no
    // mask and lies inside S (one test a tile, not an element).
    const int k0 = j * BKV + 2 * t;
    float mx[2] = {m[0], m[1]};
    if (a.full[static_cast<int64_t>(qt) * a.nk + j] != 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = mod(s[nt][e], row_a + 8 * (e >> 1), k0 + nt * 8 + (e & 1));
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1), col = k0 + nt * 8 + (e & 1);
          const float x = mask.allowed(row, col) ? mod(s[nt][e], row, col) : NEG_INF;
          s[nt][e] = (row < S) & (col < S) ? x : -INFINITY;  // past S: never contributes
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }

    // O = alpha O + P V: step kk of P V pairs logical k t, t + 4 with keys
    // 8 kk + 2t, 8 kk + 2t + 1, where S's accumulator holds them
#pragma unroll
    for (int on = 0; on < ON; ++on)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[on][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      const float* vk = vs + (kk * 8 + 2 * t) * L::LDV + g;
#pragma unroll
      for (int on = 0; on < ON; ++on) {
        uint32_t bh[2], bl[2];
        split_tf32(vk[on * 8], bh[0], bl[0]);
        split_tf32(vk[on * 8 + L::LDV], bh[1], bl[1]);
        mma3(o[on], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with this stage: the next load may refill it
  }
  wg::cp_async_wait<0>();

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) den[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  float* og_ = static_cast<float*>(a.out0) + b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* dst = og_ + row * a.so[2] + 2 * t;
#pragma unroll
    for (int on = 0; on < ON; ++on)
      *reinterpret_cast<float2*>(dst + on * 8) =
          make_float2(o[on][2 * r] / den[r], o[on][2 * r + 1] / den[r]);
    if (t == 0) a.lse_out[(static_cast<int64_t>(b) * a.Hq + h) * S + row] = m[r] + logf(den[r]);
  }
}

// ------------------------------------------------------------------ launchers
enum Which { FWD = 0, DQ = 1, DKV = 2 };

// ------------------------------------------------ host side of the wgmma path
int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

// A 4-D tensor map over one [B, H, S, D] bf16 operand read through its
// element strides st = (b, h, s) with a contiguous D: dims (D, S, H, B),
// boxes of min(D, 64) columns x `rows` rows, a box row one swizzle span
// (Geo: 128 bytes at D 64 and 128, 64 at D 32, 32 at D 16).
int bhsd_map(CUtensorMap* map, const void* base, const int64_t* st, int64_t B, int64_t H,
             int64_t S, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const int cols = D < 64 ? D : 64;
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1,
                             1};
  return wg::bf16_map_strided(map, base, 4, dims, strides, box, swizzle);
}

// TMA's and the epilogue's rules (the wrapper checks them too): 16-byte
// aligned bases and (b, h, s) strides of every operand the kernel reads or
// writes.
bool tma_ok(const FlashArgs* a, Which which) {
  const auto ok = [](const void* p, const int64_t* st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
           st[2] % 8 == 0;
  };
  if (!ok(a->q, a->sq) || !ok(a->k, a->sk) || !ok(a->v, a->sv) || !ok(a->out0, a->s0))
    return false;
  return which == FWD || (ok(a->dout, a->sdo) && (which == DQ || ok(a->out1, a->s1)));
}

template <int D, int MOD>
int launch_fwd_wgmma(const FlashArgs* a, cudaStream_t stream) {
  constexpr int STAGES = fwd_stages<D>();
  if (a->nq != cdiv(a->S, FWD_BQ) || a->nk != cdiv(a->S, FWD_BKV) || a->S >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // a plan at other tile sizes
  CUtensorMap mq, mk, mv;
  int err = bhsd_map(&mq, a->q, a->sq, a->B, a->Hq, a->S, D, FWD_BQ);
  if (err == 0) err = bhsd_map(&mk, a->k, a->sk, a->B, a->Hkv, a->S, D, FWD_BKV);
  if (err == 0) err = bhsd_map(&mv, a->v, a->sv, a->B, a->Hkv, a->S, D, FWD_BKV);
  if (err != 0) return err;
  const auto kernel = flash_fwd_bf16_wgmma_kernel<D, STAGES, fwd_ctas<D, MOD>(), MOD>;
  constexpr int smem = fwd_wg_smem<D, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nq * a->B * a->Hq), 256, smem, stream>>>(mq, mk, mv, *a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MOD>
int launch_dkv_wgmma(const FlashArgs* a, cudaStream_t stream) {
  constexpr int BQ = dkv_bq<D>(), STAGES = dkv_stages<D>();
  if (a->nq != cdiv(a->S, BQ) || a->nk != cdiv(a->S, DKV_BKV) || a->S >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  int err = bhsd_map(&mq, a->q, a->sq, a->B, a->Hq, a->S, D, BQ);
  if (err == 0) err = bhsd_map(&mdo, a->dout, a->sdo, a->B, a->Hq, a->S, D, BQ);
  if (err == 0) err = bhsd_map(&mk, a->k, a->sk, a->B, a->Hkv, a->S, D, DKV_BKV);
  if (err == 0) err = bhsd_map(&mv, a->v, a->sv, a->B, a->Hkv, a->S, D, DKV_BKV);
  if (err != 0) return err;
  const auto kernel = flash_bwd_dkv_bf16_wgmma_kernel<D, BQ, STAGES, MOD>;
  constexpr int smem = dkv_wg_smem<D, BQ, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nk * a->B * a->Hq), 256, smem, stream>>>(
      mq, mk, mv, mdo, *a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MOD>
int launch_dq_wgmma(const FlashArgs* a, cudaStream_t stream) {
  constexpr int BKV = dq_bkv<D>(), STAGES = dq_stages<D>();
  if (a->nq != cdiv(a->S, DQ_BQ) || a->nk != cdiv(a->S, BKV) || a->S >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // a plan at other tile sizes
  CUtensorMap mq, mk, mv, mdo;
  int err = bhsd_map(&mq, a->q, a->sq, a->B, a->Hq, a->S, D, DQ_BQ);
  if (err == 0) err = bhsd_map(&mdo, a->dout, a->sdo, a->B, a->Hq, a->S, D, DQ_BQ);
  if (err == 0) err = bhsd_map(&mk, a->k, a->sk, a->B, a->Hkv, a->S, D, BKV);
  if (err == 0) err = bhsd_map(&mv, a->v, a->sv, a->B, a->Hkv, a->S, D, BKV);
  if (err != 0) return err;
  const auto kernel = flash_bwd_dq_bf16_wgmma_kernel<D, BKV, STAGES, dq_ctas<D, MOD>(), MOD>;
  constexpr int smem = dq_wg_smem<D, BKV, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nq * a->B * a->Hq), 256, smem, stream>>>(
      mq, mk, mv, mdo, *a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MOD>
int launch_fwd_f32(const FlashArgs* a, cudaStream_t stream) {
  using L = F32Fwd<D>;
  if (a->nq != cdiv(a->S, F32_BQ) || a->nk != cdiv(a->S, L::BKV) || a->S >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // a plan at other tile sizes
  const auto kernel = flash_fwd_f32_kernel<D, MOD>;
  static std::atomic<unsigned long long> ready{0};
  const int err = wg::allow_smem(ready, kernel, L::BYTES);
  if (err != 0) return err;
  kernel<<<dim3(static_cast<unsigned>(a->nq), static_cast<unsigned>(a->Hq),
                static_cast<unsigned>(a->B)),
           L::NTH, L::BYTES, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 dQ and dK/dV: one 32-row SIMT CTA per tile, grid (tiles, Hq, B).
template <int D, Which W>
int launch_simt(const FlashArgs* a, cudaStream_t stream) {
  const dim3 grid((unsigned)(W == DKV ? a->nk : a->nq), (unsigned)a->Hq, (unsigned)a->B);
  void (*kernel)(const FlashArgs);
  size_t bytes;
  if constexpr (W == DQ) {
    kernel = flash_bwd_dq_kernel<D, 32>;
    bytes = dq_smem<D, 32>();
  } else {
    kernel = flash_bwd_dkv_kernel<D, 32>;
    bytes = dkv_smem<D, 32>();
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

// fp32: the 3xTF32 forward; dQ and dK/dV on the 32-row SIMT tiles.
template <int D>
int launch_f32(const FlashArgs* a, Which which, cudaStream_t s) {
  if (which == FWD) {
    if (a->score_mod == MOD_ALIBI) return launch_fwd_f32<D, MOD_ALIBI>(a, s);
    if (a->score_mod == MOD_SOFTCAP) return launch_fwd_f32<D, MOD_SOFTCAP>(a, s);
    return launch_fwd_f32<D, MOD_NONE>(a, s);
  }
  if (a->nq != cdiv(a->S, 32) || a->nk != cdiv(a->S, 32))
    return static_cast<int>(cudaErrorInvalidValue);  // a plan at other tile sizes
  return which == DQ ? launch_simt<D, DQ>(a, s) : launch_simt<D, DKV>(a, s);
}

template <int MOD>
int launch_wgmma(const FlashArgs* a, Which which, int d, cudaStream_t s) {
  if (which == DQ) {
    switch (d) {
      case 16: return launch_dq_wgmma<16, MOD>(a, s);
      case 32: return launch_dq_wgmma<32, MOD>(a, s);
      case 64: return launch_dq_wgmma<64, MOD>(a, s);
      default: return launch_dq_wgmma<128, MOD>(a, s);
    }
  }
  if (which == FWD) {
    switch (d) {
      case 16: return launch_fwd_wgmma<16, MOD>(a, s);
      case 32: return launch_fwd_wgmma<32, MOD>(a, s);
      case 64: return launch_fwd_wgmma<64, MOD>(a, s);
      default: return launch_fwd_wgmma<128, MOD>(a, s);
    }
  }
  switch (d) {
    case 16: return launch_dkv_wgmma<16, MOD>(a, s);
    case 32: return launch_dkv_wgmma<32, MOD>(a, s);
    case 64: return launch_dkv_wgmma<64, MOD>(a, s);
    default: return launch_dkv_wgmma<128, MOD>(a, s);
  }
}

// Kernel variants (the wrapper's flash_variant codes): 0 = "f32" (fp32 at
// head dims 16/32/64/128: the 3xTF32 forward, the 32-row SIMT dQ and
// dK/dV), 2 = "wgmma" (bf16 on the TMA ring with wgmma, all three
// functions at head dims 16/32/64/128; its operands must meet TMA's
// rules). Each plan must be at its kernel's tile sizes. Any other code is
// refused: 1 was the bf16 WMMA kernels, 3 the bf16 SIMT ones (removed).
enum Variant { F32 = 0, WGMMA = 2 };

int dispatch(const FlashArgs* a, Which which, int variant, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->B <= 0 || a->Hq <= 0 || a->Hkv <= 0 || a->S <= 0 || a->Hq % a->Hkv ||
      a->mask_type < MASK_FULL || a->mask_type > MASK_BAND ||
      a->score_mod < MOD_NONE || a->score_mod > MOD_SOFTCAP ||
      (a->score_mod != MOD_NONE && !(a->score_arg > 0.0)) ||
      !(head_dim == 16 || head_dim == 32 || head_dim == 64 || head_dim == 128))
    return (int)cudaErrorInvalidValue;
  if (variant == F32) {
    switch (head_dim) {
      case 16: return launch_f32<16>(a, which, s);
      case 32: return launch_f32<32>(a, which, s);
      case 64: return launch_f32<64>(a, which, s);
      default: return launch_f32<128>(a, which, s);
    }
  }
  if (variant == WGMMA) {
    if (!tma_ok(a, which)) return (int)cudaErrorInvalidValue;
    if (a->score_mod == MOD_ALIBI) return launch_wgmma<MOD_ALIBI>(a, which, head_dim, s);
    if (a->score_mod == MOD_SOFTCAP) return launch_wgmma<MOD_SOFTCAP>(a, which, head_dim, s);
    return launch_wgmma<MOD_NONE>(a, which, head_dim, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd_launch(const FlashArgs* a, int variant, int head_dim, void* stream) {
  return dispatch(a, FWD, variant, head_dim, stream);
}

extern "C" int flash_bwd_dq_launch(const FlashArgs* a, int variant, int head_dim,
                                   void* stream) {
  return dispatch(a, DQ, variant, head_dim, stream);
}

extern "C" int flash_bwd_dkv_launch(const FlashArgs* a, int variant, int head_dim,
                                    void* stream) {
  return dispatch(a, DKV, variant, head_dim, stream);
}
