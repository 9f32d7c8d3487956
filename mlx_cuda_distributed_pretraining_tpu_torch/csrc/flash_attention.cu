// Flash attention forward, dQ and dK/dV for NVIDIA Hopper (sm_90a).
//
// Replaces, in mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:
//   flash_fwd_bf16_wgmma_kernel, flash_fwd_kernel  <- flash_fwd (Pallas body
//                                                      _fwd_kernel)
//   flash_bwd_dq_bf16_wgmma_kernel, flash_bwd_dq_kernel
//                                                   <- flash_bwd_dq (_bwd_dq_kernel)
//   flash_bwd_dkv_bf16_wgmma_kernel, flash_bwd_dkv_kernel
//                                                   <- flash_bwd_dkv (_bwd_dkv_kernel)
//
// Variants (the wrapper's flash_variant picks one before launch; the C
// entries take its code):
//   "wgmma"  bf16: a TMA ring feeding wgmma, the scores, P and dS kept in
//            registers (their own note below);
//   "f32"    fp32: SIMT FMA tiles.
//
// Each computes what its Pallas body computes (not block by block):
//   fwd:  s = (q . k^T) * scale in fp32, masked to NEG_INF = -1e30; online
//         softmax with running max m, denominator l and an fp32 accumulator,
//         p cast to v's type before p . v; o = acc / max(l, 1e-30) in q's
//         type and lse = m + log(max(l, 1e-30)) in fp32.
//   dQ:   p = exp(s - lse), ds = p * (dO . v^T - delta) * scale,
//         dq += ds.to(k type) . k in fp32; output in q's type.
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
// Types: bf16 runs the wgmma kernels; fp32 runs SIMT FMA tiles (32-row
// tiles). Head dims 64 and 128 are template instances.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// training path's shape B 32, H 8, S 1024, D 64, bf16, causal:
//   fwd   34.4 GFLOP, ~135 MB  -> 0.040 ms (bytes; operations 0.035 ms)
//   dQ    51.5 GFLOP, ~170 MB  -> 0.052 ms (operations)
//   dK/dV 68.7 GFLOP, ~203 MB  -> 0.070 ms (operations)
// All three are operation-bound in principle, and beside the tensor cores
// each pays an exp per score on the SFU (16 a clock per SM: the exps of a
// 128 x 128 tile take as long as its two 64-deep products at peak). The
// fp32 kernels stage tiles through shared memory and round-trip the scores
// through it, one 4-warp CTA per tile. The wgmma kernels keep the scores in
// registers and let one warpgroup's softmax run under the other's products
// (note below).
//
// Interface: plain C, loaded with ctypes. Each *_launch returns
// cudaGetLastError() after the launch (0 on success); nothing synchronises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"  // namespace wg: TMA, mbarriers, wgmma; tensor maps

namespace {

constexpr float NEG_INF = -1e30f;  // large-but-finite, as ops/masks.py
constexpr int NTHREADS = 128;      // 4 warps per CTA
constexpr int NWARPS = NTHREADS / 32;

// Mask codes (the wrapper's _MASK_CODES).
constexpr int MASK_FULL = 0;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_SLIDING = 2;
constexpr int MASK_PREFIX = 3;

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
};

namespace {

// The SIMT kernels' output conversion (they run fp32 only).
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ bool allowed(int mask, int64_t row, int64_t col,
                                        int64_t window, int64_t prefix) {
  switch (mask) {
    case MASK_CAUSAL: return row >= col;
    case MASK_SLIDING: return row >= col && row - col < window;
    case MASK_PREFIX: return row >= col || col < prefix;
    default: return true;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory leading dims: T rows padded by 16 bytes (spreads banks);
// fp32 rows by 4 floats.
template <typename T, int N>
struct Ld {
  static constexpr int value = N + 16 / (int)sizeof(T);
};
template <int N>
struct LdF {
  static constexpr int value = N + 4;
};

// Copy rows [row0, row0 + ROWS) of a [S, D] slab (row stride `stride`
// elements, contiguous D) into shared memory; rows past S are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride,
                                          int64_t row0, int64_t S) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = D / VEC;
  constexpr int LD = Ld<T, D>::value;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// C[M, N] (fp32, row-major, ldc) (+)= A[M, K] . B[K, N], fp32 operands in
// shared memory, SIMT FMA. A_COL: A is stored transposed (element (m, k) at
// A[k * lda + m]); B_COL: element (k, n) at B[n * ldb + k].
template <typename T, int M, int N, int K, bool A_COL, bool B_COL, bool ACCUM>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* B, int ldb) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the wgmma kernels");
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

// ------------------------------------------------------------------- forward
template <typename T, int D, int BM>
constexpr size_t fwd_smem() {
  constexpr int BN = BM;
  return 3 * rup(sizeof(T) * BM * Ld<T, D>::value) +
         rup(sizeof(float) * BM * LdF<BN>::value) +
         rup(sizeof(T) * BM * Ld<T, BN>::value) +
         rup(sizeof(float) * BM * LdF<D>::value) + 2 * rup(sizeof(float) * BM);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int BN = BM;
  constexpr int LDT = Ld<T, D>::value, LDS = LdF<BN>::value;
  constexpr int LDP = Ld<T, BN>::value, LDA = LdF<D>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BM * LDT);
  T* Ks = cv.take<T>(BN * LDT);
  T* Vs = cv.take<T>(BN * LDT);
  float* Ss = cv.take<float>(BM * LDS);
  T* Ps = cv.take<T>(BM * LDP);
  float* Acc = cv.take<float>(BM * LDA);
  float* m_s = cv.take<float>(BM);
  float* l_s = cv.take<float>(BM);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (int)(a.Hq / a.Hkv);
  const int64_t S = a.S, q0 = (int64_t)qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = (float)a.scale;
  const int mask = (int)a.mask_type;

  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  load_tile<T, D, BM>(Qs, qg, a.sq[2], q0, S);
  for (int i = threadIdx.x; i < BM * LDA; i += NTHREADS) Acc[i] = 0.f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  const int lo = a.ranges[2 * qt], hi = a.ranges[2 * qt + 1];
  for (int j = lo; j < hi; ++j) {
    const int64_t k0 = (int64_t)j * BN;
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    load_tile<T, D, BN>(Ks, kg, a.sk[2], k0, S);
    load_tile<T, D, BN>(Vs, vg, a.sv[2], k0, S);
    __syncthreads();
    mm<T, BM, BN, D, false, true, false>(Ss, LDS, Qs, LDT, Ks, LDT);  // q k^T
    __syncthreads();
    const bool full = a.full[(int64_t)qt * a.nk + j] != 0;
    for (int r = warp; r < BM; r += NWARPS) {  // one warp per row
      const int64_t row = q0 + r;
      float sv[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const int c = lane + 32 * t;
        const int64_t col = k0 + c;
        float s = Ss[r * LDS + c] * scale;
        if (!full) {
          if (row >= S || col >= S)
            s = -INFINITY;  // outside the sequence: never contributes
          else if (!allowed(mask, row, col, a.window, a.prefix))
            s = NEG_INF;
        }
        sv[t] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 32; ++t) {
        const float p = expf(sv[t] - m_new);
        sum += p;
        Ps[r * LDP + lane + 32 * t] = from_f<T>(p);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Acc[r * LDA + d] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();
    mm<T, BM, D, BN, false, false, true>(Acc, LDA, Ps, LDP, Vs, LDT);  // += p v
  }
  __syncthreads();
  T* og = static_cast<T*>(a.out0) + b * a.so[0] + h * a.so[1];
  for (int i = threadIdx.x; i < BM * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < S)
      og[(q0 + r) * a.so[2] + d] = from_f<T>(Acc[r * LDA + d] / fmaxf(l_s[r], 1e-30f));
  }
  for (int r = threadIdx.x; r < BM; r += NTHREADS)
    if (q0 + r < S)
      a.lse_out[((int64_t)b * a.Hq + h) * S + q0 + r] =
          m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// ------------------------------------------------------------------------ dQ
template <typename T, int D, int BM>
constexpr size_t dq_smem() {
  constexpr int BN = BM;
  return 4 * rup(sizeof(T) * BM * Ld<T, D>::value) +
         2 * rup(sizeof(float) * BM * LdF<BN>::value) +
         rup(sizeof(T) * BM * Ld<T, BN>::value) +
         rup(sizeof(float) * BM * LdF<D>::value) + 2 * rup(sizeof(float) * BM);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int BN = BM;
  constexpr int LDT = Ld<T, D>::value, LDS = LdF<BN>::value;
  constexpr int LDP = Ld<T, BN>::value, LDA = LdF<D>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BM * LDT);
  T* dOs = cv.take<T>(BM * LDT);
  T* Ks = cv.take<T>(BN * LDT);
  T* Vs = cv.take<T>(BN * LDT);
  float* Ss = cv.take<float>(BM * LDS);
  float* dPs = cv.take<float>(BM * LDS);
  T* dSs = cv.take<T>(BM * LDP);
  float* Acc = cv.take<float>(BM * LDA);
  float* lse_s = cv.take<float>(BM);
  float* delta_s = cv.take<float>(BM);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (int)(a.Hq / a.Hkv);
  const int64_t S = a.S, q0 = (int64_t)qt * BM;
  const float scale = (float)a.scale;
  const int mask = (int)a.mask_type;

  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dog = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  load_tile<T, D, BM>(Qs, qg, a.sq[2], q0, S);
  load_tile<T, D, BM>(dOs, dog, a.sdo[2], q0, S);
  const int64_t stat0 = ((int64_t)b * a.Hq + h) * S;
  for (int r = threadIdx.x; r < BM; r += NTHREADS) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? a.lse_in[stat0 + q0 + r] : 0.f;
    delta_s[r] = in ? a.delta[stat0 + q0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < BM * LDA; i += NTHREADS) Acc[i] = 0.f;
  const int lo = a.ranges[2 * qt], hi = a.ranges[2 * qt + 1];
  for (int j = lo; j < hi; ++j) {
    const int64_t k0 = (int64_t)j * BN;
    __syncthreads();
    load_tile<T, D, BN>(Ks, kg, a.sk[2], k0, S);
    load_tile<T, D, BN>(Vs, vg, a.sv[2], k0, S);
    __syncthreads();
    mm<T, BM, BN, D, false, true, false>(Ss, LDS, Qs, LDT, Ks, LDT);    // q k^T
    mm<T, BM, BN, D, false, true, false>(dPs, LDS, dOs, LDT, Vs, LDT);  // dO v^T
    __syncthreads();
    const bool full = a.full[(int64_t)qt * a.nk + j] != 0;
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int64_t row = q0 + r, col = k0 + c;
      float s = Ss[r * LDS + c] * scale;
      float p;
      if (!full && (row >= S || col >= S)) {
        p = 0.f;
      } else {
        if (!full && !allowed(mask, row, col, a.window, a.prefix)) s = NEG_INF;
        p = expf(s - lse_s[r]);
      }
      const float ds = p * (dPs[r * LDS + c] - delta_s[r]) * scale;
      dSs[r * LDP + c] = from_f<T>(ds);
    }
    __syncthreads();
    mm<T, BM, D, BN, false, false, true>(Acc, LDA, dSs, LDP, Ks, LDT);  // += ds k
  }
  __syncthreads();
  T* dqg = static_cast<T*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  for (int i = threadIdx.x; i < BM * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < S) dqg[(q0 + r) * a.s0[2] + d] = from_f<T>(Acc[r * LDA + d]);
  }
}

// --------------------------------------------------------------------- dK/dV
template <typename T, int D, int BM>
constexpr size_t dkv_smem() {
  constexpr int BN = BM;
  return 4 * rup(sizeof(T) * BM * Ld<T, D>::value) +
         2 * rup(sizeof(float) * BM * LdF<BN>::value) +
         2 * rup(sizeof(T) * BM * Ld<T, BN>::value) +
         2 * rup(sizeof(float) * BN * LdF<D>::value) + 2 * rup(sizeof(float) * BM);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int BN = BM;
  constexpr int LDT = Ld<T, D>::value, LDS = LdF<BN>::value;
  constexpr int LDP = Ld<T, BN>::value, LDA = LdF<D>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(BN * LDT);
  T* Vs = cv.take<T>(BN * LDT);
  T* Qs = cv.take<T>(BM * LDT);
  T* dOs = cv.take<T>(BM * LDT);
  float* Ss = cv.take<float>(BM * LDS);
  float* dPs = cv.take<float>(BM * LDS);
  T* Ps = cv.take<T>(BM * LDP);
  T* dSs = cv.take<T>(BM * LDP);
  float* dK = cv.take<float>(BN * LDA);
  float* dV = cv.take<float>(BN * LDA);
  float* lse_s = cv.take<float>(BM);
  float* delta_s = cv.take<float>(BM);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (int)(a.Hq / a.Hkv);
  const int64_t S = a.S, k0 = (int64_t)kt * BN;
  const float scale = (float)a.scale;
  const int mask = (int)a.mask_type;

  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dog = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  load_tile<T, D, BN>(Ks, kg, a.sk[2], k0, S);
  load_tile<T, D, BN>(Vs, vg, a.sv[2], k0, S);
  for (int i = threadIdx.x; i < BN * LDA; i += NTHREADS) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  const int64_t stat0 = ((int64_t)b * a.Hq + h) * S;
  const int lo = a.ranges[2 * kt], hi = a.ranges[2 * kt + 1];
  for (int j = lo; j < hi; ++j) {
    const int64_t q0 = (int64_t)j * BM;
    __syncthreads();
    load_tile<T, D, BM>(Qs, qg, a.sq[2], q0, S);
    load_tile<T, D, BM>(dOs, dog, a.sdo[2], q0, S);
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse_in[stat0 + q0 + r] : 0.f;
      delta_s[r] = in ? a.delta[stat0 + q0 + r] : 0.f;
    }
    __syncthreads();
    mm<T, BM, BN, D, false, true, false>(Ss, LDS, Qs, LDT, Ks, LDT);    // q k^T
    mm<T, BM, BN, D, false, true, false>(dPs, LDS, dOs, LDT, Vs, LDT);  // dO v^T
    __syncthreads();
    const bool full = a.full[(int64_t)j * a.nk + kt] != 0;
    for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      const int64_t row = q0 + r, col = k0 + c;
      float s = Ss[r * LDS + c] * scale;
      float p;
      if (!full && (row >= S || col >= S)) {
        p = 0.f;
      } else {
        if (!full && !allowed(mask, row, col, a.window, a.prefix)) s = NEG_INF;
        p = expf(s - lse_s[r]);
      }
      Ps[r * LDP + c] = from_f<T>(p);
      dSs[r * LDP + c] = from_f<T>(p * (dPs[r * LDS + c] - delta_s[r]) * scale);
    }
    __syncthreads();
    mm<T, BN, D, BM, true, false, true>(dV, LDA, Ps, LDP, dOs, LDT);  // += p^T dO
    mm<T, BN, D, BM, true, false, true>(dK, LDA, dSs, LDP, Qs, LDT);  // += ds^T q
  }
  __syncthreads();
  T* dkg = static_cast<T*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  T* dvg = static_cast<T*>(a.out1) + b * a.s1[0] + h * a.s1[1];
  for (int i = threadIdx.x; i < BN * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    if (k0 + r < S) {
      dkg[(k0 + r) * a.s0[2] + d] = from_f<T>(dK[r * LDA + d]);
      dvg[(k0 + r) * a.s1[2] + d] = from_f<T>(dV[r * LDA + d]);
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
// (dims D, S, H, B; 64-column boxes with 128-byte swizzle), so the model's
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
constexpr int FWD_BQ = 128;      // forward: query rows per CTA
constexpr int FWD_BKV = 128;     // forward: KV rows per ring stage
constexpr int DKV_BKV = 128;     // dK/dV: KV rows per CTA
constexpr int DQ_BQ = 128;       // dQ: query rows per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Ring depths and dK/dV's query rows per stage, by head dim, as swept on
// an H100 (PERF.md): at D 128 dK and dV alone hold 128 registers a thread,
// so dK/dV takes 64 query rows per stage there.
constexpr int FWD_STAGES_D64 = 3;
constexpr int FWD_STAGES_D128 = 3;
constexpr int DKV_BQ_D64 = 128;
constexpr int DKV_BQ_D128 = 64;
constexpr int DKV_STAGES_D64 = 2;
constexpr int DKV_STAGES_D128 = 2;
// dQ's KV rows per stage and ring depths: at D 128 dQ alone holds 64
// registers a thread, so its KV tile is 64 rows there.
constexpr int DQ_BKV_D64 = 128;
constexpr int DQ_BKV_D128 = 64;
constexpr int DQ_STAGES_D64 = 3;
constexpr int DQ_STAGES_D128 = 3;
constexpr int GROUP_HEADS = 16;  // (batch, head) pairs per group of the CTA order

template <int D>
constexpr int fwd_stages() { return D == 64 ? FWD_STAGES_D64 : FWD_STAGES_D128; }
template <int D>
constexpr int dkv_bq() { return D == 64 ? DKV_BQ_D64 : DKV_BQ_D128; }
template <int D>
constexpr int dkv_stages() { return D == 64 ? DKV_STAGES_D64 : DKV_STAGES_D128; }
template <int D>
constexpr int dq_bkv() { return D == 64 ? DQ_BKV_D64 : DQ_BKV_D128; }
template <int D>
constexpr int dq_stages() { return D == 64 ? DQ_STAGES_D64 : DQ_STAGES_D128; }

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

// The four masks as one branch-free predicate over 32-bit positions (the
// launchers check S < 2^31): allowed(row, col) = (col <= row && row - col <
// win) || col < pre, with (win, pre) = (INT_MAX, 0) causal, (window, 0)
// sliding_window, (INT_MAX, prefix) prefix_lm, (INT_MAX, INT_MAX) full.
struct Mask32 {
  int win, pre;
  __device__ __forceinline__ bool allowed(int row, int col) const {
    return ((col <= row) & (row - col < win)) | (col < pre);
  }
};

__device__ __forceinline__ Mask32 mask32(const FlashArgs& a) {
  const auto sat = [](int64_t x) {
    return static_cast<int>(x > INT32_MAX ? INT32_MAX : x < INT32_MIN ? INT32_MIN : x);
  };
  switch (a.mask_type) {
    case MASK_CAUSAL: return {INT32_MAX, 0};
    case MASK_SLIDING: return {sat(a.window), 0};
    case MASK_PREFIX: return {INT32_MAX, sat(a.prefix)};
    default: return {INT32_MAX, INT32_MAX};
  }
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

template <int D, int STAGES>
__global__ void __launch_bounds__(256, 1)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const FlashArgs a) {
  using namespace wg;
  constexpr int NB = D / 64;             // 64-column boxes per row
  constexpr int Q_BOX = FWD_BQ * 128;    // one box of the Q tile
  constexpr int KV_BOX = FWD_BKV * 128;  // one box of a K or V tile
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
    for (int c = 0; c < NB; ++c) tma_4d(kb + c * KV_BOX, &map_k, bar, 64 * c, row, hk, b);
    for (int c = 0; c < NB; ++c) tma_4d(vb + c * KV_BOX, &map_v, bar, 64 * c, row, hk, b);
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
      tma_4d(smem_addr(qs + c * Q_BOX), &map_q, qbar, 64 * c, qt * FWD_BQ, h, b);
    for (int it = 0; it < n && it < STAGES; ++it) load(it);
  }
  __syncthreads();

  // g through a shuffle: warp-uniform to the compiler, so the descriptors
  // derived from it stay in uniform registers (see the wgmma note)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), t = tid % 128;
  const int S = static_cast<int>(a.S);
  const int row0 = qt * FWD_BQ + 64 * g + 16 * (t / 32) + (t % 32) / 4;
  const int c0 = 2 * (t % 4);
  const float sl2 = static_cast<float>(a.scale) * LOG2E;
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
  const uint32_t qa = smem_addr(qs) + g * 64 * 128;
  // S_j = Q K_j^T for the tile in stage s into sc (one commit group). sc is
  // a fresh array per tile: scores kept across tiles would be live inputs
  // of the next product, moved into place inside the wgmma batch, and ptxas
  // then serializes every wgmma.
  const auto issue_s = [&](float (&sc)[FWD_BKV / 2], int s) {
    const uint32_t kb = smem_addr(ring + s * STAGE);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<FWD_BKV, 0, 0>::run(sc, desc(qa + (ks / 4) * Q_BOX + (ks % 4) * 32, 16, ATOM),
                                desc(kb + (ks / 4) * KV_BOX + (ks % 4) * 32, 16, ATOM),
                                ks > 0 ? 1 : 0);
    wgmma_commit();
  };
  // O += bf16(P) V for the tile in stage s (one commit group)
  const auto issue_pv = [&](int s) {
    const uint32_t vb = smem_addr(ring + s * STAGE) + KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < FWD_BKV / 16; ++kk)
      WgmmaRS<D, 1>::run(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         desc(vb + kk * 16 * 128, KV_BOX, ATOM), 1);
    wgmma_commit();
  };
  // The online softmax of S_j (in sc): mask, new running max, P into pn,
  // the row sums, and alpha = 2^(m_old - m_new) for O.
  const auto softmax = [&](float (&sc)[FWD_BKV / 2], int j, bool full_tile, uint32_t (&pn)[NP],
                           float (&alpha)[2]) {
    const int k0 = j * FWD_BKV + c0;
    if (full_tile) {
#pragma unroll
      for (int i = 0; i < FWD_BKV / 2; ++i) sc[i] *= sl2;
    } else {
#pragma unroll
      for (int i = 0; i < FWD_BKV / 2; ++i) {
        const int row = row0 + acc_row(i), col = k0 + acc_col(i);
        const float x = mask.allowed(row, col) ? sc[i] * sl2 : NEG_INF;
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

template <int D, int BQ, int STAGES>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const FlashArgs a) {
  using namespace wg;
  constexpr int NB = D / 64;
  constexpr int KV_BOX = DKV_BKV * 128;
  constexpr int KV_BYTES = NB * KV_BOX;
  constexpr int Q_BOX = BQ * 128;
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
      for (int c = 0; c < NB; ++c) tma_4d(qb + c * Q_BOX, &map_q, bar, 64 * c, q0, h, b);
      for (int c = 0; c < NB; ++c) tma_4d(dob + c * Q_BOX, &map_do, bar, 64 * c, q0, h, b);
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
        tma_4d(smem_addr(ks + c * KV_BOX), &map_k, bar, 64 * c, kt * DKV_BKV, hk, b);
      for (int c = 0; c < NB; ++c)
        tma_4d(smem_addr(vs + c * KV_BOX), &map_v, bar, 64 * c, kt * DKV_BKV, hk, b);
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
  const float sl2 = scale * LOG2E;
  const Mask32 mask = mask32(a);
  const int S32 = static_cast<int>(S);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (g == 1 && n > 0) bar_arrive(BAR_TURN, 256);  // warpgroup 0 takes the first turn
  mbar_wait(&kv_full, 0);
  const uint32_t ka = smem_addr(ks) + g * 64 * 128, va = smem_addr(vs) + g * 64 * 128;
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
      Wgmma<BQ, 0, 0>::run(st, desc(ka + (kk / 4) * KV_BOX + (kk % 4) * 32, 16, ATOM),
                           desc(qb + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, ATOM),
                           kk > 0 ? 1 : 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ, 0, 0>::run(dpt, desc(va + (kk / 4) * KV_BOX + (kk % 4) * 32, 16, ATOM),
                           desc(dob + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, ATOM),
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
    // P^T and dS^T of element idx; masked: the mask and S's bounds apply
    const auto pds = [&](int idx, bool masked, float& p, float& ds) {
      const int col = c0 + acc_col(idx);
      float x = st[idx] * sl2;
      bool live = true;
      if (masked) {
        const int q = q0 + acc_col(idx), kv = kv0 + acc_row(idx);
        x = mask.allowed(q, kv) ? x : NEG_INF;
        live = (q < S32) & (kv < S32);  // outside the sequence: p = 0
      }
      p = exp2_approx(x - lse[col] * LOG2E);  // finite: lse is 0 past S
      p = live ? p : 0.f;
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
                         desc(dob + kk * 16 * 128, Q_BOX, ATOM), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::run(dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                         desc(qb + kk * 16 * 128, Q_BOX, ATOM), 1);
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
// holds 64 registers a thread, so the KV tile is 64 rows there.
template <int D, int BKV, int STAGES>
constexpr int dq_wg_smem() {
  return (2 * DQ_BQ + STAGES * 2 * BKV) * D * 2 + wg::ATOM;
}

template <int D, int BKV, int STAGES>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const FlashArgs a) {
  using namespace wg;
  constexpr int NB = D / 64;
  constexpr int Q_BOX = DQ_BQ * 128;
  constexpr int Q_BYTES = NB * Q_BOX;
  constexpr int KV_BOX = BKV * 128;
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
    for (int c = 0; c < NB; ++c) tma_4d(kb + c * KV_BOX, &map_k, bar, 64 * c, row, hk, b);
    for (int c = 0; c < NB; ++c) tma_4d(vb + c * KV_BOX, &map_v, bar, 64 * c, row, hk, b);
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
      tma_4d(smem_addr(qs + c * Q_BOX), &map_q, qbar, 64 * c, qt * DQ_BQ, h, b);
    for (int c = 0; c < NB; ++c)
      tma_4d(smem_addr(dos + c * Q_BOX), &map_do, qbar, 64 * c, qt * DQ_BQ, h, b);
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
  const float sl2 = scale * LOG2E;
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
  const uint32_t qa = smem_addr(qs) + g * 64 * 128, doa = smem_addr(dos) + g * 64 * 128;
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
      Wgmma<BKV, 0, 0>::run(st, desc(qa + (ks / 4) * Q_BOX + (ks % 4) * 32, 16, ATOM),
                            desc(kb + (ks / 4) * KV_BOX + (ks % 4) * 32, 16, ATOM),
                            ks > 0 ? 1 : 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      Wgmma<BKV, 0, 0>::run(dpt, desc(doa + (ks / 4) * Q_BOX + (ks % 4) * 32, 16, ATOM),
                            desc(vb + (ks / 4) * KV_BOX + (ks % 4) * 32, 16, ATOM),
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
      float x = st[idx] * sl2;
      bool live = true;
      if (masked) {
        const int row = row0 + acc_row(idx), col = k0 + acc_col(idx);
        x = mask.allowed(row, col) ? x : NEG_INF;
        live = (row < S) & (col < S);  // outside the sequence: p = 0
      }
      float p = exp2_approx(x - lse2[r]);
      p = live ? p : 0.f;
      return p * (dpt[idx] - dlt[r]) * scale;
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
                         desc(kb + kk * 16 * 128, KV_BOX, ATOM), 1);
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

// ------------------------------------------------------------------ launchers
enum Which { FWD = 0, DQ = 1, DKV = 2 };

// ------------------------------------------------ host side of the wgmma path
int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

// A 4-D tensor map over one [B, H, S, D] bf16 operand read through its
// element strides st = (b, h, s) with a contiguous D: dims (D, S, H, B),
// boxes of 64 columns x `rows` rows.
int bhsd_map(CUtensorMap* map, const void* base, const int64_t* st, int64_t B, int64_t H,
             int64_t S, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return wg::bf16_map_strided(map, base, 4, dims, strides, box);
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

template <int D>
int launch_fwd_wgmma(const FlashArgs* a, cudaStream_t stream) {
  constexpr int STAGES = fwd_stages<D>();
  if (a->nq != cdiv(a->S, FWD_BQ) || a->nk != cdiv(a->S, FWD_BKV) || a->S >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // a plan at other tile sizes
  CUtensorMap mq, mk, mv;
  int err = bhsd_map(&mq, a->q, a->sq, a->B, a->Hq, a->S, D, FWD_BQ);
  if (err == 0) err = bhsd_map(&mk, a->k, a->sk, a->B, a->Hkv, a->S, D, FWD_BKV);
  if (err == 0) err = bhsd_map(&mv, a->v, a->sv, a->B, a->Hkv, a->S, D, FWD_BKV);
  if (err != 0) return err;
  const auto kernel = flash_fwd_bf16_wgmma_kernel<D, STAGES>;
  constexpr int smem = fwd_wg_smem<D, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nq * a->B * a->Hq), 256, smem, stream>>>(mq, mk, mv, *a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
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
  const auto kernel = flash_bwd_dkv_bf16_wgmma_kernel<D, BQ, STAGES>;
  constexpr int smem = dkv_wg_smem<D, BQ, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nk * a->B * a->Hq), 256, smem, stream>>>(
      mq, mk, mv, mdo, *a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
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
  const auto kernel = flash_bwd_dq_bf16_wgmma_kernel<D, BKV, STAGES>;
  constexpr int smem = dq_wg_smem<D, BKV, STAGES>();
  static std::atomic<unsigned long long> ready{0};
  err = wg::allow_smem(ready, kernel, smem);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(a->nq * a->B * a->Hq), 256, smem, stream>>>(
      mq, mk, mv, mdo, *a);
  return static_cast<int>(cudaGetLastError());
}

// The 32-row SIMT (fp32) kernels: one CTA per tile, grid (tiles, Hq, B).
template <typename T, int D, int BM, Which W>
int launch(const FlashArgs* a, cudaStream_t stream) {
  const dim3 grid((unsigned)(W == DKV ? a->nk : a->nq), (unsigned)a->Hq, (unsigned)a->B);
  void (*kernel)(const FlashArgs);
  size_t bytes;
  if constexpr (W == FWD) {
    kernel = flash_fwd_kernel<T, D, BM>;
    bytes = fwd_smem<T, D, BM>();
  } else if constexpr (W == DQ) {
    kernel = flash_bwd_dq_kernel<T, D, BM>;
    bytes = dq_smem<T, D, BM>();
  } else {
    kernel = flash_bwd_dkv_kernel<T, D, BM>;
    bytes = dkv_smem<T, D, BM>();
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, bytes, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const FlashArgs* a, Which which, cudaStream_t s) {
  if (which == FWD) return launch<float, D, 32, FWD>(a, s);
  if (which == DQ) return launch<float, D, 32, DQ>(a, s);
  return launch<float, D, 32, DKV>(a, s);
}

// Kernel variants (the wrapper's flash_variant codes): 0 = "f32" (fp32,
// 32-row SIMT tiles), 2 = "wgmma" (bf16 on the TMA ring with wgmma; its plan
// must be at its own tile sizes, and its operands must meet TMA's rules).
// Any other code is refused.
enum Variant { F32 = 0, WGMMA = 2 };

int dispatch(const FlashArgs* a, Which which, int variant, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->B <= 0 || a->Hq <= 0 || a->Hkv <= 0 || a->S <= 0 || a->Hq % a->Hkv ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const bool d64 = head_dim == 64;
  if (variant == F32) return d64 ? launch_f32<64>(a, which, s) : launch_f32<128>(a, which, s);
  if (variant == WGMMA) {
    if (!tma_ok(a, which)) return (int)cudaErrorInvalidValue;
    if (which == FWD) return d64 ? launch_fwd_wgmma<64>(a, s) : launch_fwd_wgmma<128>(a, s);
    if (which == DQ) return d64 ? launch_dq_wgmma<64>(a, s) : launch_dq_wgmma<128>(a, s);
    return d64 ? launch_dkv_wgmma<64>(a, s) : launch_dkv_wgmma<128>(a, s);
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
