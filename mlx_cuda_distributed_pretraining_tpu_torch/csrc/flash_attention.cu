// Flash attention forward, dQ and dK/dV for NVIDIA Hopper (sm_90a).
//
// Replaces, in mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- flash_fwd     (Pallas body _fwd_kernel)
//   flash_bwd_dq_kernel   <- flash_bwd_dq  (Pallas body _bwd_dq_kernel)
//   flash_bwd_dkv_kernel  <- flash_bwd_dkv (Pallas body _bwd_dkv_kernel)
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
// Types: bf16 runs the tile products on the tensor cores with WMMA 16x16x16
// fragments into fp32 (64-row tiles); fp32 runs SIMT FMA tiles (32-row
// tiles). Head dims 64 and 128 are template instances.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// training path's shape B 32, H 8, S 1024, D 64, bf16, causal:
//   fwd   34.4 GFLOP, ~135 MB  -> 0.040 ms (bytes; operations 0.035 ms)
//   dQ    51.5 GFLOP, ~170 MB  -> 0.052 ms (operations)
//   dK/dV 68.7 GFLOP, ~203 MB  -> 0.070 ms (operations)
// All three are operation-bound in principle. This first design is simple
// and right before it is fast: tiles staged through shared memory with plain
// vector loads (no TMA, no cp.async pipeline), WMMA (not wgmma), the score
// tile round-trips through shared memory, one 4-warp CTA per tile. wgmma,
// TMA and warp specialisation are later work.
//
// Interface: plain C, loaded with ctypes. Each *_launch returns
// cudaGetLastError() after the launch (0 on success); nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

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

// Shared-memory leading dims: T rows padded by 16 bytes (keeps WMMA's
// 16-byte ldm rule and spreads banks); fp32 rows by 4 floats.
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

// C[M, N] (fp32, row-major, ldc) (+)= A[M, K] . B[K, N], operands in shared
// memory. A_COL: A is stored transposed (element (m, k) at A[k * lda + m]);
// B_COL: element (k, n) at B[n * ldb + k]. bf16 -> WMMA, fp32 -> SIMT FMA.
template <typename T, int M, int N, int K, bool A_COL, bool B_COL, bool ACCUM>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* B, int ldb) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    using ALay = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLay = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    constexpr int FN = N / 16;
    for (int f = warp; f < (M / 16) * FN; f += NWARPS) {
      const int fm = f / FN, fn = f % FN;
      float* cp = C + fm * 16 * ldc + fn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACCUM)
        wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALay> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLay> fb;
        const T* ap = A_COL ? A + kk * lda + fm * 16 : A + fm * 16 * lda + kk;
        const T* bp = B_COL ? B + fn * 16 * ldb + kk : B + kk * ldb + fn * 16;
        wmma::load_matrix_sync(fa, ap, lda);
        wmma::load_matrix_sync(fb, bp, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
    }
  } else {
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

// ------------------------------------------------------------------ launchers
enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, int D, int BM>
int launch(const FlashArgs* a, Which which, cudaStream_t stream) {
  const unsigned n_tiles = (unsigned)(which == DKV ? a->nk : a->nq);
  const dim3 grid(n_tiles, (unsigned)a->Hq, (unsigned)a->B);
  cudaError_t err;
  switch (which) {
    case FWD: {
      constexpr size_t bytes = fwd_smem<T, D, BM>();
      err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, BM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_kernel<T, D, BM><<<grid, NTHREADS, bytes, stream>>>(*a);
      break;
    }
    case DQ: {
      constexpr size_t bytes = dq_smem<T, D, BM>();
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, BM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      flash_bwd_dq_kernel<T, D, BM><<<grid, NTHREADS, bytes, stream>>>(*a);
      break;
    }
    default: {
      constexpr size_t bytes = dkv_smem<T, D, BM>();
      err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, BM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      flash_bwd_dkv_kernel<T, D, BM><<<grid, NTHREADS, bytes, stream>>>(*a);
      break;
    }
  }
  return (int)cudaGetLastError();
}

// dtype 0 = fp32 (32-row SIMT tiles), 1 = bf16 (64-row WMMA tiles).
int dispatch(const FlashArgs* a, Which which, int dtype, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->B <= 0 || a->Hq <= 0 || a->Hkv <= 0 || a->S <= 0 || a->Hq % a->Hkv)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch<float, 64, 32>(a, which, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128, 32>(a, which, s);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64, 64>(a, which, s);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128, 64>(a, which, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd_launch(const FlashArgs* a, int dtype, int head_dim, void* stream) {
  return dispatch(a, FWD, dtype, head_dim, stream);
}

extern "C" int flash_bwd_dq_launch(const FlashArgs* a, int dtype, int head_dim, void* stream) {
  return dispatch(a, DQ, dtype, head_dim, stream);
}

extern "C" int flash_bwd_dkv_launch(const FlashArgs* a, int dtype, int head_dim, void* stream) {
  return dispatch(a, DKV, dtype, head_dim, stream);
}
