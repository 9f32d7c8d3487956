// Flash attention forward, dQ and dK/dV in fp32 for NVIDIA Hopper (sm_90a):
// the "f32" variant, in a library of its own (its nvcc runs beside
// flash_attention.cu's).
//
// Replaces, in mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:
//   flash_fwd_f32_kernel      <- flash_fwd (Pallas body _fwd_kernel)
//   flash_bwd_dq_f32_kernel   <- flash_bwd_dq (_bwd_dq_kernel)
//   flash_bwd_dkv_f32_kernel  <- flash_bwd_dkv (_bwd_dkv_kernel)
//
// What each computes, the layout, the block sparsity, the masks and the
// score mods are as in flash_attention.cu's header note; here each runs on
// 3xTF32 mma.sync (dQ's dP on fp64 mma.sync) fed by a cp.async ring, at
// head dims 16, 32, 64 and 128, the score mod a template parameter (ModF).
// The notes below give each kernel's design and what bounds it.
//
// Interface: plain C, loaded with ctypes: the same entries as
// flash_attention.cu's, each refusing every variant code but 0 ("f32");
// each returns cudaGetLastError() after the launch (0 on success); nothing
// synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "flash_common.cuh"  // FlashArgs, codes, Mask32, dispatch checks
#include "hopper.cuh"        // namespace wg: cp.async, split_tf32, mma_tf32

namespace {

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

// The fp32 kernels' score mod, a template parameter (the softmax and the
// backward's elementwise pass then hold no branch on it): s = scale q . k
// through the mod, in natural units, with the plain version's arithmetic
// (tanhf for soft_cap); the backward takes the mod's Jacobian in dmod (1
// unless soft_cap: 1 - tanh^2(s / cap)).
template <int MOD>
struct ModF {
  float scale, slope, cap;
  __device__ __forceinline__ float operator()(float acc, int row, int col, float& dmod) const {
    const float s = acc * scale;
    dmod = 1.f;
    if constexpr (MOD == MOD_ALIBI) {
      const int d = row - col;
      return s - slope * static_cast<float>(d < 0 ? -d : d);
    } else if constexpr (MOD == MOD_SOFTCAP) {
      const float t = tanhf(s / cap);
      dmod = 1.f - t * t;
      return cap * t;
    } else {
      return s;
    }
  }
  __device__ __forceinline__ float operator()(float acc, int row, int col) const {
    float dmod;
    return (*this)(acc, row, col, dmod);
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

// The A fragment of one k-step, rows r and r + 8 of a tile (r = g mod 8),
// at p = the row's k-step columns 2t, 2t + 1 (logical k t and t + 4), split
// into tf32 hi and lo.
template <int LD>
__device__ __forceinline__ void frag_rows(const float* p, uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD);
  wg::split_tf32(x0.x, h[0], l[0]);
  wg::split_tf32(x1.x, h[1], l[1]);
  wg::split_tf32(x0.y, h[2], l[2]);
  wg::split_tf32(x1.y, h[3], l[3]);
}

// A B fragment read as a float2 (logical k t and t + 4), split.
__device__ __forceinline__ void frag_pair(const float* p, uint32_t (&h)[2], uint32_t (&l)[2]) {
  const float2 y = *reinterpret_cast<const float2*>(p);
  wg::split_tf32(y.x, h[0], l[0]);
  wg::split_tf32(y.y, h[1], l[1]);
}

// An accumulator tile as the A operand of the next product (the k
// pairing: its columns 2t and 2t + 1 are logical k t and t + 4), split.
__device__ __forceinline__ void frag_acc(const float (&c)[4], uint32_t (&h)[4],
                                         uint32_t (&l)[4]) {
  wg::split_tf32(c[0], h[0], l[0]);
  wg::split_tf32(c[2], h[1], l[1]);
  wg::split_tf32(c[1], h[2], l[2]);
  wg::split_tf32(c[3], h[3], l[3]);
}

// acc += the accumulator tile a (the A operand) . the tile rows 8 kk + 2t
// and 8 kk + 2t + 1 (scalars at column g of each n8 tile): dS K, P^T dO
// and dS^T Q. r0 points at row 8 kk + 2t, column g; s0 and s1 are the
// swizzles of rows 2t and 2t + 1 (0 and 0 for the forward's padded V).
template <int ON, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[ON][4], const float (&a)[4],
                                         const float* r0, int s0, int s1) {
  uint32_t ah[4], al[4];
  frag_acc(a, ah, al);
#pragma unroll
  for (int on = 0; on < ON; ++on) {
    uint32_t bh[2], bl[2];
    wg::split_tf32(r0[(on * 8) ^ s0], bh[0], bl[0]);
    wg::split_tf32(r0[LD + ((on * 8) ^ s1)], bh[1], bl[1]);
    mma3(acc[on], ah, al, bh, bl);
  }
}

// Built for one CTA an SM (__launch_bounds__ minimum 1): ptxas then keeps
// the fragments it hoists in up to 255 registers. Without the minimum it
// aimed at more CTAs an SM (105-184 registers) and ran 1.3x slower.
template <int D, int MOD>
__global__ void __launch_bounds__(F32Fwd<D>::NTH, 1)
flash_fwd_f32_kernel(const FlashArgs a) {
  using L = F32Fwd<D>;
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
      uint32_t ah[4], al[4];
      frag_rows<L::LDQ>(qw + kk * 8, ah, al);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        frag_pair(ks + (nt * 8 + g) * L::LDQ + kk * 8 + 2 * t, bh, bl);
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
    for (int kk = 0; kk < NT; ++kk)
      mma_rows<ON, L::LDV>(o, s[kk], vs + (kk * 8 + 2 * t) * L::LDV + g, 0, 0);
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

// ============================ fp32 backward: 3xTF32 (dQ's dP: fp64) mma.sync
// flash_bwd_dq_f32_kernel and flash_bwd_dkv_f32_kernel ("f32"): the fp32
// dQ and dK/dV on the fp32 forward's machinery: mma3 over split_tf32
// operands, a double-buffered cp.async ring (zeros past S), the score mod
// a template parameter (ModF), Mask32 with one full-tile test a tile, the
// k pairing (an accumulator tile is the A operand of the next product with
// no data movement) and __launch_bounds__' minimum of one CTA an SM. A CTA
// of 4 warps owns 64 rows of one (batch, query head), 16 a warp, and walks
// the live tiles of the other axis; everything but the tiles stays in
// registers, in mma.sync's accumulator layout (lane g = lane / 4, t = lane
// % 4 holds rows g and g + 8 of its warp, columns 2t and 2t + 1 of every
// n8 tile).
//   dQ:    64 query rows (Q, dO, lse and delta held) against KV tiles of
//          F32_DQ_BKV_D* rows (K and V through the ring). Per tile:
//          S = Q K^T and dP = dO V^T; P = exp(mod(S) - lse) and
//          dS = P (dP - delta) mod' scale, in place; dQ += dS K.
//          dP alone runs in fp64 on the tensor cores (mma.m16n8k4.f64:
//          exact products of the fp32 operands, fp64 sums), and dP - delta
//          is taken in fp64: where one key holds a row's softmax (a causal
//          row's first key) dS is rounding noise, and 3xTF32's dP (its
//          split and the tensor cores' truncating sums) carried enough of
//          it to miss the fp32 gate against the float64 plain version at
//          the fp32 40m path's shape (limit ratio 1.05; fp32 plain 1.54).
//   dK/dV: 64 KV rows (K and V held) against Q tiles of F32_DKV_BQ_D*
//          rows (Q, dO and their lse and delta through the ring). It
//          computes the transposed tiles directly: S^T = K Q^T and
//          dP^T = V dO^T; P^T and dS^T with lse and delta read per column
//          (query) from shared memory; dV += P^T dO and dK += dS^T Q. dK
//          and dV come back per query head (the caller sums GQA groups):
//          no atomics, bitwise reproducible.
// One tile, two read patterns: K in dQ (Q and dO in dK/dV) is the B
// operand of a product over D (row g, columns 2t and 2t + 1 as a float2)
// and of a product over its rows (rows 2t and 2t + 1, column g, scalars).
// No row padding is conflict-free for both (the 8-byte reads want a row
// stride of 8 mod 16 floats, the scalar ones 4 mod 8), so every tile is
// stored with rows max(D, 32) floats wide and its 16-byte chunks swizzled:
// element (r, c) sits at column c ^ swz8(r), 8 f(r) with f(r) = (r + r / 4)
// mod 4 over r mod 8, which sends rows 0-3 (and 4-7) and rows 0, 2, 4, 6
// (and 1, 3, 5, 7) each to all four 8-float column groups: both patterns
// conflict-free.
// What bounds them on an H100 (fp32 accuracy at 495 / 3 TFLOP/s from the
// tensor cores; 3.35 TB/s): at B 4, H 8, S 1024, D 64, causal, dQ's 6.5
// GFLOP (0.039 ms) against 42 MB (0.013 ms), dK/dV's 8.6 GFLOP (0.052 ms)
// against 51 MB: operations (dQ's dP, a third of its products, at the
// fp64 tensor cores' 67 TFLOP/s). They run at 4.3-8.3x that (PERF.md),
// latency-bound at 8 warps an SM as the forward is, with 229-255 registers
// a thread and spills at D 128 (dK and dV alone hold 128 floats there).
// The grid runs every (batch, head)'s heaviest tile of a causal mask first
// (dQ: the last Q tile; dK/dV: the first KV tile).
constexpr int F32_BWD_NTH = 128;  // 4 warps, 16 rows each
constexpr int F32_DQ_BQ = 64;     // dQ: query rows per CTA
constexpr int F32_DKV_BKV = 64;   // dK/dV: KV rows per CTA
// Rows of a streamed tile by head dim (dQ: KV rows; dK/dV: query rows), as
// timed on an H100 (PERF.md): 32 at D 64 and 128 ran 3-17% under 64 (D 64,
// where S and dP or S^T and dP^T take 64 floats a thread and dK/dV
// spilled 256 bytes) and 16 (D 128, where 16 rows keep shared memory at 96
// KB for two CTAs an SM; 32 take 128 KB and one), and 16 at D 64 or 64
// for dQ at D 128 ran 5-31% slower. At D 128 dK and dV alone hold 128
// floats a thread.
constexpr int F32_DQ_BKV_D16 = 64;
constexpr int F32_DQ_BKV_D32 = 64;
constexpr int F32_DQ_BKV_D64 = 32;
constexpr int F32_DQ_BKV_D128 = 32;
constexpr int F32_DKV_BQ_D16 = 64;
constexpr int F32_DKV_BQ_D32 = 64;
constexpr int F32_DKV_BQ_D64 = 32;
constexpr int F32_DKV_BQ_D128 = 32;

template <int D>
struct F32Dq {
  static constexpr int BKV = by_d<D>(F32_DQ_BKV_D16, F32_DQ_BKV_D32, F32_DQ_BKV_D64,
                                     F32_DQ_BKV_D128);
  static constexpr int LD = D < 32 ? 32 : D;   // floats a tile row
  static constexpr int OWN = F32_DQ_BQ * LD;   // Q or dO
  static constexpr int TILE = BKV * LD;        // K or V of a stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = (2 * OWN + 2 * STAGE) * 4;
};

template <int D>
struct F32Dkv {
  static constexpr int BQ = by_d<D>(F32_DKV_BQ_D16, F32_DKV_BQ_D32, F32_DKV_BQ_D64,
                                    F32_DKV_BQ_D128);
  static constexpr int LD = D < 32 ? 32 : D;
  static constexpr int OWN = F32_DKV_BKV * LD;  // K or V
  static constexpr int TILE = BQ * LD;          // Q or dO of a stage
  static constexpr int STAGE = 2 * TILE + 2 * BQ;  // Q, dO, lse, delta
  static constexpr int BYTES = (2 * OWN + 2 * STAGE) * 4;
};

// Column swizzle of tile row r (see the note above): 8 f(r).
__device__ __forceinline__ int swz8(int r) { return 8 * (((r & 7) + ((r >> 2) & 1)) & 3); }

// Rows [row0, row0 + rows) of an [S, D] fp32 slab into a swizzled tile of
// LD-float rows, 16 bytes a copy; rows past S are zero.
template <int D, int LD>
__device__ __forceinline__ void f32_tile(float* dst, const float* src, int64_t stride,
                                         int64_t row0, int rows, int S, int tid) {
  for (int i = tid; i < rows * (D / 4); i += F32_BWD_NTH) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool in = row0 + r < S;
    wg::cp_async<16>(dst + r * LD + (c ^ swz8(r)), in ? src + (row0 + r) * stride + c : src,
                     in);
  }
}

// d += a . b for one m16n8k4 step in fp64: a0 and a1 at rows g and g + 8,
// column t of A; b at row t, column g of B; d in the f32 m16n8 accumulator
// layout (rows g and g + 8, columns 2t and 2t + 1).
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <int D, int MOD>
__global__ void __launch_bounds__(F32_BWD_NTH, 1)
flash_bwd_dq_f32_kernel(const FlashArgs a) {
  using L = F32Dq<D>;
  constexpr int BKV = L::BKV, LD = L::LD;
  constexpr int NT = BKV / 8;  // n8 tiles of a warp's S and dP; k8 steps of dS K
  constexpr int ON = D / 8;    // n8 tiles of dQ
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* dos = qs + L::OWN;
  float* ring = dos + L::OWN;

  const int h = static_cast<int>(blockIdx.x % a.Hq), b = static_cast<int>(blockIdx.x / a.Hq);
  const int qt = static_cast<int>(a.nq) - 1 - static_cast<int>(blockIdx.y);
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int S = static_cast<int>(a.S), q0 = qt * F32_DQ_BQ;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const ModF<MOD> mod{static_cast<float>(a.scale),
                      MOD == MOD_ALIBI ? alibi_slope(h, a.score_arg) : 0.f,
                      static_cast<float>(a.score_arg)};
  const Mask32 mask = mask32(a);
  const float scale = static_cast<float>(a.scale);

  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const int lo = a.ranges[2 * qt], n = a.ranges[2 * qt + 1] - lo;
  const auto load_kv = [&](int it) {  // K and V of the iteration-it tile into its stage
    float* ks = ring + (it & 1) * L::STAGE;
    const int64_t k0 = static_cast<int64_t>(lo + it) * BKV;
    f32_tile<D, LD>(ks, kg, a.sk[2], k0, BKV, S, tid);
    f32_tile<D, LD>(ks + L::TILE, vg, a.sv[2], k0, BKV, S, tid);
  };
  f32_tile<D, LD>(qs, qg, a.sq[2], q0, F32_DQ_BQ, S, tid);
  f32_tile<D, LD>(dos, dog, a.sdo[2], q0, F32_DQ_BQ, S, tid);
  if (n > 0) load_kv(0);
  wg::cp_async_commit();

  const int row_a = q0 + 16 * warp + g;  // this thread's rows: row_a, row_a + 8
  const int64_t stat0 = (static_cast<int64_t>(b) * a.Hq + h) * S;
  float lse[2];
  double dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse[r] = row < S ? a.lse_in[stat0 + row] : 0.f;
    dlt[r] = row < S ? a.delta[stat0 + row] : 0.f;
  }
  const int sg = swz8(g), s0 = swz8(2 * t), s1 = swz8(2 * t + 1);
  const float* qw = qs + (16 * warp + g) * LD + 2 * t;
  const float* ow = dos + (16 * warp + g) * LD + 2 * t;
  float dq[ON][4];
#pragma unroll
  for (int i = 0; i < ON; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_kv(it + 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile's copies (this thread's) have landed
    __syncthreads();         // ... everyone's
    const float* ks = ring + (it & 1) * L::STAGE;
    const float* vs = ks + L::TILE;
    const int j = lo + it;

    // S = Q K^T: step kk pairs logical k t, t + 4 with columns 8 kk + 2t,
    // 8 kk + 2t + 1 of both operands, as the forward's S (two k-steps
    // unrolled at a time: one at a time ran 1-3% slower). dP = dO V^T in
    // fp64 over the same reads: columns 8 kk + 2t and 8 kk + 2t + 1 are
    // logical k t of two k4 steps.
    float s[NT][4];
    double dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f, dp[i][e] = 0.0;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = (8 * kk) ^ sg;
      uint32_t qh[4], ql[4];
      frag_rows<LD>(qw + c, qh, ql);
      const float2 o0 = *reinterpret_cast<const float2*>(ow + c);
      const float2 o1 = *reinterpret_cast<const float2*>(ow + 8 * LD + c);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        frag_pair(ks + (nt * 8 + g) * LD + 2 * t + c, bh, bl);
        mma3(s[nt], qh, ql, bh, bl);
        const float2 y = *reinterpret_cast<const float2*>(vs + (nt * 8 + g) * LD + 2 * t + c);
        mma_f64(dp[nt], o0.x, o1.x, y.x);
        mma_f64(dp[nt], o0.y, o1.y, y.y);
      }
    }

    // dS = P (dP - delta) mod' scale in place of S, P = exp(mod(S) - lse).
    // A tile flagged full takes no mask and lies inside S.
    const int k0 = j * BKV + 2 * t;
    const auto ds_pass = [&](auto full_tile) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = row_a + 8 * r, col = k0 + nt * 8 + (e & 1);
          float dmod;
          float x = mod(s[nt][e], row, col, dmod), p;
          if constexpr (decltype(full_tile)::value) {
            p = expf(x - lse[r]);
          } else {
            x = mask.allowed(row, col) ? x : NEG_INF;
            p = (row < S) & (col < S) ? expf(x - lse[r]) : 0.f;
          }
          float ds = p * static_cast<float>(dp[nt][e] - dlt[r]);
          if constexpr (MOD == MOD_SOFTCAP) ds *= dmod;
          s[nt][e] = ds * scale;
        }
    };
    if (a.full[static_cast<int64_t>(qt) * a.nk + j] != 0)
      ds_pass(std::true_type{});
    else
      ds_pass(std::false_type{});

    // dQ += dS K: step kk pairs logical k t, t + 4 with keys 8 kk + 2t,
    // 8 kk + 2t + 1, where dS's accumulator holds them
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
      mma_rows<ON, LD>(dq, s[kk], ks + (kk * 8 + 2 * t) * LD + g, s0, s1);
    __syncthreads();  // every warp is done with this stage: the next load may refill it
  }
  wg::cp_async_wait<0>();

  float* dqg = static_cast<float*>(a.out0) + b * a.s0[0] + h * a.s0[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* dst = dqg + row * a.s0[2] + 2 * t;
#pragma unroll
    for (int on = 0; on < ON; ++on)
      *reinterpret_cast<float2*>(dst + on * 8) = make_float2(dq[on][2 * r], dq[on][2 * r + 1]);
  }
}

template <int D, int MOD>
__global__ void __launch_bounds__(F32_BWD_NTH, 1)
flash_bwd_dkv_f32_kernel(const FlashArgs a) {
  using L = F32Dkv<D>;
  constexpr int BQ = L::BQ, LD = L::LD;
  constexpr int NT = BQ / 8;  // n8 tiles of a warp's S^T and dP^T; k8 steps of P^T dO, dS^T Q
  constexpr int ON = D / 8;   // n8 tiles of dK and dV
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + L::OWN;
  float* ring = vs + L::OWN;

  const int h = static_cast<int>(blockIdx.x % a.Hq), b = static_cast<int>(blockIdx.x / a.Hq);
  const int kt = static_cast<int>(blockIdx.y);
  const int hk = h / static_cast<int>(a.Hq / a.Hkv);
  const int S = static_cast<int>(a.S), k0 = kt * F32_DKV_BKV;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const ModF<MOD> mod{static_cast<float>(a.scale),
                      MOD == MOD_ALIBI ? alibi_slope(h, a.score_arg) : 0.f,
                      static_cast<float>(a.score_arg)};
  const Mask32 mask = mask32(a);
  const float scale = static_cast<float>(a.scale);

  const float* qg = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  const int64_t stat0 = (static_cast<int64_t>(b) * a.Hq + h) * S;
  const int lo = a.ranges[2 * kt], n = a.ranges[2 * kt + 1] - lo;
  // Q, dO, lse and delta of the iteration-it tile into its stage
  const auto load_q = [&](int it) {
    float* qs = ring + (it & 1) * L::STAGE;
    const int q0 = (lo + it) * BQ;
    f32_tile<D, LD>(qs, qg, a.sq[2], q0, BQ, S, tid);
    f32_tile<D, LD>(qs + L::TILE, dog, a.sdo[2], q0, BQ, S, tid);
    float* stats = qs + 2 * L::TILE;
    for (int i = tid; i < 2 * BQ; i += F32_BWD_NTH) {
      const int r = i % BQ;
      const bool in = q0 + r < S;
      const float* src = (i < BQ ? a.lse_in : a.delta) + stat0 + q0 + r;
      wg::cp_async<4>(stats + i, in ? src : a.lse_in, in);
    }
  };
  f32_tile<D, LD>(ks, kg, a.sk[2], k0, F32_DKV_BKV, S, tid);
  f32_tile<D, LD>(vs, vg, a.sv[2], k0, F32_DKV_BKV, S, tid);
  if (n > 0) load_q(0);
  wg::cp_async_commit();

  const int key_a = k0 + 16 * warp + g;  // this thread's keys: key_a, key_a + 8
  const int sg = swz8(g), s0 = swz8(2 * t), s1 = swz8(2 * t + 1);
  const float* kw = ks + (16 * warp + g) * LD + 2 * t;
  const float* vw = vs + (16 * warp + g) * LD + 2 * t;
  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int i = 0; i < ON; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_q(it + 1);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    __syncthreads();
    const float* qs = ring + (it & 1) * L::STAGE;
    const float* os = qs + L::TILE;
    const float* lses = os + L::TILE;
    const float* dels = lses + BQ;
    const int j = lo + it;

    // S^T = K Q^T and dP^T = V dO^T: K and V are the A operands, Q and dO
    // read as the forward reads K (one k-step at a time: unrolled two at a
    // time, as in the forward and dQ, the hoisted fragments spilled more and
    // the kernel ran up to 14% slower, at D 128)
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = (8 * kk) ^ sg;
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_rows<LD>(kw + c, kh, kl);
      frag_rows<LD>(vw + c, vh, vl);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        frag_pair(qs + (nt * 8 + g) * LD + 2 * t + c, bh, bl);
        mma3(st[nt], kh, kl, bh, bl);
        frag_pair(os + (nt * 8 + g) * LD + 2 * t + c, bh, bl);
        mma3(dpt[nt], vh, vl, bh, bl);
      }
    }

    // P^T in place of S^T and dS^T in place of dP^T; the query of a column
    // is the row of the mask and the mod, its lse and delta come from the
    // stage. A tile flagged full takes no mask and lies inside S.
    const int qc = j * BQ + 2 * t;
    const auto p_pass = [&](auto full_tile) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 ls = *reinterpret_cast<const float2*>(lses + nt * 8 + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dels + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_a + 8 * (e >> 1), query = qc + nt * 8 + (e & 1);
          const float l = (e & 1) ? ls.y : ls.x, d = (e & 1) ? dl.y : dl.x;
          float dmod;
          float x = mod(st[nt][e], query, key, dmod), p;
          if constexpr (decltype(full_tile)::value) {
            p = expf(x - l);
          } else {
            x = mask.allowed(query, key) ? x : NEG_INF;
            p = (query < S) & (key < S) ? expf(x - l) : 0.f;
          }
          float ds = p * (dpt[nt][e] - d);
          if constexpr (MOD == MOD_SOFTCAP) ds *= dmod;
          st[nt][e] = p;
          dpt[nt][e] = ds * scale;
        }
      }
    };
    if (a.full[static_cast<int64_t>(j) * a.nk + kt] != 0)
      p_pass(std::true_type{});
    else
      p_pass(std::false_type{});

    // dV += P^T dO and dK += dS^T Q: step kk pairs logical k t, t + 4 with
    // queries 8 kk + 2t, 8 kk + 2t + 1, where the accumulators hold them
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int row = (kk * 8 + 2 * t) * LD + g;
      mma_rows<ON, LD>(dv, st[kk], os + row, s0, s1);
      mma_rows<ON, LD>(dk, dpt[kk], qs + row, s0, s1);
    }
    __syncthreads();  // every warp is done with this stage: the next load may refill it
  }
  wg::cp_async_wait<0>();

  float* dkg = static_cast<float*>(a.out0) + b * a.s0[0] + h * a.s0[1];
  float* dvg = static_cast<float*>(a.out1) + b * a.s1[0] + h * a.s1[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= S) continue;
    float* dk_row = dkg + key * a.s0[2] + 2 * t;
    float* dv_row = dvg + key * a.s1[2] + 2 * t;
#pragma unroll
    for (int on = 0; on < ON; ++on) {
      *reinterpret_cast<float2*>(dk_row + on * 8) = make_float2(dk[on][2 * r], dk[on][2 * r + 1]);
      *reinterpret_cast<float2*>(dv_row + on * 8) = make_float2(dv[on][2 * r], dv[on][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ launchers
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

// The fp32 dQ and dK/dV: grid (B x Hq, tiles), so every (batch, head)'s
// heaviest causal tile comes first; a plan at other tile sizes is refused.
template <int D, int MOD>
int launch_dq_f32(const FlashArgs* a, cudaStream_t stream) {
  using L = F32Dq<D>;
  if (a->nq != cdiv(a->S, F32_DQ_BQ) || a->nk != cdiv(a->S, L::BKV) || a->S >= (1ll << 31) ||
      a->nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_dq_f32_kernel<D, MOD>;
  static std::atomic<unsigned long long> ready{0};
  const int err = wg::allow_smem(ready, kernel, L::BYTES);
  if (err != 0) return err;
  kernel<<<dim3(static_cast<unsigned>(a->B * a->Hq), static_cast<unsigned>(a->nq)),
           F32_BWD_NTH, L::BYTES, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MOD>
int launch_dkv_f32(const FlashArgs* a, cudaStream_t stream) {
  using L = F32Dkv<D>;
  if (a->nq != cdiv(a->S, L::BQ) || a->nk != cdiv(a->S, F32_DKV_BKV) || a->S >= (1ll << 31) ||
      a->nk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_bwd_dkv_f32_kernel<D, MOD>;
  static std::atomic<unsigned long long> ready{0};
  const int err = wg::allow_smem(ready, kernel, L::BYTES);
  if (err != 0) return err;
  kernel<<<dim3(static_cast<unsigned>(a->B * a->Hq), static_cast<unsigned>(a->nk)),
           F32_BWD_NTH, L::BYTES, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the three 3xTF32 kernels, the score mod a template parameter.
template <int D, int MOD>
int launch_f32_mod(const FlashArgs* a, Which which, cudaStream_t s) {
  if (which == FWD) return launch_fwd_f32<D, MOD>(a, s);
  return which == DQ ? launch_dq_f32<D, MOD>(a, s) : launch_dkv_f32<D, MOD>(a, s);
}

template <int D>
int launch_f32(const FlashArgs* a, Which which, cudaStream_t s) {
  if (a->score_mod == MOD_ALIBI) return launch_f32_mod<D, MOD_ALIBI>(a, which, s);
  if (a->score_mod == MOD_SOFTCAP) return launch_f32_mod<D, MOD_SOFTCAP>(a, which, s);
  return launch_f32_mod<D, MOD_NONE>(a, which, s);
}

int dispatch(const FlashArgs* a, Which which, int variant, int head_dim, void* stream) {
  if (variant != F32 || !args_ok(a, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_f32<16>(a, which, s);
    case 32: return launch_f32<32>(a, which, s);
    case 64: return launch_f32<64>(a, which, s);
    default: return launch_f32<128>(a, which, s);
  }
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
