// Shared by the two flash sources, each built into its own library so that
// their nvcc runs in parallel: flash_attention.cu (the bf16 "wgmma"
// kernels, and the note on what all of them compute) and
// flash_attention_f32.cu (the fp32 "f32" kernels). The ctypes-mirrored
// FlashArgs, the mask and score-mod codes, the masks as one predicate, the
// checks every C entry makes, and the helpers both families use.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // large-but-finite, as ops/masks.py

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

template <int D>
constexpr int by_d(int d16, int d32, int d64, int d128) {
  return D == 16 ? d16 : D == 32 ? d32 : D == 64 ? d64 : d128;
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

// The three functions, as the C entries name them.
enum Which { FWD = 0, DQ = 1, DKV = 2 };
int64_t cdiv(int64_t x, int64_t y) { return (x + y - 1) / y; }

// Kernel variants (the wrapper's flash_variant codes): 0 = "f32", the
// library of flash_attention_f32.cu; 2 = "wgmma", flash_attention.cu's (its
// operands must meet TMA's rules). Each library refuses every other code
// (1 was the bf16 WMMA kernels, 3 the bf16 SIMT ones: removed). Each plan
// must be at its kernel's tile sizes.
enum Variant { F32 = 0, WGMMA = 2 };

// What every C entry refuses before any launch: a non-positive shape, query
// heads not a multiple of KV heads, an unknown mask or score-mod code, a
// mod without its positive argument, a head dim other than 16, 32, 64, 128.
bool args_ok(const FlashArgs* a, int head_dim) {
  return a->B > 0 && a->Hq > 0 && a->Hkv > 0 && a->S > 0 && a->Hq % a->Hkv == 0 &&
         a->mask_type >= MASK_FULL && a->mask_type <= MASK_BAND &&
         a->score_mod >= MOD_NONE && a->score_mod <= MOD_SOFTCAP &&
         (a->score_mod == MOD_NONE || a->score_arg > 0.0) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64 || head_dim == 128);
}

}  // namespace
