// What the attention and decode-chain kernels share: the warp sums in the
// order of kernels/common.py:lane_sum, the attention core of one query
// row, and the dispatch over the four LUT layouts.
//
// The attention core is the port of the body of
// repro/kernels/approx_attention.py:_attn_kernel for one query row: a LUT
// score GEMM, the 1/sqrt(dh) scale, the position mask, the whole-row
// softmax and a LUT value GEMM.  One warp takes one row (b, s, h): lane l
// scores keys l, l + 32, ..., each folding its dh products in order from
// +0.0, into a global-memory scratch row of T floats; the row max and the
// denominator are warp butterflies; then each lane folds the T products
// p_t * v[t, d] for its dims d = l, l + 32, ... in key order from +0.0.
// Masked keys are never scored (their score is NEG_INF either way) and
// keys whose probability is exactly zero are skipped in the value pass
// (amsim(+0, v) = +-0 never changes a sum that started at +0.0), so the
// work scales with the live keys.  No float expression here may be
// contracted into an FMA: the plain versions round each step.
#pragma once

#include "amsim.cuh"

namespace amsim {

constexpr float kNegInf = -1e30f;    // kernels/common.py NEG_INF
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDhRegs = 8;        // head dims up to 256: 8 outputs a lane

// Butterfly over the warp: lane l adds lane l ^ 16, l ^ 8, ..., l ^ 1.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Grouped-query attention operands: q (B,S,H,dh), k/v (B,T,KV,dh),
// q_pos (S,), k_pos (T,) (negative = unwritten slot), all contiguous.
struct Attn {
  const float* q;
  const float* k;
  const float* v;
  const int* q_pos;
  const int* k_pos;
  int B, S, H, KV, T, dh, causal, window;
};

// Query row `row` = (b*S + s)*H + h into out[0, dh).  All 32 lanes of the
// warp call it together.  qrow: dh floats of shared memory; scores: T
// floats of global memory, both the warp's own.
template <typename LutT, bool kSmem>
__device__ void attend_row(const Attn& a, int row, const LutT* lut, int M, float* qrow,
                           float* scores, float* out) {
  const int lane = threadIdx.x & 31;
  const int h = row % a.H;
  const int s = (row / a.H) % a.S;
  const int b = row / (a.H * a.S);
  const int kvh = h / (a.H / a.KV);
  const int dh = a.dh;
  for (int d = lane; d < dh; d += 32) qrow[d] = a.q[static_cast<size_t>(row) * dh + d];
  __syncwarp();

  const int qp = a.q_pos[s];
  const float scale = sqrtf(static_cast<float>(dh));
  const size_t t_stride = static_cast<size_t>(a.KV) * dh;
  const float* kbase = a.k + (static_cast<size_t>(b) * a.T * a.KV + kvh) * dh;
  const float* vbase = a.v + (static_cast<size_t>(b) * a.T * a.KV + kvh) * dh;

  // Scores; masked keys hold NEG_INF.
  float mx = -__int_as_float(0x7f800000);
  for (int t = lane; t < a.T; t += 32) {
    const int kp = a.k_pos[t];
    const bool valid = kp >= 0 && (!a.causal || kp <= qp) && (!a.window || kp > qp - a.window);
    float sc = kNegInf;
    if (valid) {
      const float* kr = kbase + t * t_stride;
      float acc = 0.0f;
      for (int d = 0; d < dh; ++d) {
        acc = acc + mul<LutT, kSmem>(__float_as_uint(qrow[d]), __float_as_uint(kr[d]), lut, M);
      }
      sc = __fdiv_rn(acc, scale);
    }
    scores[t] = sc;
    mx = fmaxf(mx, sc);
  }
  mx = warp_max(mx);

  // exp(s - max) and the denominator in lane_sum order.
  float sum = 0.0f;
  for (int t = lane; t < a.T; t += 32) {
    const float e = expf(__fsub_rn(scores[t], mx));
    scores[t] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  __syncwarp();

  // Values: p_t = e_t / sum, folded in key order.
  float acc[kMaxDhRegs];
#pragma unroll
  for (int i = 0; i < kMaxDhRegs; ++i) acc[i] = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    const float p = __fdiv_rn(scores[t], sum);
    if (p == 0.0f) continue;
    const uint32_t up = __float_as_uint(p);
    const float* vr = vbase + t * t_stride;
#pragma unroll
    for (int i = 0; i < kMaxDhRegs; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc[i] = acc[i] + mul<LutT, kSmem>(up, __float_as_uint(vr[d]), lut, M);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxDhRegs; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) out[d] = acc[i];
  }
  __syncwarp();  // qrow and scores are reused by the warp's next row
}

// Every query row of `a`, the warps of the grid striding over them; only
// the first `scratch_warps` warps take part (the scratch has a row of T
// floats for each).  qrows: kWarps * dh floats of shared memory; out: a
// (B*S*H, dh) row-major array.
template <typename LutT, bool kSmem>
__device__ void attention_rows(const Attn& a, const LutT* lut, int M, float* qrows,
                               float* scratch, int scratch_warps, float* out) {
  const int warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = min(static_cast<int>(gridDim.x) * kWarps, scratch_warps);
  if (gwarp >= nwarps) return;
  float* qrow = qrows + warp * a.dh;
  float* scores = scratch + static_cast<size_t>(gwarp) * a.T;
  const int rows = a.B * a.S * a.H;
  for (int row = gwarp; row < rows; row += nwarps) {
    attend_row<LutT, kSmem>(a, row, lut, M, qrow, scores, out + static_cast<size_t>(row) * a.dh);
  }
}

template <typename LutT, bool kSmem>
struct LutKind {
  using T = LutT;
  static constexpr bool smem = kSmem;
};

// Calls f(LutKind<...>{}) for the table layout: uint16 entries when
// `packed`, read from shared memory when `smem_lut`.
template <typename F>
cudaError_t with_lut(int packed, int smem_lut, F&& f) {
  if (packed) {
    return smem_lut ? f(LutKind<uint16_t, true>{}) : f(LutKind<uint16_t, false>{});
  }
  return smem_lut ? f(LutKind<uint32_t, true>{}) : f(LutKind<uint32_t, false>{});
}

// Bytes rounded up to a multiple of 16, for carving shared memory.
__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

}  // namespace amsim
